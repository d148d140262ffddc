"""``ServeClient``: the Python client of the serving daemon, the port's own
copy of ``cmhse_tpu/client.py`` (the wire protocol is the same, so either
client drives either daemon).

Machine clients otherwise hand-roll the JSON-lines protocol
(``cli/serve_daemon.py`` module docstring); this wraps it in typed
methods with error handling. Pure stdlib: importing it loads no torch
(``cmhse_tpu_torch/__init__`` imports only the stdlib-only config), so a
lightweight client process starts fast and touches no card.

    from cmhse_tpu_torch.client import ServeClient

    with ServeClient(tcp=("10.0.0.5", 7700)) as c:   # or socket_path=...
        hits = c.query("a dog catches a frisbee", k=5)
        c.add("fresh_batch", data_path="/data/anet")  # live ingest
        c.remove(["v_abc123"])
        print(c.stats()["latency_ms_p99"])

One request at a time per client (the protocol is strictly
request->reply per connection); share one daemon across many clients for
concurrency — the daemon is thread-per-connection.
"""

from __future__ import annotations

import json
import socket


class ServeError(RuntimeError):
    """The daemon answered ``{"error": ...}`` for a request."""


class ServeClient:
    """Blocking JSON-lines client; context-manager closes the connection.

    Exactly one of ``socket_path`` (AF_UNIX) / ``tcp=(host, port)``.
    ``timeout`` bounds every request's round-trip (None = wait forever;
    a cold daemon's first video query builds the whole text-side gallery
    unless it was started with ``--warm``).
    ``token``: attached to every request, for daemons started with
    ``--auth_token``."""

    def __init__(self, socket_path: str | None = None,
                 tcp: tuple[str, int] | None = None,
                 timeout: float | None = None,
                 token: str | None = None):
        if (socket_path is None) == (tcp is None):
            raise ValueError("pass exactly one of socket_path / tcp")
        self._token = token
        self._socket_path, self._tcp, self._timeout = socket_path, tcp, timeout
        self._sock = self._file = None
        self._connect()

    def _connect(self) -> None:
        if self._socket_path is not None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(self._timeout)
            self._sock.connect(self._socket_path)
        else:
            self._sock = socket.create_connection(self._tcp,
                                                  timeout=self._timeout)
        self._file = self._sock.makefile("rwb")

    def _poison(self) -> None:
        """Drop a connection whose request/reply stream can no longer be
        trusted; the next request() reconnects fresh."""
        try:
            if self._file is not None:
                self._file.close()
        except OSError:
            pass
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = self._file = None

    # -- low-level ---------------------------------------------------------

    def request(self, req: dict) -> dict:
        """Send one raw request object, return the raw reply; raises
        :class:`ServeError` on an error reply and ``ConnectionError`` if
        the daemon hung up.

        The protocol has no reply-to-request correlation on the wire, so
        any IO failure mid-exchange (timeout, hangup, torn line) POISONS
        the connection: it is closed and the next request reconnects.
        Without this, a timed-out request's LATE reply would be read as
        the answer to the next request and every call after it would be
        off by one reply, silently."""
        if self._token is not None and "token" not in req:
            req = {**req, "token": self._token}
        if self._file is None:
            self._connect()
        try:
            self._file.write(json.dumps(req).encode() + b"\n")
            self._file.flush()
            line = self._file.readline()
            if not line:
                raise ConnectionError("daemon closed the connection")
            resp = json.loads(line)
        except Exception:
            self._poison()
            raise
        if isinstance(resp, dict) and "error" in resp:
            raise ServeError(resp["error"])
        return resp

    # -- queries -----------------------------------------------------------

    def query(self, text: str | list, k: int = 5) -> list:
        """Text->video retrieval. A single string returns one hit list
        ``[{"key", "score"}, ...]``; a LIST of strings batches the GEMM
        and returns one hit list per query string."""
        return self.request({"query": text, "k": k})["results"]

    def query_video(self, video_key: str, k: int = 5) -> list:
        """Video->paragraph retrieval by gallery/ingested video key."""
        return self.request({"video_key": video_key, "k": k})["results"]

    # -- gallery lifecycle ---------------------------------------------------

    def add(self, split: str, data_path: str | None = None) -> dict:
        """Live-ingest a reference-layout split (encode + append to both
        directions); returns the daemon's summary (added/valid_rows/...)."""
        req: dict = {"op": "add", "split": split}
        if data_path is not None:
            req["data_path"] = data_path
        return self.request(req)

    def remove(self, keys: list) -> int:
        """Tombstone videos by key in both directions; returns the number
        of rows actually removed (unknown keys are ignored)."""
        return self.request({"op": "remove", "keys": list(keys)})["removed"]

    def compact(self) -> dict:
        """Force a gallery compaction (reclaim tombstoned rows) in both
        directions; returns {"compacted": rows_reclaimed, ...}. The daemon
        also auto-compacts after removes per its --compact_threshold."""
        return self.request({"op": "compact"})

    # -- admin ---------------------------------------------------------------

    def stats(self) -> dict:
        return self.request({"op": "stats"})

    def shutdown(self) -> None:
        """Stop the daemon (it acknowledges, then exits)."""
        self.request({"op": "shutdown"})

    def close(self) -> None:
        self._poison()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
