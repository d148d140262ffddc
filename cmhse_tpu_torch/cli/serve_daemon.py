"""``python -m cmhse_tpu_torch.cli.serve_daemon``, counterpart of
``cmhse-serve``: a long-running retrieval daemon on a unix socket or TCP.

It encodes the gallery once at start-up (held prepared, int8 with
``--quantized``, at the JAX package's sizes), then answers JSON-line
requests from clients over ``--socket PATH`` (AF_UNIX) or ``--tcp
HOST:PORT``. The protocol and the replies' keys are the JAX daemon's, so
``cmhse_tpu_torch.client.ServeClient`` and the JAX package's client both
drive it:

    -> {"query": "a dog catches a frisbee", "k": 5, "id": 1}
    <- {"id": 1, "results": [{"key": "...", "score": 0.93}, ...],
        "latency_ms": 2.1}
    -> {"video_key": "v_abc123", "k": 3}          # video->paragraph
    <- {"results": [...], ...}
    -> {"op": "add", "split": "new_batch"}        # encode and append a
    <- {"added": 120, "valid_rows": 5037, ...}    #   reference-layout split
    -> {"op": "remove", "keys": ["v_abc123"]}     # tombstone items
    <- {"removed": 1, "valid_rows": 4916}
    -> {"op": "compact"}                           # reclaim tombstoned rows
    -> {"op": "stats"}
    <- {"gallery_rows": 4917, "prepared": true, "quantized": false, ...}
    -> {"op": "shutdown"}
    <- {"ok": true}                                # then the daemon exits

Errors come back as {"id": ..., "error": "..."}; the connection stays up.
A connection's requests are answered in its own order; across
connections, handling is serialized through one lock, in an order the
scheduler picks, so order-dependent requests (an add, then queries that
expect it) belong on one connection. A "query" list batches the product.

Two phases run outside that lock: an add's encode (queries on other
connections meanwhile see the old gallery; the commit is atomic under the
lock) and a compaction's rebuild (explicit, or a remove's auto-compaction
past ``--compact_threshold``; queries go on against the tombstoned old
forms, and the swap is atomic). Adds and compactions serialize on a
second, ingest lock. Every thread launches its kernels on the same
(default) CUDA stream: the GRU kernel is one cooperative grid, and two of
them must never need the card's SMs at once.

``--sharded`` shards both directions' galleries over every local device
(each visible card, or CPU shards with ``--platform cpu``), from this one
process as the JAX daemon does: a shard's top-k runs on its card and the
candidates merge on the first. Not under ``torchrun``.

Trust: no authentication by default. Serve on a unix socket (file
permissions are the access control) or a loopback or firewalled address;
anyone who reaches the port can query, change the gallery and stop the
daemon. ``--auth_token TOKEN`` makes every request carry {"token": TOKEN}
(a constant-time compare; a refusal has no side effect). An add's
"data_path" must lie under the start-up ``--data_path`` unless the daemon
was started with ``--allow_any_path``.

The JAX daemon's guard on XLA's executable mappings (``_map_count``,
``_maybe_clear_jax_caches``) has no counterpart: PyTorch compiles nothing
a request, and ``stats`` reports ``jax_cache_clears: 0``.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time
from collections import deque

from cmhse_tpu_torch.cli import add_platform_flag, device_for, sharded_mesh

# XLA's compile cache has no counterpart here
JAX_ONLY_FLAGS = ("--compile_cache",)

# largest accepted request line: thousands of batched query sentences fit;
# a runaway (or hostile, on TCP) line cannot balloon the daemon's memory
MAX_LINE_BYTES = 1 << 20


def _nearest_rank(sorted_vals, p: float):
    """Nearest-rank percentile: the ceil(p*n)-th smallest value
    (1-based)."""
    import math

    n = len(sorted_vals)
    return sorted_vals[min(n - 1, max(0, math.ceil(p * n) - 1))]


def _auth_error(req: dict, ctx: dict) -> dict | None:
    """Constant-time token check when the daemon was started with
    ``--auth_token``; None means authorized."""
    token = ctx.get("auth_token")
    if token is None:
        return None
    import hmac

    got = req.get("token")
    # compare utf-8 bytes: compare_digest raises on non-ASCII str, which
    # would turn a wrong token into a crash instead of "unauthorized"
    if isinstance(got, str) and hmac.compare_digest(
            got.encode("utf-8"), token.encode("utf-8")):
        return None
    return {"error": "unauthorized: this daemon requires a valid 'token' "
                     "field on every request (started with --auth_token)"}


def _compact_online(ctx: dict, only_above: float | None = None) -> dict:
    """Online compaction: ``plan_compaction`` runs outside the request lock
    (queries go on against the tombstoned old forms); only
    ``apply_compaction`` holds ``ctx["lock"]``. Serializes with adds and
    other compactions on ``ctx["ingest_lock"]`` (an append would make the
    plan stale; a remove may race it, and apply replays it). Callers must
    not hold the request lock.

    ``only_above``: an auto-compaction's threshold, checked again once the
    ingest lock is held, so removes queued behind a compaction do not each
    rebuild the gallery for their few rows."""
    import numpy as np

    with ctx.setdefault("ingest_lock", threading.Lock()):
        r = ctx["retriever"]
        if only_above is not None and r.invalid_fraction <= only_above:
            return {"compacted": 0,
                    "gallery_rows": int(r.gallery.shape[0]),
                    "valid_rows": r.n_valid,
                    "note": "skipped: a compaction that finished while "
                            "this request waited already reclaimed the "
                            "tombstones"}
        # a text side that a racing video_key request builds after this
        # read stays uncompacted until the next compaction, and is correct
        rt = ctx.get("retriever_text")
        rows_before = int(r.gallery.shape[0])
        plans = [(tr, tr.plan_compaction())
                 for tr in (r, rt) if tr is not None]
        with ctx.setdefault("lock", threading.Lock()):
            for tr, plan in plans:
                if not isinstance(plan, np.ndarray):  # ndarray = identity
                    tr.apply_compaction(plan)
            ctx["compactions"] += 1
            return {"compacted": rows_before - int(r.gallery.shape[0]),
                    "gallery_rows": int(r.gallery.shape[0]),
                    "valid_rows": r.n_valid}


def _stats(ctx: dict) -> dict:
    r = ctx["retriever"]
    lat = sorted(ctx["latencies"])

    def pct(p):
        return round(_nearest_rank(lat, p), 3) if lat else None

    return {
        "gallery_rows": int(r.gallery.shape[0]),
        "valid_rows": r.n_valid,
        "invalid_fraction": round(r.invalid_fraction, 4),
        "compactions": ctx["compactions"],
        "prepared": r._prepared is not None,
        "quantized": r.quantize,
        "side": r.side,
        "split": ctx["split"],
        "requests_served": ctx["served"],
        "jax_cache_clears": 0,
        # over the last len(lat) (<= 1024) query requests
        "latency_ms_p50": pct(0.50),
        "latency_ms_p90": pct(0.90),
        "latency_ms_p99": pct(0.99),
    }


def _text_side(ctx: dict):
    """The video->paragraph Retriever, built at its first use from the
    start-up encode, with the live adds and then the removals replayed
    onto it (a removal may name a row added after start-up). None when the
    context has no start-up encode to build it from."""
    r = ctx.get("retriever_text")
    if r is not None:
        return r
    build = ctx.get("build_text_side")
    if build is None:
        return None
    r = ctx["retriever_text"] = build()
    for encoded, row_ids in ctx["added"]:
        r.add_to_gallery(keys=row_ids, encoded=encoded)
    # both ledgers' copies are consumed: holding them would pin the
    # encoded tuples, and the closure the start-up text encode
    ctx["added"].clear()
    if ctx["removed_ids"]:
        r.remove_from_gallery(ctx["removed_ids"])
    ctx["build_text_side"] = None
    return r


def _handle_request(req: dict, ctx: dict) -> dict:
    """One request -> its reply, with no socket (tests call it directly);
    ``ctx`` holds the Retrievers and datasets built at start-up."""
    if not isinstance(req, dict):
        return {"error": "request must be a JSON object"}
    rid = req.get("id")

    def reply(payload: dict) -> dict:
        return {"id": rid, **payload} if rid is not None else payload

    denied = _auth_error(req, ctx)
    if denied is not None:
        return reply(denied)
    op = req.get("op")
    if op == "shutdown":
        ctx["shutdown"] = True
        return reply({"ok": True})
    if op == "add":
        return reply(_handle_add(req, ctx))
    if op == "compact":
        # the online form: callers must not hold the request lock around
        # mutating ops (see _client_loop)
        return reply(_compact_online(ctx))
    if op == "remove":
        return reply(_handle_remove(req, ctx))
    if op == "stats":
        return reply(_stats(ctx))

    k = int(req.get("k", 5))
    if k < 1:
        return reply({"error": f"k must be >= 1, got {k}"})
    t0 = time.perf_counter()
    if "query" in req:
        texts = req["query"] if isinstance(req["query"], list) \
            else [req["query"]]
        if not texts or not all(isinstance(t, str) and t.strip()
                                for t in texts):
            return reply({"error": "query must be a non-empty string "
                                   "(or non-empty list of them)"})
        r_used = ctx["retriever"]
        scores, idx = _text_retrieve(ctx, texts, k)
    elif "video_key" in req:
        from cmhse_tpu_torch.eval.serve import key_index, video_query_batch

        key = req["video_key"]
        # the start-up split or any split added since: a just-added video
        # is usable as a query too
        src = next((d for d in ctx["datasets"] if key in key_index(d)),
                   None)
        if src is None:
            return reply({"error": f"video key {key!r} not in the "
                                   f"{ctx['split']} split or any "
                                   "live-added split"})
        qframes, qframe_len, qclip_len = video_query_batch(
            src, ctx["cfg"].data, [key])
        r_used = _text_side(ctx)
        if r_used is None:
            return reply({"error": "text side unavailable: this context "
                                   "has no startup encode to build it "
                                   "from"})
        # the k bucket of _text_retrieve
        scores, idx = r_used.retrieve_video(qframes, qframe_len, qclip_len,
                                            k=max(8, _pow2_bucket(k)))
        scores, idx = scores[:, :k], idx[:, :k]
    else:
        return reply({"error": "expected 'query', 'video_key', or 'op'"})

    ms = (time.perf_counter() - t0) * 1e3
    out = _format_rows(ctx, r_used, scores, idx)
    ctx["served"] += 1
    ctx["latencies"].append(ms)
    # a "query" list gets a list of result rows; one query or a video_key
    # gets its row
    batched = isinstance(req.get("query"), list)
    return reply({"results": out if batched else out[0],
                  "latency_ms": round(ms, 3)})


def _handle_remove(req: dict, ctx: dict) -> dict:
    """Tombstone items by name in both directions, then compact online when
    the invalid fraction passes ``compact_threshold``. The remove holds
    ``ctx["lock"]`` (O(removed) work); the compaction runs after it is
    released. Callers must not hold the request lock."""
    keys = req.get("keys")
    if not isinstance(keys, list) or not keys:
        return {"error": "remove needs a non-empty 'keys' list"}
    with ctx.setdefault("lock", threading.Lock()):
        # gallery keys are row ids into the daemon's key table; a name maps
        # to its newest row
        idx = ctx["key_to_row"]
        ids = [idx[k] for k in keys if k in idx]
        # replayed onto a text side built later from the start-up encode
        ctx["removed_ids"].extend(ids)
        # a removed name may be added again
        ctx["removed_keys"].update(k for k in keys if k in idx)
        removed = ctx["retriever"].remove_from_gallery(ids)
        if ctx.get("retriever_text") is not None:
            ctx["retriever_text"].remove_from_gallery(ids)
        out = {"removed": removed, "valid_rows": ctx["retriever"].n_valid}
        thr = ctx.get("compact_threshold")
        needs_compact = (thr is not None and removed
                         and ctx["retriever"].invalid_fraction > thr)
    if needs_compact:
        out["auto_compaction"] = _compact_online(ctx, only_above=thr)
    return out


def _pow2_bucket(n: int) -> int:
    """Next power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def _text_retrieve(ctx: dict, texts: list, k: int):
    """Tokenize, encode and top-k for text queries against the video-side
    gallery: the one compute core of the query op and the batcher.

    The search runs at ``max(8, pow2(k))`` and the extra columns are cut:
    the JAX daemon's k bucket, kept because it sets the int8 pool
    (``rescore_m = max(rescore_m, k)`` and ``m = max(64, 4k)``), so the
    int8 path returns the JAX daemon's rows. The JAX daemon also pads the
    batch to a power of two, for XLA's compile cache only; that padding is
    not kept (each query's row is encoded on its own either way)."""
    from cmhse_tpu_torch.eval.serve import text_query_batch

    cfg = ctx["cfg"]
    scores, idx = ctx["retriever"].retrieve(
        *text_query_batch(ctx["vocab"], texts, cfg.data.max_sentences,
                          cfg.data.max_words),
        k=max(8, _pow2_bucket(k)))
    return scores[:, :k], idx[:, :k]


def _row_key(keys: list, retriever, row: int):
    if retriever.gallery_keys is None:
        return row
    return keys[int(retriever.gallery_keys[row])]


def _format_rows(ctx: dict, retriever, scores, idx) -> list:
    """Score and index rows -> [{"key", "score"}, ...] result rows."""
    return [
        [{"key": _row_key(ctx["keys"], retriever, int(j)),
          "score": round(float(s), 6)}
         for s, j in zip(row_s, row_i)]
        for row_s, row_i in zip(scores, idx)
    ]


class _QueryBatcher:
    """Text queries from different connections merged into one encode and
    top-k (``--batch_window_ms``). The first query to arrive leads the
    window: it sleeps ``window_s`` holding no lock, takes every text query
    that arrived meanwhile, and runs them as one call under the request
    lock; the others wait on an event for their rows. Each query pays up to
    one window of latency so that N small device calls become one.

    Only plain text queries (``{"query": ...}``, no ``op``) are batched.
    Auth, validation, ``k`` and ``id`` hold per request; a bad request
    errors alone."""

    def __init__(self, ctx: dict, window_s: float):
        self.ctx = ctx
        self.window_s = window_s
        self._mutex = threading.Lock()
        self._pending: list[dict] = []

    def submit(self, req: dict) -> dict:
        """Answer one text-query request through the current window; call
        it without the request lock (the leader takes it)."""
        # stamped before the window's wait: batching's cost is that wait,
        # so latency_ms and the stats include it
        item = {"req": req, "done": threading.Event(), "resp": None,
                "t0": time.perf_counter()}
        with self._mutex:
            self._pending.append(item)
            leader = len(self._pending) == 1
        if not leader:
            # a safety valve should the leader die without its finally
            if not item["done"].wait(timeout=max(600.0, 100 * self.window_s)):
                rid = req.get("id")
                err = {"error": "query batch leader never completed"}
                return {"id": rid, **err} if rid is not None else err
            return item["resp"]
        time.sleep(self.window_s)
        with self._mutex:
            batch, self._pending = self._pending, []
        try:
            self._run(batch)
        except Exception as e:  # every window-mate must get an answer
            for it in batch:
                if it["resp"] is None:
                    rid = it["req"].get("id")
                    err = {"error": f"{type(e).__name__}: {e}"}
                    it["resp"] = ({"id": rid, **err} if rid is not None
                                  else err)
        finally:
            for it in batch:
                it["done"].set()
        return item["resp"]

    def _run(self, batch: list) -> None:
        """Check each item, run one merged retrieve for the good ones and
        hand each its rows: the query op's contract (same helpers, reply
        shapes and stats)."""
        live = []  # (item, texts, k, batched, reply)
        for it in batch:
            req = it["req"]
            rid = req.get("id")

            def reply(payload, rid=rid):
                return {"id": rid, **payload} if rid is not None else payload

            denied = _auth_error(req, self.ctx)
            if denied is not None:
                it["resp"] = reply(denied)
                continue
            try:
                k = int(req.get("k", 5))
            except (TypeError, ValueError):
                it["resp"] = reply({"error": "k must be an integer, got "
                                             f"{req.get('k')!r}"})
                continue
            if k < 1:
                it["resp"] = reply({"error": f"k must be >= 1, got {k}"})
                continue
            texts = req["query"] if isinstance(req["query"], list) \
                else [req["query"]]
            if not texts or not all(isinstance(t, str) and t.strip()
                                    for t in texts):
                it["resp"] = reply({"error": "query must be a non-empty "
                                             "string (or non-empty list "
                                             "of them)"})
                continue
            live.append((it, texts, k, isinstance(req.get("query"), list),
                         reply))
        if not live:
            return
        merged = [t for _, texts, _, _, _ in live for t in texts]
        k_max = max(k for _, _, k, _, _ in live)
        with self.ctx["lock"]:
            scores, idx = _text_retrieve(self.ctx, merged, k_max)
            rows = _format_rows(self.ctx, self.ctx["retriever"], scores, idx)
            # each item's latency from its own submit() stamp
            done = time.perf_counter()
            per_ms = [(done - it["t0"]) * 1e3 for it, *_ in live]
            self.ctx["served"] += len(live)
            self.ctx["latencies"].extend(per_ms)
        start = 0
        for (it, texts, k, batched, reply), ms in zip(live, per_ms):
            mine = [row[:k] for row in rows[start:start + len(texts)]]
            start += len(texts)
            it["resp"] = reply({"results": mine if batched else mine[0],
                                "latency_ms": round(ms, 3),
                                "batched_with": len(merged) - len(texts)})


def _dup_keys(new_keys, ctx: dict) -> list:
    """Names already live in the gallery (a removed name is not a
    duplicate: a later split may carry a corrected version of it)."""
    return sorted((set(new_keys) & ctx["key_set"]) - ctx["removed_keys"])


def _handle_add(req: dict, ctx: dict) -> dict:
    """Encode a reference-layout split once and append it to both
    directions' galleries: {"op": "add", "split": ..., "data_path": ...?}.
    The prepared form is extended, not rebuilt (``add_to_gallery``).

    The encode runs outside the request lock, on the caller's thread and
    the default CUDA stream (queries on other connections meanwhile answer
    against the old gallery); the commit holds ``ctx["lock"]``; adds
    serialize on ``ctx["ingest_lock"]``. Callers must not hold the request
    lock. A client's ``data_path`` must lie under the start-up data root
    unless ``allow_any_path``."""
    import os

    from cmhse_tpu_torch.data import PrecompDataset, batches_from_dataset
    from cmhse_tpu_torch.eval.encode import encode_gallery_device

    split = req.get("split")
    if not isinstance(split, str) or not split:
        return {"error": "add needs a 'split' (and optional 'data_path')"}
    cfg = ctx["cfg"]
    path = req.get("data_path") or ctx["data_path"]
    if req.get("data_path") and not ctx.get("allow_any_path"):
        # fail closed: a context without a start-up root has nothing to
        # confine the path to
        if ctx.get("data_path") is None:
            return {"error": "this daemon has no startup data root to "
                             "confine 'data_path' to; build the context "
                             "with a data_path or enable allow_any_path"}
        root = os.path.realpath(ctx["data_path"])
        target = os.path.realpath(path)
        if os.path.commonpath([root, target]) != root:
            return {"error": f"data_path {str(path)!r} is outside the "
                             f"startup data root {ctx['data_path']!r}; "
                             "start the daemon with --allow_any_path to "
                             "serve splits from arbitrary directories"}
    with ctx.setdefault("ingest_lock", threading.Lock()):
        try:
            new_ds = PrecompDataset(path, split, ctx["vocab"],
                                    feat_dim=cfg.data.feat_dim,
                                    flat=not cfg.model.hierarchical)
        except (OSError, KeyError, ValueError) as e:
            return {"error": f"cannot open split {split!r} under {path}: {e}"}
        # advisory check before the encode; checked again at the commit (a
        # remove may change removed_keys meanwhile)
        dup = _dup_keys(new_ds.keys, ctx)
        if dup:
            return {"error": f"{len(dup)} key(s) already in the gallery "
                             f"(e.g. {dup[0]!r}); remove them first or "
                             "rename"}
        r = ctx["retriever"]
        encoded = encode_gallery_device(
            r.model, batches_from_dataset(new_ds, cfg.data, shuffle=False),
            return_ids=True)
        with ctx.setdefault("lock", threading.Lock()):
            dup = _dup_keys(new_ds.keys, ctx)
            if dup:
                return {"error": f"{len(dup)} key(s) already in the "
                                 f"gallery (e.g. {dup[0]!r}); remove them "
                                 "first or rename"}
            base = len(ctx["keys"])
            row_ids = list(range(base, base + len(new_ds)))
            # the key table grows first: a direction whose append fails
            # then misses the rows, and never names a row past the table
            ctx["keys"].extend(new_ds.keys)
            ctx["key_set"].update(new_ds.keys)
            ctx["key_to_row"].update(
                {k: base + i for i, k in enumerate(new_ds.keys)})
            ctx["datasets"].append(new_ds)  # its videos are queryable
            ctx["removed_keys"] -= set(new_ds.keys)
            r.add_to_gallery(keys=row_ids, encoded=encoded)
            if ctx["retriever_text"] is not None:
                ctx["retriever_text"].add_to_gallery(keys=row_ids,
                                                     encoded=encoded)
            else:
                # replayed when the text side is first built
                ctx["added"].append((encoded, row_ids))
            return {"added": len(new_ds), "split": split,
                    "gallery_rows": int(r.gallery.shape[0]),
                    "valid_rows": r.n_valid}


def _bind_unix(sock_path: str) -> socket.socket:
    import os
    import stat

    if os.path.exists(sock_path):
        # only a socket may be unlinked: a regular file or directory given
        # as --socket by mistake stays
        if not stat.S_ISSOCK(os.stat(sock_path).st_mode):
            raise SystemExit(
                f"--socket {sock_path} exists and is not a socket; "
                "refusing to remove it")
        # a live daemon's socket is not taken over; a stale one is removed
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.settimeout(5.0)
        try:
            probe.connect(sock_path)
        except OSError:
            os.unlink(sock_path)
        else:
            raise SystemExit(
                f"a daemon is already serving on {sock_path}; pass a "
                "different --socket or stop it first")
        finally:
            probe.close()
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(sock_path)
    return server


def _bind_tcp(host: str, port: int) -> socket.socket:
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    # a restarted daemon need not wait out TIME_WAIT on its old port
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind((host, port))
    return server


def _access_log(ctx: dict, req, resp: dict) -> None:
    """One JSONL record a wire request, with ``--log_jsonl``."""
    log = ctx.get("logger")
    if log is None:
        return
    if not isinstance(req, dict):
        op = "bad_json"
    elif "query" in req:
        op = "query"
    elif "video_key" in req:
        op = "video_key"
    else:
        op = str(req.get("op", "unknown"))
    fields = {"op": op, "ok": "error" not in resp}
    for k in ("latency_ms", "added", "removed", "valid_rows", "error"):
        if k in resp:
            fields[k] = resp[k]
    log.log("serve_request", **fields)


def _client_loop(conn: socket.socket, ctx: dict) -> None:
    """One client, many requests. Handling is serialized through
    ``ctx["lock"]`` (one card; the ledgers and stats are plain Python
    state), but reads wait outside it, so an idle client blocks no one."""
    try:
        with conn, conn.makefile("rwb") as f:
            while True:
                line = f.readline(MAX_LINE_BYTES + 1)
                if not line:
                    break
                if len(line) > MAX_LINE_BYTES:
                    # reply, then hang up: a cut line cannot be resynced
                    f.write((json.dumps(
                        {"error": f"request line exceeds {MAX_LINE_BYTES} "
                                  "bytes; split it (e.g. several smaller "
                                  "'query' lists)"}) + "\n").encode())
                    f.flush()
                    # drain the line's tail (bounded) before closing:
                    # unread bytes at close make TCP reset the connection
                    # and can destroy the reply in flight
                    drained = 0
                    while (not line.endswith(b"\n")
                           and drained < (64 << 20)):
                        line = f.readline(MAX_LINE_BYTES)
                        if not line:
                            break
                        drained += len(line)
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    req, resp = None, {"error": f"bad JSON: {e}"}
                else:
                    try:
                        if (isinstance(req, dict) and req.get("op")
                                in ("add", "remove", "compact")):
                            # they take the locks themselves: an add's
                            # encode and a compaction's rebuild run
                            # outside the request lock
                            resp = _handle_request(req, ctx)
                        elif (ctx.get("batcher") is not None
                              and isinstance(req, dict) and "op" not in req
                              and "query" in req):
                            resp = ctx["batcher"].submit(req)
                        else:
                            with ctx["lock"]:
                                resp = _handle_request(req, ctx)
                    except Exception as e:  # the daemon outlives requests
                        resp = {"error": f"{type(e).__name__}: {e}"}
                _access_log(ctx, req, resp)
                f.write((json.dumps(resp) + "\n").encode())
                f.flush()
                if ctx["shutdown"]:
                    break
    except OSError as e:
        # a client vanished mid-exchange; the daemon outlives clients too
        print(f"client connection dropped: {e}")


def serve_forever(ctx: dict, sock_path: str | None = None,
                  ready_callback=None,
                  tcp: tuple[str, int] | None = None,
                  server: socket.socket | None = None,
                  max_connections: int | None = None) -> None:
    """Accept loop: one daemon thread a client (see :func:`_client_loop`).
    Listens on a unix socket (``sock_path``) or TCP (``tcp=(host, port)``;
    port 0 picks a free one). The bound address is in
    ``ctx["listening_on"]`` before ``ready_callback`` fires.

    ``server``: a socket already bound to that address (``main`` binds
    before the start-up encode, so a taken address fails at once).
    ``max_connections``: concurrent clients beyond it get one error line
    and a hang-up; None is unlimited."""
    import os

    if (sock_path is None) == (tcp is None):
        raise ValueError("pass exactly one of sock_path / tcp")
    ctx.setdefault("lock", threading.Lock())
    ctx.setdefault("ingest_lock", threading.Lock())
    if server is None:
        server = _bind_unix(sock_path) if sock_path is not None \
            else _bind_tcp(*tcp)
    clients: list[tuple[socket.socket, threading.Thread]] = []
    try:
        server.listen(8)
        if sock_path is not None:
            ctx["listening_on"] = sock_path
        else:
            host, port = server.getsockname()[:2]
            ctx["listening_on"] = f"{host}:{port}"
        print(f"cmhse_tpu_torch serve_daemon listening on "
              f"{ctx['listening_on']}", flush=True)
        if ready_callback is not None:
            ready_callback()
        # a shutdown handled on a client thread stops the loop within
        # half a second
        server.settimeout(0.5)
        while not ctx["shutdown"]:
            try:
                conn, _ = server.accept()
            except TimeoutError:
                continue
            clients = [(c, th) for c, th in clients if th.is_alive()]
            if (max_connections is not None
                    and len(clients) >= max_connections):
                try:
                    conn.sendall((json.dumps(
                        {"error": f"server at max_connections "
                                  f"({max_connections}); retry later"})
                        + "\n").encode())
                except OSError:
                    pass
                conn.close()
                continue
            t = threading.Thread(target=_client_loop, args=(conn, ctx),
                                 daemon=True)
            t.start()
            clients.append((conn, t))
    finally:
        server.close()
        # end the read side of every connection (its thread's readline sees
        # EOF) and let replies in flight finish
        for c, _ in clients:
            try:
                c.shutdown(socket.SHUT_RD)
            except OSError:
                pass  # already closed by its own thread
        for _, t in clients:
            t.join(timeout=2)
        if sock_path is not None and os.path.exists(sock_path):
            os.unlink(sock_path)


def _cache_fingerprint(checkpoint: str, dataset, cfg) -> str:
    """Freshness key of ``--gallery_cache``: a change to the checkpoint, the
    split's captions or features (h5 file, or the ``features/`` directory)
    or the model config invalidates the cache."""
    import os

    def _mtime(p):
        try:
            return os.path.getmtime(p)
        except OSError:
            return None

    return json.dumps({
        "checkpoint": os.path.abspath(checkpoint),
        "ckpt_mtime": _mtime(os.path.join(checkpoint, "best"))
                      or _mtime(os.path.join(checkpoint, "config.json"))
                      or _mtime(checkpoint),
        "data_path": os.path.abspath(dataset.data_path),
        "split": dataset.split,
        "n": len(dataset),
        "captions_mtime": _mtime(os.path.join(
            dataset.data_path, f"{dataset.split}_captions.json")),
        "features_mtime": _mtime(dataset._h5_path),
        "features_dir_mtime": _mtime(dataset._npy_dir),
        "flat": dataset.flat,
        "model_cfg": repr(cfg.model),
    }, sort_keys=True)


def _load_or_encode_gallery(model, dataset, cfg, cache_path: str | None,
                            checkpoint: str):
    """The start-up encode, or with ``--gallery_cache`` its copy from an
    earlier start while the fingerprint holds. A stale or unreadable cache
    is re-encoded and overwritten, never trusted. The ``.npz`` keeps the
    JAX daemon's layout: bf16 embeddings stored as (exact) f32 beside their
    dtype's name, written under a temporary name and then moved into
    place."""
    import os

    import numpy as np
    import torch

    from cmhse_tpu_torch.data import batches_from_dataset
    from cmhse_tpu_torch.eval.encode import encode_gallery_device

    fp = _cache_fingerprint(checkpoint, dataset, cfg) if cache_path else None
    if cache_path and os.path.exists(cache_path):
        try:
            with np.load(cache_path, allow_pickle=False) as z:
                if str(z["fingerprint"]) == fp:
                    out = []
                    for name in ("v", "p"):
                        dt = getattr(torch, str(z[f"{name}_dtype"]))
                        out.append(torch.from_numpy(z[name]).to(
                            model.device, dt))
                    print(f"cmhse_tpu_torch serve_daemon: gallery loaded "
                          f"from cache {cache_path} (encode skipped)")
                    return (*out, torch.from_numpy(z["valid"]).to(
                        model.device), z["ids"])
            print("cmhse_tpu_torch serve_daemon: gallery cache is stale; "
                  "re-encoding")
        except Exception as e:  # a corrupt cache must not block start-up
            print(f"cmhse_tpu_torch serve_daemon: unreadable gallery cache "
                  f"({e}); re-encoding")
    encoded = encode_gallery_device(
        model, batches_from_dataset(dataset, cfg.data, shuffle=False),
        return_ids=True)
    if cache_path:
        v, p, valid, ids = encoded
        arrs = {}
        for name, a in (("v", v), ("p", p)):
            arrs[f"{name}_dtype"] = str(a.dtype).removeprefix("torch.")
            arrs[name] = a.float().cpu().numpy()  # exact for bf16
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as fh:  # a file object: savez adds no .npz
            np.savez(fh, fingerprint=fp, valid=valid.cpu().numpy(),
                     ids=np.asarray(ids), **arrs)
        os.replace(tmp, cache_path)
        print(f"cmhse_tpu_torch serve_daemon: gallery cached to "
              f"{cache_path}")
    return encoded


def build_context(checkpoint: str, data_path: str | None, split: str,
                  vocab_path: str | None = None, sharded: bool = False,
                  quantized: bool = False,
                  rescore_m: int | None = None,
                  gallery_cache: str | None = None,
                  auth_token: str | None = None,
                  allow_any_path: bool = False,
                  compact_threshold: float | None = 0.5,
                  batch_window_ms: float = 0.0, device=None) -> dict:
    """Load the checkpoint onto ``device`` (the card unless ``"cpu"``),
    encode the video-side gallery (or read it from ``gallery_cache``), and
    assemble the request-handling context; the text side for video_key
    queries is built at its first use.

    ``sharded``: both directions' Retrievers shard their galleries over a
    local mesh of every device of ``device``'s kind (``cli.sharded_mesh``),
    in this one process, as the JAX daemon meshes every local device.
    ``auth_token`` / ``allow_any_path``: the trust model (module
    docstring). ``compact_threshold``: compact both galleries when a remove
    leaves more than this fraction of rows invalid (None disables)."""
    from cmhse_tpu_torch.data import PrecompDataset, Vocabulary, find_vocab
    from cmhse_tpu_torch.eval.serve import Retriever
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    from cmhse_tpu_torch.device import resolve_device

    # the mesh first: a refused --sharded fails before any loading
    mesh = (sharded_mesh("cpu" if resolve_device(device).type == "cpu"
                         else "gpu") if sharded else None)
    model, cfg = restore_for_eval(checkpoint, device=device)
    data_path = data_path or cfg.data.data_path
    vocab = Vocabulary.load(find_vocab(data_path, vocab_path))
    dataset = PrecompDataset(data_path, split, vocab,
                             feat_dim=cfg.data.feat_dim,
                             flat=not cfg.model.hierarchical)
    # one encode gives both modalities; the text side keeps only the text
    # embeddings (closing over the whole tuple would pin the start-up video
    # embeddings past every compaction)
    encoded = _load_or_encode_gallery(model, dataset, cfg, gallery_cache,
                                      checkpoint)
    retriever = Retriever(model, mesh=mesh, quantize=quantized,
                          rescore_m=rescore_m)
    retriever.build_gallery(side="video", encoded=encoded)
    _, p_emb, enc_valid, enc_ids = encoded
    del encoded

    def build_text_side():
        r = Retriever(model, mesh=mesh, quantize=quantized,
                      rescore_m=rescore_m)
        r.build_gallery(side="text",
                        encoded=(None, p_emb, enc_valid, enc_ids))
        return r

    ctx = {
        "cfg": cfg,
        "vocab": vocab,
        "dataset": dataset,
        # every split behind the gallery, in ingest order
        "datasets": [dataset],
        "data_path": data_path,
        # the key table: start-up rows first, added items behind them;
        # gallery keys index into it
        "keys": list(dataset.keys),
        # every live or tombstoned name, and name -> newest row id, kept
        # up to date so remove and add are O(request)
        "key_set": set(dataset.keys),
        "key_to_row": {k: i for i, k in enumerate(dataset.keys)},
        "added": [],
        "retriever": retriever,
        "retriever_text": None,
        "removed_ids": [],
        "removed_keys": set(),
        "build_text_side": build_text_side,
        "split": split,
        "served": 0,
        "latencies": deque(maxlen=1024),
        "compactions": 0,
        "compact_threshold": compact_threshold,
        "auth_token": auth_token,
        "allow_any_path": allow_any_path,
        "shutdown": False,
        "lock": threading.Lock(),
        "ingest_lock": threading.Lock(),
    }
    ctx["batcher"] = (_QueryBatcher(ctx, batch_window_ms / 1e3)
                      if batch_window_ms > 0 else None)
    return ctx


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.serve_daemon")
    p.add_argument("checkpoint", help="run directory (with config.json)")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="unix socket path to listen on")
    p.add_argument("--tcp", default=None, metavar="HOST:PORT",
                   help="TCP address to listen on instead of a unix socket "
                        "(port 0 picks a free one). No authentication by "
                        "default: bind loopback or a firewalled interface, "
                        "or set --auth_token")
    p.add_argument("--data_path", default=None)
    p.add_argument("--split", default="val", help="gallery split")
    p.add_argument("--sharded", action="store_true",
                   help="shard both galleries over every local device in "
                        "this one process (each visible card; CPU shards "
                        "with --platform cpu); not under torchrun")
    p.add_argument("--quantized", action="store_true",
                   help="two-stage int8 top-k (million-row galleries)")
    p.add_argument("--rescore_m", type=int, default=None,
                   help="int8 candidate-pool depth (default max(64, 4k))")
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--gallery_cache", default=None, metavar="PATH",
                   help="keep the start-up gallery encode in this .npz and "
                        "reuse it on restart while the checkpoint and split "
                        "files are unchanged")
    p.add_argument("--log_jsonl", default=None, metavar="PATH",
                   help="append one JSONL record a request (op, ok, "
                        "latency_ms, ...)")
    p.add_argument("--warm", action="store_true",
                   help="build the video->paragraph side and run one query "
                        "each way before accepting clients")
    p.add_argument("--auth_token", default=None, metavar="TOKEN",
                   help="require every request to carry a matching 'token' "
                        "field (constant-time compare)")
    p.add_argument("--allow_any_path", action="store_true",
                   help="let {'op': 'add'} open splits outside the start-up "
                        "--data_path root")
    p.add_argument("--compact_threshold", type=float, default=0.5,
                   metavar="FRAC",
                   help="compact when a remove leaves more than this "
                        "fraction of rows invalid (<= 0 disables; default "
                        "0.5)")
    p.add_argument("--max_connections", type=int, default=None, metavar="N",
                   help="refuse connections beyond N concurrent clients")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   metavar="MS",
                   help="merge text queries arriving from different "
                        "connections within MS milliseconds into one device "
                        "call; 0 disables (default)")
    add_platform_flag(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if (args.socket is None) == (args.tcp is None):
        p.error("pass exactly one of --socket / --tcp")
    tcp = None
    if args.tcp is not None:
        host, _, port = args.tcp.rpartition(":")
        if not host or not port.isdigit() or ":" in host or "[" in host:
            p.error(f"--tcp wants an IPv4 HOST:PORT (or a resolvable "
                    f"hostname), got {args.tcp!r}")
        tcp = (host, int(port))
    device = device_for(args.platform)

    # bind before the start-up encode: a taken address fails at once, not
    # after minutes of encoding
    try:
        server = _bind_unix(args.socket) if args.socket is not None \
            else _bind_tcp(*tcp)
    except OSError as e:
        p.error(f"cannot listen on {args.socket or args.tcp}: {e}")
    try:
        ctx = build_context(args.checkpoint, args.data_path, args.split,
                            vocab_path=args.vocab_path,
                            sharded=args.sharded,
                            quantized=args.quantized,
                            rescore_m=args.rescore_m,
                            gallery_cache=args.gallery_cache,
                            auth_token=args.auth_token,
                            allow_any_path=args.allow_any_path,
                            compact_threshold=(args.compact_threshold
                                               if args.compact_threshold > 0
                                               else None),
                            batch_window_ms=args.batch_window_ms,
                            device=device)
        if args.warm:
            # one request each way: builds the text side and runs both
            # query paths once; the stats then count only clients' requests
            tok = {"token": args.auth_token} if args.auth_token else {}
            _handle_request({"query": "warm up the encoder", "k": 1, **tok},
                            ctx)
            if ctx["dataset"].keys:
                _handle_request(
                    {"video_key": ctx["dataset"].keys[0], "k": 1, **tok},
                    ctx)
            ctx["served"] = 0
            ctx["latencies"].clear()
            print("cmhse_tpu_torch serve_daemon warm: both directions built",
                  flush=True)
        if args.log_jsonl:
            from cmhse_tpu_torch.utils.logging import JsonlLogger

            ctx["logger"] = JsonlLogger(args.log_jsonl, tensorboard=False)
    except BaseException:
        import os

        server.close()
        if args.socket is not None and os.path.exists(args.socket):
            os.unlink(args.socket)
        raise
    try:
        serve_forever(ctx, args.socket, tcp=tcp, server=server,
                      max_connections=args.max_connections)
    finally:
        if ctx.get("logger") is not None:
            ctx["logger"].close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
