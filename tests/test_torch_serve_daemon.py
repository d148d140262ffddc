"""The port's serving daemon against the JAX package's on the same weights:
the JAX daemon tests' fixture checkpoint, its params carried into a port
run directory (``interop.params_from_jax``, ``write_best_dir``). One script
of requests through both ``build_context``s and ``_handle_request`` gives
the same keys, scores within 1e-5 and errors of the same meaning; then the
port's daemon over a unix socket and TCP through both packages' clients
(auth, max_connections, MAX_LINE_BYTES, the batch window, shutdown); the
streaming-scale case (40,000 spliced rows, exact and int8) against the JAX
daemon; ``main`` with ``--gallery_cache``; ``cli.retrieve --quantized`` and
``--connect``; ``build_context(sharded=True)`` (the port's local mesh of 8
CPU shards against JAX's 8-device CPU mesh), ``main --sharded`` and
``cli.retrieve --sharded`` against the JAX command. Every socket has a timeout and every thread is joined with
one."""

import collections
import contextlib
import io
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from reference_layout import write_reference_dataset
from test_serve_daemon import FEAT, VAL_KEYS, _fixture_run

from cmhse_tpu.cli import serve_daemon as jax_daemon
from cmhse_tpu.client import ServeClient as JaxClient
from cmhse_tpu.data.fixtures import \
    splice_synthetic_gallery as jax_splice
from cmhse_tpu.train.checkpoint import restore_for_eval as jax_restore
from cmhse_tpu_torch.cli import retrieve as port_retrieve
from cmhse_tpu_torch.cli import serve_daemon as port_daemon
from cmhse_tpu_torch.client import ServeClient as PortClient
from cmhse_tpu_torch.client import ServeError
from cmhse_tpu_torch.data.fixtures import \
    splice_synthetic_gallery as port_splice
from cmhse_tpu_torch.interop import params_from_jax
from cmhse_tpu_torch.train.checkpoint import eval_payload, write_best_dir

torch.set_num_threads(2)
WAIT = 60  # seconds: every socket operation and join


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(data root, JAX checkpoint dir, port run dir) on the same weights."""
    root, ckpt = _fixture_run(tmp_path_factory, "torchparity")
    _, params, cfg = jax_restore(ckpt)
    port = str(tmp_path_factory.mktemp("torch_serve_run"))
    with open(os.path.join(port, "config.json"), "w") as f:
        f.write(cfg.to_json())
    write_best_dir(port, eval_payload(
        params_from_jax(jax.tree.map(np.asarray, params))))
    return str(root), ckpt, port


def _contexts(run, **kw):
    root, ckpt, port = run
    return (jax_daemon.build_context(ckpt, root, "val", **kw),
            port_daemon.build_context(port, root, "val", device="cpu", **kw))


def _same_reply(want: dict, got: dict, what) -> None:
    assert ("error" in got) == ("error" in want), (what, want, got)
    if "error" in want:
        # the same refusal (the tail may quote an exception's own text)
        assert got["error"][:24] == want["error"][:24], (what, want, got)
        return
    assert set(got) == set(want), (what, want, got)
    for name, w in want.items():
        g = got[name]
        if name == "latency_ms":
            continue
        if name == "results":
            rows_w = w if w and isinstance(w[0], list) else [w]
            rows_g = g if g and isinstance(g[0], list) else [g]
            assert len(rows_g) == len(rows_w), what
            for rw, rg in zip(rows_w, rows_g):
                assert [h["key"] for h in rg] == [h["key"] for h in rw], \
                    (what, rw, rg)
                np.testing.assert_allclose([h["score"] for h in rg],
                                           [h["score"] for h in rw],
                                           rtol=0, atol=1e-5, err_msg=what)
        elif isinstance(w, dict):
            _same_reply(w, g, (what, name))
        elif isinstance(w, float):
            assert g == pytest.approx(w, abs=1e-6), (what, name)
        else:
            assert g == w, (what, name, w, g)


def _same_stats(want: dict, got: dict) -> None:
    lat = ("latency_ms_p50", "latency_ms_p90", "latency_ms_p99")
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in lat} == \
        {k: v for k, v in want.items() if k not in lat}
    assert all(got[k] > 0 for k in lat)


def test_request_script_matches_jax(run, tmp_path):
    jctx, pctx = _contexts(run, compact_threshold=0.2)
    outside = str(tmp_path / "elsewhere")
    os.makedirs(outside)
    script = [
        {"query": "a man runs", "k": 3, "id": 1},
        {"query": ["a man runs", "a dog jumps in the park"], "k": 5},
        {"video_key": "v_val000", "k": 4, "id": "v"},
        {"video_key": "nope", "k": 2},
        {"op": "add", "split": "train"},
        {"op": "add", "split": "train"},           # duplicate
        {"op": "add", "split": "val", "data_path": outside},  # outside root
        {"op": "add", "split": "nosuch"},
        {"op": "add"},
        {"query": "a woman walks near the lake", "k": 14},
        {"video_key": "v_train002", "k": 3},       # an added video's key
        {"op": "remove", "keys": ["v_val003", "nope"]},
        {"op": "remove", "keys": ["v_val003"]},     # already gone
        {"op": "remove", "keys": ["v_train001", "v_val005"]},  # auto-compact
        {"query": ["a child jumps", "the chef cooks at home"], "k": 20},
        {"video_key": "v_val001", "k": 20},
        {"op": "compact"},
        {"op": "remove", "keys": []},
        {"query": "", "k": 2},
        {"query": [], "k": 2},
        {"query": "x", "k": 0},
        {"k": 3},
        "not a dict",
    ]
    for i, req in enumerate(script):
        want = jax_daemon._handle_request(req, jctx)
        got = port_daemon._handle_request(req, pctx)
        _same_reply(want, got, (i, req))
        if req == {"op": "remove", "keys": ["v_train001", "v_val005"]}:
            assert got["auto_compaction"]["compacted"] == 5
    _same_stats(jax_daemon._handle_request({"op": "stats"}, jctx),
                port_daemon._handle_request({"op": "stats"}, pctx))
    assert pctx["compactions"] == jctx["compactions"] == 2
    st = port_daemon._handle_request({"op": "stats"}, pctx)
    assert st["jax_cache_clears"] == 0 and st["valid_rows"] == 11
    # the online compaction called directly, after one more remove: an
    # auto-compaction's threshold skips it, a plain call compacts
    for handle, ctx in ((jax_daemon._handle_request, jctx),
                        (port_daemon._handle_request, pctx)):
        handle({"op": "remove", "keys": ["v_val006"]}, ctx)
    _same_reply(jax_daemon._compact_online(jctx, only_above=0.5),
                port_daemon._compact_online(pctx, only_above=0.5),
                "_compact_online above 0.5")
    _same_reply(jax_daemon._compact_online(jctx),
                port_daemon._compact_online(pctx), "_compact_online")
    assert port_daemon._compact_online(pctx)["compacted"] == 0


def _hit_keys(text: str) -> list:
    """The keys of a retrieve command's printed hits, in order."""
    return [line.split()[1] for line in text.splitlines()
            if line.startswith("  ") and "score=" in line]


def test_sharded_context_matches_jax(run, tmp_path, capsys):
    """tests/test_serve_daemon.py::test_handler_sharded_context for both
    daemons: a query, a remove before the text side's lazy build (which
    must not bring it back), a video_key query, a live add from another
    directory and queries that reach the added items both ways; the same
    keys, scores within 1e-5. Then ``main --sharded`` over a socket, and
    ``cli.retrieve --sharded`` against the JAX command's hits."""
    jctx, pctx = _contexts(run, sharded=True, allow_any_path=True)
    mesh = pctx["retriever"].mesh
    assert mesh.is_local and mesh.data_size == 8
    assert jctx["retriever"].mesh is not None

    def both(req):
        want = jax_daemon._handle_request(req, jctx)
        got = port_daemon._handle_request(req, pctx)
        _same_reply(want, got, req)
        return got

    r = both({"query": "a man runs", "k": 3})
    assert len(r["results"]) == 3
    assert {h["key"] for h in r["results"]} <= set(VAL_KEYS)
    gone = r["results"][0]["key"]
    assert both({"op": "remove", "keys": [gone]})["removed"] == 1
    assert pctx["retriever_text"] is None
    v2p = both({"video_key": VAL_KEYS[1], "k": 7})
    assert gone not in {h["key"] for h in v2p["results"]}
    assert pctx["retriever_text"].mesh is mesh
    live = tmp_path / "live"
    write_reference_dataset(str(live), feat_dim=FEAT, seed=11,
                            splits=[("live", 3)])
    assert both({"op": "add", "split": "live",
                 "data_path": str(live)})["added"] == 3
    hits = both({"query": "a man runs", "k": 10})["results"]
    assert any(h["key"].startswith("v_live") for h in hits)
    assert len(both({"video_key": "v_live000", "k": 3})["results"]) == 3
    both({"op": "compact"})
    both({"query": ["a man runs", "a dog jumps in the park"], "k": 5})

    root, ckpt, port = run
    sock = str(tmp_path / "sh.sock")
    t, c, out = _start_main([port, "--socket", sock, "--data_path", root,
                             "--platform", "cpu", "--sharded"], sock)
    with c:
        want = jax_daemon._handle_request(
            {"query": "a man runs", "k": 3},
            jax_daemon.build_context(ckpt, root, "val"))
        assert [h["key"] for h in c.query("a man runs", k=3)] == \
            [h["key"] for h in want["results"]]
        _stop(c, t)
    assert out["rc"] == 0

    from cmhse_tpu.cli import retrieve as jax_retrieve

    tail = ["--data_path", root, "--query", "a man runs", "--query_video",
            "v_val002", "-k", "4", "--platform", "cpu", "--sharded"]
    capsys.readouterr()
    assert jax_retrieve.main([ckpt] + tail) in (0, None)
    want = _hit_keys(capsys.readouterr().out)
    assert port_retrieve.main([port] + tail) == 0
    assert _hit_keys(capsys.readouterr().out) == want and len(want) == 8


def _serve(ctx, **kw):
    """serve_forever on a daemon thread; returns it once ready."""
    ctx["shutdown"] = False
    ready = threading.Event()
    t = threading.Thread(target=port_daemon.serve_forever, args=(ctx,),
                         kwargs={"ready_callback": ready.set, **kw},
                         daemon=True)
    t.start()
    assert ready.wait(WAIT)
    return t


def _tcp_addr(ctx):
    host, port = ctx["listening_on"].rsplit(":", 1)
    return host, int(port)


def _stop(client, thread):
    client.shutdown()
    thread.join(timeout=WAIT)
    assert not thread.is_alive()


@pytest.mark.parametrize("client_cls", [PortClient, JaxClient])
def test_socket_clients_and_auth(run, tmp_path, client_cls):
    """Both packages' clients drive the port's daemon over a unix socket,
    then over TCP on port 0 with --auth_token (accepted and refused)."""
    jctx, pctx = _contexts(run)
    sock = str(tmp_path / "d.sock")
    t = _serve(pctx, sock_path=sock)
    with client_cls(socket_path=sock, timeout=WAIT) as c:
        hits = c.query("a man runs", k=3)
        want = jax_daemon._handle_request({"query": "a man runs", "k": 3},
                                          jctx)["results"]
        assert [h["key"] for h in hits] == [h["key"] for h in want]
        assert len(c.query(["a man runs", "a dog jumps"], k=2)) == 2
        assert len(c.query_video("v_val000", k=2)) == 2
        root = run[0]
        assert c.add("train", data_path=root)["added"] == 6
        assert c.remove(["v_train000"]) == 1
        assert c.compact()["compacted"] >= 1
        assert c.stats()["valid_rows"] == 13
        with pytest.raises(ServeError if client_cls is PortClient
                           else Exception, match="k must be"):
            c.query("a man runs", k=0)
        _stop(c, t)
    assert not os.path.exists(sock)

    _, actx = _contexts(run, auth_token="sekrit")
    t = _serve(actx, tcp=("127.0.0.1", 0))
    with client_cls(tcp=_tcp_addr(actx), timeout=WAIT) as bad:
        with pytest.raises(Exception, match="unauthorized"):
            bad.query("a man runs", k=1)
        with pytest.raises(Exception, match="unauthorized"):
            bad.shutdown()
    with client_cls(tcp=_tcp_addr(actx), timeout=WAIT,
                    token="sekrit") as good:
        assert len(good.query("a man runs", k=2)) == 2
        _stop(good, t)


def test_max_connections_and_line_limit(run):
    _, pctx = _contexts(run)
    t = _serve(pctx, tcp=("127.0.0.1", 0), max_connections=1)
    addr = _tcp_addr(pctx)
    holder = PortClient(tcp=addr, timeout=WAIT)
    assert holder.stats()["valid_rows"] == 8
    with socket.create_connection(addr, timeout=WAIT) as over, \
            over.makefile("rb") as of:
        assert "max_connections" in json.loads(of.readline())["error"]
        assert of.readline() == b""  # hung up after the error line
    assert holder.stats()["valid_rows"] == 8  # never evicted
    holder.close()

    def free_slot():
        """A connection once the daemon has freed the one slot: it does so
        when the last client's thread has ended, a moment after the hang-up
        that client saw."""
        deadline = time.monotonic() + WAIT
        while True:
            s = socket.create_connection(addr, timeout=WAIT)
            f = s.makefile("rwb")
            f.write(json.dumps({"op": "stats"}).encode() + b"\n")
            f.flush()
            if "error" not in json.loads(f.readline()):
                return s, f
            f.close()
            s.close()
            assert time.monotonic() < deadline
            time.sleep(0.1)

    s, f = free_slot()
    with s, f:  # an oversized line: one error reply, then a hang-up
        f.write(b"x" * (port_daemon.MAX_LINE_BYTES + 10) + b"\n")
        f.flush()
        reply = json.loads(f.readline())
        assert f.readline() == b""
    assert "exceeds" in reply["error"]
    s, f = free_slot()
    with s, f:
        f.write(json.dumps({"op": "shutdown"}).encode() + b"\n")
        f.flush()
        assert json.loads(f.readline()).get("ok")
    t.join(timeout=WAIT)
    assert not t.is_alive()


def test_batch_window_concurrent_clients(run, tmp_path):
    """--batch_window_ms: concurrent clients' queries merge, and each gets
    the rows a lone query gets."""
    _, pctx = _contexts(run, batch_window_ms=200.0)
    texts = ["a man runs", "a dog jumps in the park", "the chef cooks",
             "a child walks"]
    alone = {t: port_daemon._handle_request({"query": t, "k": 3},
                                            pctx)["results"] for t in texts}
    sock = str(tmp_path / "b.sock")
    t = _serve(pctx, sock_path=sock)
    replies = [None] * len(texts)

    def client(i):
        with PortClient(socket_path=sock, timeout=WAIT) as c:
            replies[i] = c.request({"query": texts[i], "k": 3, "id": i})

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(texts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT)
        assert not th.is_alive()
    for i, r in enumerate(replies):
        assert r["id"] == i
        _same_reply({"results": alone[texts[i]]},
                    {"results": r["results"]}, i)
    assert max(r["batched_with"] for r in replies) >= 1
    with PortClient(socket_path=sock, timeout=WAIT) as c:
        _stop(c, t)


@pytest.mark.parametrize("quantized", [False, True])
def test_streaming_scale_matches_jax(run, quantized):
    """The JAX daemon's streaming-scale case: 40,000 spliced rows (+128
    invalid), held prepared (int8 with ``quantized``) by both; queries, an
    add, a threshold-crossing remove with its auto-compaction, stats."""
    jctx, pctx = _contexts(run, quantized=quantized, compact_threshold=0.012)
    rows_j = jax_splice(jctx, 40_000, pad=128)
    rows_p = port_splice(pctx, 40_000, pad=128)
    np.testing.assert_array_equal(rows_p, rows_j)
    assert pctx["retriever"]._prepared is not None
    assert (pctx["retriever"]._prepared.int8_chunks is not None) == quantized
    texts = ["a man runs down the street", "a dog jumps", "two people talk"]

    def both(req):
        want = jax_daemon._handle_request(req, jctx)
        got = port_daemon._handle_request(req, pctx)
        _same_reply(want, got, req)
        return got

    base = both({"query": texts, "k": 10})
    assert "text side unavailable" in both({"video_key": "v_val000",
                                            "k": 1})["error"]
    assert both({"op": "add", "split": "val"})["added"] == 8
    both({"query": texts, "k": 10})
    protect = {h["key"] for row in base["results"] for h in row}
    victims = [k for k in pctx["keys"][:700] if k not in protect][:600]
    rm = both({"op": "remove", "keys": victims})
    assert rm["removed"] == 600 and "auto_compaction" in rm
    again = both({"query": texts, "k": 10})
    assert again["results"] == base["results"]
    _same_stats(jax_daemon._handle_request({"op": "stats"}, jctx),
                port_daemon._handle_request({"op": "stats"}, pctx))


def _start_main(argv, sock):
    """``main(argv)`` on a daemon thread; returns it once the socket
    answers."""
    out = {}

    def target():
        out["rc"] = port_daemon.main(argv)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    deadline = time.monotonic() + WAIT
    while True:
        try:
            c = PortClient(socket_path=sock, timeout=WAIT)
        except OSError:
            assert t.is_alive() and time.monotonic() < deadline
            time.sleep(0.1)
            continue
        return t, c, out


def test_main_gallery_cache(run, tmp_path, monkeypatch):
    """--gallery_cache: the first start encodes and writes the cache, the
    second loads it (an encode would fail), a changed split re-encodes."""
    import cmhse_tpu_torch.eval.encode as enc_mod

    root, _, port = run
    cache = str(tmp_path / "gallery.npz")
    sock = str(tmp_path / "m.sock")
    argv = [port, "--socket", sock, "--data_path", root, "--platform",
            "cpu", "--gallery_cache", cache, "--warm",
            "--log_jsonl", str(tmp_path / "access.jsonl")]
    t, c, out = _start_main(argv, sock)
    with c:
        first = c.query("a man runs", k=3)
        first_v = c.query_video("v_val000", k=3)
        assert c.stats()["requests_served"] == 2  # the warm-up not counted
        _stop(c, t)
    assert out["rc"] == 0 and os.path.exists(cache)
    assert len(open(tmp_path / "access.jsonl").read().splitlines()) >= 3

    with monkeypatch.context() as m:
        m.setattr(enc_mod, "encode_gallery_device",
                  lambda *a, **k: pytest.fail("re-encoded a fresh cache"))
        t, c, out = _start_main(argv, sock)
        with c:
            assert c.query("a man runs", k=3) == first
            assert c.query_video("v_val000", k=3) == first_v
            _stop(c, t)

    later = time.time() + 30
    os.utime(os.path.join(root, "val_captions.json"), (later, later))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t, c, out = _start_main(argv, sock)
        with c:
            assert c.query("a man runs", k=3) == first
            _stop(c, t)
    assert "stale" in buf.getvalue()


def test_retrieve_quantized_and_connect(run, tmp_path, capsys, monkeypatch):
    """cli.retrieve --quantized (the prepared form forced) prints the exact
    path's hits; --connect asks a port daemon and touches no card."""
    import cmhse_tpu_torch.eval.serve as port_serve

    root, _, port = run
    args = [port, "--data_path", root, "--query", "a man runs", "-k", "3",
            "--platform", "cpu"]
    assert port_retrieve.main(args) == 0
    exact = capsys.readouterr().out
    monkeypatch.setattr(port_serve, "should_prepare_topk", lambda n: True)
    assert port_retrieve.main(args + ["--quantized", "--rescore_m",
                                      "8"]) == 0
    assert capsys.readouterr().out == exact

    _, pctx = _contexts(run)
    sock = str(tmp_path / "r.sock")
    t = _serve(pctx, sock_path=sock)
    capsys.readouterr()  # the daemon's "listening on" line
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_retrieve.main(["--connect", sock, "--query", "a man runs",
                               "-k", "3"]) == 0
    assert capsys.readouterr().out == exact
    with pytest.raises(SystemExit):  # a gallery flag is the daemon's
        port_retrieve.main(["--connect", sock, "--query", "x",
                            "--quantized"])
    with pytest.raises(SystemExit):
        port_retrieve.main(["--connect", sock, "--query", "x",
                            "--platform", "cpu"])
    with PortClient(socket_path=sock, timeout=WAIT) as c:
        _stop(c, t)


def test_launch_tally_per_thread():
    """Every launch joins the shared count; each thread's own tally holds
    only its launches, so an add's encode on its client's thread is
    counted apart from queries launching on others."""
    from cmhse_tpu_torch.ops import cuda_lib

    saved = collections.Counter(cuda_lib.launches)
    try:
        cuda_lib.reset_launches()
        mine = cuda_lib.thread_launch_count("probe")
        seen = {}

        def other():
            for _ in range(5):
                cuda_lib.count_launch("probe", "f32", "t")
            seen["n"] = cuda_lib.thread_launch_count("probe")

        t = threading.Thread(target=other, daemon=True)
        t.start()
        for _ in range(3):
            cuda_lib.count_launch("probe", "bf16", "t")
        t.join(timeout=WAIT)
        assert not t.is_alive()
        assert seen["n"] == 5
        assert cuda_lib.thread_launch_count("probe") - mine == 3
        assert cuda_lib.launch_count("probe") == 8
        cuda_lib.reset_launches()  # the thread tallies are read as deltas
        assert cuda_lib.thread_launch_count("probe") - mine == 3
    finally:
        cuda_lib.reset_launches()
        cuda_lib.launches.update(saved)
