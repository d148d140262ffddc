"""Daemon soak of the port: sustained mixed load against one live
``cmhse_tpu_torch`` serving daemon.

N client threads stream text queries (merged by ``--batch_window_ms``)
while one churn client cycles add -> remove of a 4-video split through the
live-ingest path, crossing the auto-compaction threshold each cycle, for
``--seconds`` of wall clock. At the end: no errored request, no stuck
thread, the gallery holds exactly its start-up rows again, no churned key
is in the answers, and the daemon shuts down. A port of
``scripts/serve_soak.py`` with its flags and its summary line.

On the card: ``python scripts/torch_serve_soak.py`` (``--synthetic_gallery
1000000 --compact_threshold 3e-5 --quantized`` for the million-row int8
case). On the CPU: ``--platform cpu`` with a small ``--n_val``,
``--feat_dim`` and ``--embed``. Prints one JSON summary line; exits 1
unless ``ok``. ``latency_ms_p50`` / ``latency_ms_p99`` are the daemon's
``stats``, over its last 1,024 queries only; ``client_latency_ms_p50`` /
``_p99`` / ``_max`` are over the round trip of every query of the window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)

TEXTS = ["a man runs down the street", "a dog jumps over a fence",
         "two people talk in a kitchen", "a car drives past a house"]
CHURN = 4  # videos of the split each cycle adds and removes
WAIT_S = 600  # the longest a thread or the daemon's start may take


def build_fixture(td: str, n_val: int, feat_dim: int, embed: int, device):
    """Reference-layout data (``.npy`` features) and a run directory with
    a freshly initialised model of ``embed`` width, written through the
    ``CheckpointManager`` as a training run writes ``best``. Returns
    (data root, run dir, valid rows of the val split)."""
    import torch

    from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig,
                                        ModelConfig)
    from cmhse_tpu_torch.data import PrecompDataset, build_vocab
    from cmhse_tpu_torch.data.fixtures import write_reference_dataset
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import create_train_state
    from cmhse_tpu_torch.train.checkpoint import CheckpointManager

    root = os.path.join(td, "data")
    write_reference_dataset(root, n_train=6, n_val=n_val, feat_dim=feat_dim,
                            features="npy")
    with open(os.path.join(root, "train_captions.json")) as f:
        caps = json.load(f)
    vocab = build_vocab(
        [s for c in caps.values() for s in c["sentences"]], threshold=1)
    vocab.save(os.path.join(root, "vocab.json"))
    cfg = ExperimentConfig(
        data=DataConfig(data_path=root, batch_size=32, feat_dim=feat_dim,
                        vocab_size=len(vocab) + 8, max_clips=3,
                        max_frames=6, max_sentences=3, max_words=8),
        model=ModelConfig(embed_size=embed, word_dim=embed // 2,
                          feat_dim=feat_dim, rnn_hidden=embed // 2),
    )
    n_valid = len(PrecompDataset(root, "val", vocab, feat_dim=feat_dim))
    model = CMHSE(cfg.model, cfg.data.vocab_size, device=device,
                  generator=torch.Generator().manual_seed(0))
    run = os.path.join(td, "run")
    mgr = CheckpointManager(run, cfg)
    mgr.save(create_train_state(cfg, model), epoch=0, best_rsum=0.0,
             is_best=True)
    mgr.close()
    return root, run, n_valid


def build_parser() -> argparse.ArgumentParser:
    from cmhse_tpu_torch.cli import add_platform_flag

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seconds", type=float, default=300.0)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    p.add_argument("--n_val", type=int, default=64)
    p.add_argument("--feat_dim", type=int, default=512)
    p.add_argument("--embed", type=int, default=512)
    p.add_argument("--synthetic_gallery", type=int, default=0, metavar="N",
                   help="replace the start-up gallery with N synthetic "
                        "unit rows (>= 32768 holds it prepared, and int8 "
                        "with --quantized)")
    p.add_argument("--compact_threshold", type=float, default=0.05,
                   help="auto-compaction threshold; with a large "
                        "--synthetic_gallery pass ~3e-5, so that each "
                        "churn cycle compacts the large gallery while "
                        "queries run")
    p.add_argument("--quantized", action="store_true",
                   help="serve the int8 two-stage top-k")
    add_platform_flag(p)
    return p


def main(argv=None, answers: dict | None = None) -> dict:
    """Run the soak; print its JSON summary line and return it.

    ``answers``: if given, it receives the daemon's final answers before
    it shuts down, for a caller to hold against a direct Retriever:
    ``"text"`` (one top-10 hit list for each of TEXTS), ``"video_keys"``
    (the first 4 keys of the val split) and ``"video"`` (their top-10)."""
    args = build_parser().parse_args(argv)

    from cmhse_tpu_torch.cli import device_for, serve_daemon
    from cmhse_tpu_torch.client import ServeClient
    from cmhse_tpu_torch.data.fixtures import (splice_synthetic_gallery,
                                               write_reference_dataset)

    device = device_for(args.platform)
    out = {"seconds": args.seconds, "clients": args.clients,
           "batch_window_ms": args.batch_window_ms}
    errors: list = []
    q_counts = [0] * args.clients  # one counter a thread: no shared race
    q_ms: list = [[] for _ in range(args.clients)]  # every round trip
    cycles = [0]
    stop = threading.Event()

    with tempfile.TemporaryDirectory() as td:
        root, run, n_valid = build_fixture(td, args.n_val, args.feat_dim,
                                           args.embed, device)
        churn_dir = os.path.join(td, "churn")
        write_reference_dataset(churn_dir, feat_dim=args.feat_dim, seed=99,
                                splits=[("churn", CHURN)], features="npy")
        ctx = serve_daemon.build_context(
            run, root, "val", allow_any_path=True, quantized=args.quantized,
            compact_threshold=args.compact_threshold,
            batch_window_ms=args.batch_window_ms, device=device)
        val_keys = list(ctx["keys"][:4])
        if args.synthetic_gallery:
            splice_synthetic_gallery(ctx, args.synthetic_gallery)
        sock_path = os.path.join(td, "serve.sock")
        ready = threading.Event()
        srv = threading.Thread(
            target=serve_daemon.serve_forever, args=(ctx, sock_path),
            kwargs={"ready_callback": ready.set}, daemon=True)
        srv.start()
        if not ready.wait(timeout=WAIT_S):
            raise RuntimeError("the daemon did not start")

        def querier(ci: int):
            try:
                with ServeClient(socket_path=sock_path, timeout=120) as c:
                    n = 0
                    while not stop.is_set():
                        t0 = time.perf_counter()
                        hits = c.query(TEXTS[(ci + n) % len(TEXTS)], k=5)
                        q_ms[ci].append((time.perf_counter() - t0) * 1e3)
                        if len(hits) != 5:
                            raise AssertionError(f"{len(hits)} hits: {hits}")
                        q_counts[ci] += 1
                        n += 1
            except Exception as e:
                errors.append(f"querier {ci}: {type(e).__name__}: {e}")

        def churner():
            keys = [f"v_churn{i:03d}" for i in range(CHURN)]
            try:
                with ServeClient(socket_path=sock_path, timeout=300) as c:
                    while not stop.is_set():
                        r = c.request({"op": "add", "split": "churn",
                                       "data_path": churn_dir})
                        if r.get("added") != CHURN:
                            raise AssertionError(f"add: {r}")
                        time.sleep(0.2)  # queries see the grown gallery
                        r = c.request({"op": "remove", "keys": keys})
                        if r.get("removed") != CHURN:
                            raise AssertionError(f"remove: {r}")
                        cycles[0] += 1
            except Exception as e:
                errors.append(f"churner: {type(e).__name__}: {e}")

        threads = ([threading.Thread(target=querier, args=(ci,), daemon=True)
                    for ci in range(args.clients)]
                   + [threading.Thread(target=churner, daemon=True)])
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        stop.wait(args.seconds)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        elapsed = time.perf_counter() - t0
        alive = [t for t in threads if t.is_alive()]

        with ServeClient(socket_path=sock_path, timeout=120) as c:
            st = c.stats()
            final_hits = c.query(TEXTS[0], k=args.n_val)
            if answers is not None:
                answers["text"] = c.query(TEXTS, k=10)
                answers["video_keys"] = val_keys
                answers["video"] = [c.query_video(key, k=10)
                                    for key in val_keys]
            c.shutdown()
        srv.join(timeout=60)

    expected_valid = args.synthetic_gallery or n_valid
    all_ms = sorted(ms for per in q_ms for ms in per)

    def pct(p):  # the daemon's rule for its stats: nearest rank
        return round(serve_daemon._nearest_rank(all_ms, p), 3) \
            if all_ms else None

    out.update({
        "elapsed_s": round(elapsed, 1),
        "errors": errors,
        "stuck_threads": len(alive),
        "queries": sum(q_counts),
        "add_remove_cycles": cycles[0],
        "qps": round(sum(q_counts) / elapsed, 1),
        "requests_served": st.get("requests_served"),
        "compactions": st.get("compactions"),
        "latency_ms_p50": st.get("latency_ms_p50"),
        "latency_ms_p99": st.get("latency_ms_p99"),
        "client_latency_ms_p50": pct(0.50),
        "client_latency_ms_p99": pct(0.99),
        "client_latency_ms_max": round(all_ms[-1], 3) if all_ms else None,
        "final_gallery_rows": st.get("gallery_rows"),
        "final_valid_rows": st.get("valid_rows"),
        "synthetic_gallery": args.synthetic_gallery,
        "quantized": args.quantized,
        "streaming_engaged": bool(st.get("prepared")),
        "daemon_stopped": not srv.is_alive(),
    })
    out["ok"] = bool(not errors and not alive and not srv.is_alive()
                     and st.get("valid_rows") == expected_valid
                     and not any(h["key"].startswith("v_churn")
                                 for h in final_hits))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
