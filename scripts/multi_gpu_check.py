#!/usr/bin/env python3
"""The port's data parallelism across the cards of one host: N NCCL ranks,
one a card, held against one card.

Run from the repository root on a host with N >= 2 CUDA cards::

    python3 scripts/multi_gpu_check.py [--ranks N]

or, to rehearse, on the CPU (N gloo ranks, the kernels' plain versions,
golden widths)::

    python3 scripts/multi_gpu_check.py --cpu --ranks 4

Each rank runs ``tests/torch_dist_worker.py``: the checks that
``tests/test_torch_parallel_spawn.py`` runs over 2 gloo ranks, here at
cmhse_full's published widths (a 64-video batch, a 10,000-row gallery for
the ranks and 100,000 rows for the top-k). The script then runs the same
check bodies on card 0 alone and holds every rank to them:

(a) data-parallel steps, on the ``data`` axis and on an idle ``model``
    axis: losses within rtol 1e-5 and every parameter within
    ``tests/test_train_dp.py``'s band (rtol 2e-4, atol 2e-5) of one
    card's, and bit-equal across the ranks; the median ms of both kinds of
    step;
(b) sharded ranks, metrics and top-k on exact-arithmetic rows (every
    product exact in f32 whatever the order): equal to one card's
    (``eval_differences``), but for the int8 prepared top-k, whose
    per-shard candidate pools differ from one card's: it captures at least
    CAPTURE_FLOOR of the exact top-k;
(c) K1 and K2 while all-reduces across the ranks are in flight: equal to a
    quiet run;
(d) ``fit`` over the ranks: rank 0 alone writes, and every rank ends with
    the same parameters and best rsum;
(e) ``Retriever(mesh=)``, a shard a rank, over the gallery the model
    encodes from the batches: below the size rule and held prepared, after
    a build, a remove and a compaction, one card's scores within
    RETRIEVER_ATOL (indices may differ only between rows so tied), and
    the int8 form capturing at least CAPTURE_FLOOR of one card's exact
    top-k.

Then, in this one process, (f) the local mesh the sharded daemon serves
from: a ``Retriever`` over the N cards (shard i on card i) against one on
card 0 alone, exact and int8, over the TOPK_ROWS exact-arithmetic rows and
TOPK_QUERIES queries: after a build, an add of APPEND_ROWS rows (the shards
rebuilt), a remove of 1% and a compaction, the exact top-k equal to card
0's, the int8 one capturing at least CAPTURE_FLOOR of it; the median ms of
a request on each.

Every join has a timeout and every rank a ``faulthandler`` watchdog that
ends a hang with its stacks. Prints the cards' names and power limits,
one JSON line a rank and a last line ``{"ok": ...}``; exits non-zero if
any rank failed or hung, or any check failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the worker by its own name: an installed package may be called ``tests``
sys.path.insert(0, str(ROOT / "tests"))

STEPS = 3
GALLERY = 10_000  # BASELINE config 5's gallery
TOPK_ROWS = 100_000
TOPK_QUERIES = 1024
BUSY_MIB = 256
CAPTURE_FLOOR = 0.99
RETRIEVER_ATOL = 1e-5  # f32 sums over other splits: a near tie's band
APPEND_ROWS = 4096
DP_TOL = dict(rtol=2e-4, atol=2e-5)
LR = 2e-4  # Adam's first steps at 1e-3 turn near-zero gradients into
# sign-sized moves, which the band above would not hold
WATCHDOG_S = 500
JOIN_S = 520


def exact_rows(np, rng, n: int, d: int):
    """Unit rows rounded to multiples of 2**-10: every dot product of two
    of them is exact in f32, so any split of the sums agrees."""
    x = rng.randn(n, d)
    x /= (x * x).sum(1, keepdims=True) ** 0.5
    return ((x * 1024).round() / 1024).astype(np.float32)


def make_inputs(torch, np, cpu: bool, seed: int, run_dir: str) -> dict:
    """The worker's ``inputs.pt``: cmhse_full (golden widths on the CPU),
    the seed's weights and batches, the exact-arithmetic embeddings, the
    GRU operands of (c) and the fit config of (d)."""
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (Batch, SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE

    cfg = get_preset("cmhse_full")
    if cpu:  # tests/make_goldens.py's widths
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, embed_size=32,
                                           rnn_hidden=32, word_dim=16,
                                           feat_dim=24),
            data=dataclasses.replace(cfg.data, feat_dim=24, vocab_size=128,
                                     max_frames=8, max_words=6))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr=LR, num_epochs=1, checkpoint_dir=run_dir, log_step=1,
        val_step=0))
    dc = cfg.data
    ds = SyntheticHierarchicalDataset(
        num_videos=STEPS * dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=seed + 1)
    batches = [{f.name: torch.as_tensor(np.asarray(getattr(b, f.name)))
                for f in dataclasses.fields(Batch)}
               for b in batches_from_dataset(ds, dc, shuffle=False)]
    model = CMHSE(cfg.model, dc.vocab_size, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 5)
    d = cfg.model.embed_size
    n, rows, queries = (600, 4000, 64) if cpu else (GALLERY, TOPK_ROWS,
                                                     TOPK_QUERIES)
    v = torch.from_numpy(exact_rows(np, rng, n, d))
    v_nan = v.clone()
    v_nan[7] = float("nan")
    gvalid = np.ones(rows, bool)
    gvalid[[0, rows // 2, rows - 1]] = False
    b, t, h = (32, 8, 32) if cpu else (512, 64, 1024)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32))

    busy = {"xw": f32(b, t, 3 * h), "w_h": f32(h, 3 * h, scale=h ** -0.5),
            "b_h": f32(3 * h, scale=0.1),
            "lengths": torch.from_numpy(rng.randint(0, t + 1, b)
                                        .astype(np.int32)),
            "douts": f32(b, t, h),
            "floats": (1 if cpu else BUSY_MIB) * 2**18}
    return {
        "cfg": cfg.to_json(), "init": model.state_dict(),
        "batches": batches,
        "v": v, "p": torch.from_numpy(exact_rows(np, rng, n, d)),
        "v_nan": v_nan, "valid": torch.from_numpy(np.arange(n) % 9 != 0),
        "q": torch.from_numpy(exact_rows(np, rng, queries, d)),
        "g": torch.from_numpy(exact_rows(np, rng, rows, d)),
        "gvalid": torch.from_numpy(gvalid), "k": 10, "busy": busy,
        "fit_cfg": cfg.to_json(),
        "fit_train": (4 * dc.batch_size, seed + 2),
        "fit_val": (2 * dc.batch_size, seed + 3),
    }


def spawn(torch, world: int, workdir: str, backend: str) -> list[int]:
    """``world`` ranks of the worker; their exit codes (a rank still
    running at the deadline is killed)."""
    import torch_dist_worker

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, world, workdir, backend, WATCHDOG_S))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for proc in procs:
            proc.join(max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(5)
    return [p.exitcode for p in procs]


def check(torch, np, inputs: dict, results: list, device) -> list[dict]:
    """Each rank's results against the worker's bodies on ``device``
    alone; one summary a rank. Raises on the first failed check."""
    from cmhse_tpu_torch.config import ExperimentConfig
    from cmhse_tpu_torch.parallel import make_mesh
    from torch_dist_worker import (_retriever, _sharded_eval, _steps,
                                   eval_differences)

    cfg = ExperimentConfig.from_json(inputs["cfg"])
    one = make_mesh(device=device)
    params, losses, single_ms = _steps(cfg, inputs["init"],
                                       inputs["batches"], one)
    want_eval = _sharded_eval(inputs, one)
    want_retriever = _retriever(inputs, device)
    r0 = results[0]
    summaries = []
    for rank, r in enumerate(results):
        out = {"rank": rank}
        for axis in ("dp", "idle"):
            got, got_losses, ms = r[axis]
            np.testing.assert_allclose(got_losses, losses, rtol=1e-5,
                                       err_msg=f"rank {rank} {axis} losses")
            worst = 0.0
            for name, w in params.items():
                np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                           err_msg=f"rank {rank} {axis} "
                                           f"{name}", **DP_TOL)
                worst = max(worst, (got[name] - w).abs().max().item())
                if not torch.equal(got[name], r0[axis][0][name]):
                    raise AssertionError(f"rank {rank} {axis} {name}: not "
                                         "rank 0's parameters")
            out[axis] = {"losses": got_losses, "ms": ms,
                         "ms_median": float(np.median(ms)),
                         "worst_param_abs_diff": worst}
        bad = eval_differences(r["eval"], want_eval)
        exact = want_eval["topk/True"][1]
        got8 = r["eval"]["prepared/True"][1]
        capture = float((got8[:, :, None] == exact[:, None, :]).any(2)
                        .float().mean())
        if [b for b in bad if b != "prepared/True"] or \
                capture < CAPTURE_FLOOR:
            raise AssertionError(f"rank {rank}: sharded evaluation differs "
                                 f"from one device's at {bad}; int8 "
                                 f"capture {capture}")
        out["eval"] = {"equal_but": bad, "int8_capture": capture}
        busy = r["busy"]
        if not busy["equal"] or busy["reduced"] != [float(len(results))] * 3:
            raise AssertionError(f"rank {rank}: beside the all-reduces "
                                 f"{busy}")
        out["busy"] = busy
        fit = r["fit"]
        if (rank == 0) != bool(fit["writes"]) or (
                rank == 0 and "best" not in fit["writes"]):
            raise AssertionError(f"rank {rank} wrote {fit['writes']}")
        if fit["best_rsum"] != r0["fit"]["best_rsum"] or any(
                not torch.equal(w, r0["fit"]["params"][k])
                for k, w in fit["params"].items()):
            raise AssertionError(f"rank {rank}'s fit differs from rank 0's")
        out["fit"] = {"writes": len(fit["writes"]),
                      "best_rsum": fit["best_rsum"]}
        out["retriever"] = retriever_check(np, rank, r["retriever"],
                                           want_retriever)
        summaries.append(out)
    summaries.append({"one_device": {"losses": losses, "ms": single_ms,
                                     "ms_median": float(np.median(
                                         single_ms))}})
    return summaries


def capture(np, exact_i, got_i) -> float:
    """Share of the exact top-k's (query, row) pairs that ``got_i`` holds."""
    exact_i, got_i = np.asarray(exact_i), np.asarray(got_i)
    return float((got_i[:, :, None] == exact_i[:, None, :]).any(2).mean())


def retriever_check(np, rank: int, got: dict, want: dict) -> dict:
    """(e): a rank's ``_retriever`` results against one card's."""
    if set(got) != set(want):
        raise AssertionError(f"rank {rank}: retriever results "
                             f"{sorted(set(got) ^ set(want))}")
    out = {}
    for key, (ws, wi) in want.items():
        gs, gi = got[key]
        if key.startswith("int8"):
            continue
        err = float(np.abs(gs - ws).max())
        if not err <= RETRIEVER_ATOL:
            raise AssertionError(f"rank {rank} retriever {key}: scores off "
                                 f"by {err}")
        out[key] = int((gi != wi).sum())
    out["int8_capture"] = capture(np, want["prepared/build"][1],
                                  got["int8/build"][1])
    if out["int8_capture"] < CAPTURE_FLOOR:
        raise AssertionError(f"rank {rank}: int8 retriever {out}")
    return out


def local_mesh_check(torch, np, inputs: dict, devices: list) -> dict:
    """(f): the sharded Retriever over a local mesh of ``devices`` against
    one on ``devices[0]`` alone, exact and int8."""
    from cmhse_tpu_torch.eval.serve import Retriever
    from cmhse_tpu_torch.parallel import make_mesh

    dev = devices[0]
    mesh = make_mesh(devices=devices)
    g, q = inputs["g"].to(dev), inputs["q"].to(dev)
    k = inputs["k"]
    n = g.shape[0]
    encoded = (g, g, inputs["gvalid"].to(dev), np.arange(n))
    extra = g[:APPEND_ROWS].flip(1).contiguous()  # exact rows too
    m = extra.shape[0]
    added = (extra, extra, torch.ones(m, dtype=torch.bool, device=dev),
             np.arange(n, n + m))
    drop = np.random.RandomState(7).choice(n, n // 100, replace=False)
    pairs = {quantize: (Retriever(None, quantize=quantize),
                        Retriever(None, mesh=mesh, quantize=quantize))
             for quantize in (False, True)}

    def timed(r):
        ms = []
        for _ in range(5):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r._search(q, k)  # ends in a copy to the host
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    out = {"shards": len(devices)}
    for stage in ("build", "add", "remove", "compact"):
        for single, sharded in pairs.values():
            for r in (single, sharded):
                if stage == "build":
                    r.build_gallery(encoded=encoded)
                elif stage == "add":
                    r.add_to_gallery(encoded=added)
                elif stage == "remove":
                    r.remove_from_gallery(drop.tolist())
                else:
                    r.compact()
        (e1, es), (_, q8) = pairs[False], pairs[True]
        _, want_i = e1._search(q, k)
        got_s, got_i = es._search(q, k)
        if not np.array_equal(got_i, want_i):
            raise AssertionError(f"(f) {stage}: the sharded exact top-k "
                                 "differs from one card's")
        c = capture(np, want_i, q8._search(q, k)[1])
        if c < CAPTURE_FLOOR:
            raise AssertionError(f"(f) {stage}: int8 capture {c}")
        out[stage] = {"int8_capture": c, "shard_rows":
                      es._prepared_shard_rows}
    out["ms"] = {name: timed(r) for name, r in (
        ("exact one card", pairs[False][0]), ("exact sharded", pairs[False][1]),
        ("int8 one card", pairs[True][0]), ("int8 sharded", pairs[True][1]))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: every card)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU at golden widths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    if args.cpu:
        world, device = args.ranks or 2, torch.device("cpu")
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available():
            print("multi_gpu_check: no CUDA device", file=sys.stderr)
            return 1
        world = args.ranks or torch.cuda.device_count()
        if world > torch.cuda.device_count() or world < 2:
            print(f"multi_gpu_check: {world} ranks on "
                  f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        from cmhse_tpu_torch.ops import cuda_lib

        t0 = time.perf_counter()
        cuda_lib.build()  # once, before the ranks load it
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    workdir = tempfile.mkdtemp(prefix="cmhse_multi_")
    t0 = time.perf_counter()
    ok = False
    try:
        inputs = make_inputs(torch, np, args.cpu, args.seed,
                             str(Path(workdir) / "run"))
        torch.save(inputs, Path(workdir) / "inputs.pt")
        print(f"inputs in {time.perf_counter() - t0:.1f} s", flush=True)
        codes = spawn(torch, world, workdir,
                      "gloo" if args.cpu else "nccl")
        print(f"{world} ranks ran in {time.perf_counter() - t0:.1f} s; "
              f"exit codes {codes}", flush=True)
        if codes == [0] * world:
            results = [torch.load(Path(workdir) / f"result_{r}.pt",
                                  weights_only=False) for r in range(world)]
            for line in check(torch, np, inputs, results, device):
                print(json.dumps(line), flush=True)
            from cmhse_tpu_torch.parallel import local_devices

            t1 = time.perf_counter()
            local = local_mesh_check(torch, np, inputs, local_devices(
                "cpu" if args.cpu else "gpu", n=world))
            local["seconds"] = time.perf_counter() - t1
            print(json.dumps({"local_mesh": local}), flush=True)
            ok = True
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"ok": ok, "ranks": world,
                          "backend": "gloo" if args.cpu else "nccl",
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
