"""One rank of the port's multi-process checks.

Started by ``multiprocessing`` (spawn) as ``run(rank, world, workdir,
backend)``: by ``tests/test_torch_parallel_spawn.py`` over gloo (CPU
processes) and by ``scripts/multi_gpu_check.py`` over NCCL (one card a
rank). It imports torch and the port only. The parent writes the inputs
into ``workdir`` (``inputs.pt``: the config, initial weights, batches,
embeddings, GRU operands) and reads back ``result_<rank>.pt``; it runs the
same check bodies on one device for the reference. A ``faulthandler``
watchdog ends a hung rank with its stacks just before the parent's join
gives up on it.
"""

from __future__ import annotations

import faulthandler
import math
import os
import sys
import time

WATCHDOG_S = 100  # the parent joins for JOIN_S = 110


def _steps(cfg, init, batches, mesh):
    """Train steps from ``init`` over the global ``batches`` (this rank's
    rows under ``mesh``): final parameters, losses and each step's ms."""
    import torch

    from cmhse_tpu_torch.data import Batch
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.parallel import local_rows, place_state
    from cmhse_tpu_torch.train import create_train_state, train_step

    model = CMHSE(cfg.model, cfg.data.vocab_size, device=mesh.device)
    model.load_state_dict(init)
    state = place_state(create_train_state(cfg, model), mesh)
    losses, ms = [], []
    for b in batches:
        batch = local_rows(Batch(**b), mesh)
        t0 = time.perf_counter()
        state, m = train_step(state, batch, cfg.loss, mesh=mesh)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    return ({k: v.cpu().clone() for k, v in model.state_dict().items()},
            losses, ms)


def _sharded_eval(inp, mesh):
    """Every sharded rank count and top-k on the parent's embeddings."""
    from cmhse_tpu_torch.parallel import (prepare_sharded_topk_gallery,
                                          sharded_ranks,
                                          sharded_retrieval_metrics,
                                          sharded_sim_topk,
                                          sharded_sim_topk_prepared)

    dev = mesh.device
    v, p, valid = inp["v"].to(dev), inp["p"].to(dev), inp["valid"].to(dev)
    v_nan = inp["v_nan"].to(dev)
    out = {}
    for mode in ("query", "gallery"):
        for stream in (False, True):
            out[f"ranks/{mode}/{stream}"] = sharded_ranks(
                v, p, mesh, mode=mode, streaming=stream)
            out[f"ranks_masked/{mode}/{stream}"] = sharded_ranks(
                v_nan, p, mesh, mode=mode, valid=valid, streaming=stream)
        m = sharded_retrieval_metrics(v, p, mesh, ks=(1, 5), mode=mode,
                                      valid=valid, return_ranks=True)
        out[f"metrics/{mode}"] = {k: (x.clone() if x.dim() else float(x))
                                  for k, x in m.items()}
    q, g, gvalid = inp["q"].to(dev), inp["g"].to(dev), inp["gvalid"].to(dev)
    k = inp["k"]
    for stream in (False, True):
        out[f"topk/{stream}"] = sharded_sim_topk(q, g, k, mesh, valid=gvalid,
                                                 streaming=stream)
    for quantize in (False, True):
        prep, rows = prepare_sharded_topk_gallery(g, mesh, valid=gvalid,
                                                  quantize=quantize)
        out[f"prepared/{quantize}"] = sharded_sim_topk_prepared(
            q, prep, k, mesh, rows, quantized=quantize)
    return _to_cpu(out)


def _retriever(inp, device, mesh=None):
    """``Retriever(mesh=)`` (``mesh`` None: ``device`` alone) over the gallery
    the model encodes from the parent's batches: below the size rule, and
    held prepared exact and int8 (the rule forced), each answering the
    first batch's text queries after the build, a remove of the first
    query's top row and a compaction: ``{form/stage: (scores, idx)}``."""
    from cmhse_tpu_torch.config import ExperimentConfig
    from cmhse_tpu_torch.data import Batch
    from cmhse_tpu_torch.eval import serve
    from cmhse_tpu_torch.eval.encode import encode_gallery_device
    from cmhse_tpu_torch.models import CMHSE

    cfg = ExperimentConfig.from_json(inp["cfg"])
    model = CMHSE(cfg.model, cfg.data.vocab_size, device=device)
    model.load_state_dict(inp["init"])
    batches = [Batch(**b) for b in inp["batches"]]
    encoded = encode_gallery_device(model, batches, return_ids=True)
    b0 = batches[0]
    queries = (b0.words, b0.word_len, b0.sent_len)
    rule = serve.should_prepare_topk
    out = {}
    try:
        for form, prepared, quantize in (("sharded", False, False),
                                         ("prepared", True, False),
                                         ("int8", True, True)):
            serve.should_prepare_topk = lambda n, p=prepared: p
            r = serve.Retriever(model, mesh=mesh, quantize=quantize)
            r.build_gallery(encoded=encoded)
            out[f"{form}/build"] = r.retrieve(*queries, k=inp["k"])
            r.remove_from_gallery([r.gallery_keys[int(
                out[f"{form}/build"][1][0, 0])]])
            out[f"{form}/remove"] = r.retrieve(*queries, k=inp["k"])
            r.compact()
            out[f"{form}/compact"] = r.retrieve(*queries, k=inp["k"])
    finally:
        serve.should_prepare_topk = rule
    return out


def retriever_differences(got: dict, want: dict) -> list[str]:
    """The keys of two ``_retriever`` results that differ: indices
    exactly, scores within rtol 1e-5 / atol 1e-6."""
    import numpy as np

    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    return [key for key, (ws, wi) in want.items()
            if not (np.array_equal(got[key][1], wi)
                    and np.allclose(got[key][0], ws, rtol=1e-5, atol=1e-6))]


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_cpu(v) for v in x)
    return x.cpu() if hasattr(x, "cpu") else x


def eval_differences(got: dict, want: dict) -> list[str]:
    """The keys of two ``_sharded_eval`` results that differ: ranks and
    top-k scores and indices exactly, ties included; the metrics' recalls
    within a relative 1e-6."""
    import torch

    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    bad = []
    for key, w in want.items():
        g = got[key]
        if key.startswith("metrics"):
            same = set(g) == set(w) and all(
                torch.equal(g[n], w[n]) if n.endswith("_ranks")
                else math.isclose(g[n], w[n], rel_tol=1e-6, abs_tol=1e-12)
                for n in w)
        elif key.startswith(("topk", "prepared")):
            same = torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
        else:
            same = torch.equal(g, w)
        if not same:
            bad.append(key)
    return bad


def _busy(inp, mesh):
    """One K1 encode, a K1 ``save_gates`` forward and one K2 backward,
    first on a quiet device, then enqueued while three ``async_op``
    all-reduces across the ranks are in flight: whether the two runs are
    equal bit for bit, the all-reduced values and the busy run's ms."""
    import torch
    import torch.distributed as dist

    from cmhse_tpu_torch.ops import gru_kernel as gk

    dev = mesh.device
    xw, w_h, b_h, lengths, douts = (inp["busy"][k].to(dev) for k in
                                    ("xw", "w_h", "b_h", "lengths", "douts"))

    def calls():
        outs, final = gk.gru_forward(xw, w_h, b_h, lengths)
        o, _, gates = gk.gru_forward(xw, w_h, b_h, lengths, save_gates=True)
        return (outs, final) + gk.gru_backward(gates, o, lengths, w_h, douts)

    with torch.no_grad():
        quiet = calls()
        bufs = [torch.ones(inp["busy"]["floats"], device=dev)
                for _ in range(3)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        works = [dist.all_reduce(x, group=mesh.group, async_op=True)
                 for x in bufs]
        busy = calls()
        for w in works:
            w.wait()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    return {"equal": all(torch.equal(a, c) for a, c in zip(quiet, busy)),
            "reduced": [x[0].item() for x in bufs], "ms": ms}


def _fit(inp, device):
    """``fit`` under the mesh, recording which files this rank wrote."""
    from cmhse_tpu_torch.config import ExperimentConfig
    from cmhse_tpu_torch.data import SyntheticHierarchicalDataset
    from cmhse_tpu_torch.train import checkpoint
    from cmhse_tpu_torch.train.loop import fit

    cfg = ExperimentConfig.from_json(inp["fit_cfg"])
    writes = []
    real = checkpoint._atomic_save

    def recording(payload, path):
        writes.append(os.path.relpath(path, cfg.train.checkpoint_dir))
        real(payload, path)

    checkpoint._atomic_save = recording

    def ds(n, seed):
        return SyntheticHierarchicalDataset(
            num_videos=n, feat_dim=cfg.data.feat_dim,
            vocab_size=cfg.data.vocab_size, max_clips=cfg.data.max_clips,
            max_frames=cfg.data.max_frames, max_words=cfg.data.max_words,
            seed=seed)

    state, best = fit(cfg, ds(*inp["fit_train"]), ds(*inp["fit_val"]),
                      device=device)
    return {"writes": writes, "best_rsum": float(best),
            "params": {k: v.cpu().clone()
                       for k, v in state.model.state_dict().items()}}


def run(rank: int, world: int, workdir: str, backend: str = "gloo",
        watchdog_s: float = WATCHDOG_S) -> None:
    """This rank's checks: ``gloo`` on the CPU, ``nccl`` on card
    ``rank``."""
    faulthandler.dump_traceback_later(watchdog_s, exit=True)
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        from cmhse_tpu_torch.config import ExperimentConfig
        from cmhse_tpu_torch.parallel import make_mesh

        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        cfg = ExperimentConfig.from_json(inp["cfg"])
        out = {}
        mesh = make_mesh((-1,), ("data",), device=device)
        out["dp"] = _steps(cfg, inp["init"], inp["batches"], mesh)
        out["eval"] = _sharded_eval(inp, mesh)
        out["retriever"] = _retriever(inp, device, mesh)
        out["busy"] = _busy(inp, mesh)
        idle = make_mesh((1, world), ("data", "model"), device=device)
        out["idle"] = _steps(cfg, inp["init"], inp["batches"], idle)
        out["fit"] = _fit(inp, device)
        torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()
        sys.stdout.flush()
