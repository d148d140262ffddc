#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cmhse_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA card, ``nvcc``
and PyTorch built for CUDA (no JAX needed)::

    python3 chip_smoke.py [--seed N] [--videos N]

Phases (any failure raises and the script exits non-zero):
  0. build the hand-written kernels from ``cmhse_tpu_torch/csrc``;
  1. device facts: name, count, power limit; TF32 off for matmul and cuDNN;
  2. the ``gru_fwd`` kernel against its plain PyTorch version at the
     serving path's shapes (plus a ragged one), with times;
     2b. its ``save_gates`` and ``with_h0`` variants and 2c. the ``gru_bwd``
     kernel against their plain versions at the training path's six GRU
     shapes (plus a ragged one with zero-length rows, with and without h0);
     2d. the same three ``gru_fwd`` variants and ``gru_bwd`` (with and
     without h0) in bf16 at the same shapes, against their plain versions
     in bf16, with cuDNN's GRU in bf16 as the yardstick;
  3. the ``rankcount`` kernel against its plain version (counts exact) at
     Q=1024, N=100,000, D=1024 and at the main path's shape, with times;
     3b. the streaming top-k (plain torch ops) against the dense one at
     100,000 rows, ties included; both timed, with peak memory, at 100,000
     and 1,000,000 rows on both sides of the Retriever's dense budget;
     3c. the ``simhinge`` kernel (both directions in one launch) against
     its plain version (maxima and argmaxes equal, ties to the lowest
     index) at 512, 64 and 300 rows;
     3d. the ``rankcount`` lowp branch (bf16 multiplies) against its plain
     version, from bf16 operands and from f32 ones (cast included): exact
     on exact-arithmetic rows, inside the near-tie band on random rows,
     Q=1024, N=100,000;
  4. the serving path at full ``cmhse_full`` width (H = E = 1024, batch
     64, random weights from the seed): encode a 512-video synthetic
     gallery, answer 8 text->video and 8 video->text top-10 requests, score
     it with ``validate_metrics(streaming=True)``; the first batch is
     re-encoded on the CPU (plain versions) and must agree; 4b.
     torch.profiler splits two batches' encode device time by kernel family;
     4c. the same in the bf16 configuration (``dtype`` and
     ``feature_dtype`` bfloat16) on the same weights and batches, plus the
     lowp rank count; embeddings held against the f32 model's, the first
     batch re-encoded on the CPU in bf16; a profiler split of its encode;
  5. the training path at the same width: 8 ``train_step``s on one 64-video
     batch (finite losses and grad norms, the last loss below the first,
     6 + 6 + 2 kernel launches per step), then ``validate_metrics`` on the
     trained weights; 5b. torch.profiler splits one step's device time by
     kernel family; 5c. one step at batch 8, card against the CPU's plain
     path: loss, grad_norm and every parameter gradient; 5d. the same three
     in bf16 (only the bf16 GRU kernels may launch; card vs CPU on four
     batches with the hardest negatives pinned, in the bf16 bands of
     ``tests/test_torch_bf16.py``; how often bf16 changes the picks);
  6. the training loop at the same width, f32: 6a. can ``train_steps``
     (K steps in one CUDA graph) capture and replay the step, against
     ``train_step`` at batch 8; 6. ``fit`` for 2 epochs over 384
     correlated synthetic videos (validation of 256 at each epoch's end,
     snapshots, a best checkpoint; losses, step and validation times,
     checkpoint seconds, launches per epoch); 6b. a run killed after step 5
     and resumed from its step-4 snapshot, against the uninterrupted run
     tensor by tensor; 6c. one epoch at two steps a dispatch against the
     first run's checkpoint after one epoch;
     6d. train steps with batches through the prefetch and through
     pageable copies, timed in turns; 6e. eight steps at lr 1e-3 on phase
     5's batch from weights drawn with numpy (the card's side of
     ``scripts/lr_rise_check.py``). Phases 4 and 4c also time the encode
     through the prefetch against the pageable ``Batch.to`` path, and 4b
     shows on which stream the host-to-device copies ran;
  7. the command-line chain at the same width: 7a. the native packer
     against ``pad_batch`` on 64 of phase 6's videos, f32 and bf16 (bit for
     bit; host ms of each); then over a reference-layout directory written
     by the port's fixtures (384 train / 256 val videos, 1-8 clips of 4-64
     rows): ``cli.build_vocab``, ``cli.train`` for one epoch (K1
     ``save_gates`` / ``with_h0``, K2, K3), ``cli.evaluate --streaming
     --dump_ranks`` as ``python -m`` in a subprocess and in this process
     (K4; the dump against a dense ``validate_metrics``),
     ``cli.export_torch`` / ``cli.import_torch`` (bit-equal round trip, the
     import's dump identical) and ``cli.retrieve`` (5 hits a query), with
     each stage's seconds and launches;
  8. one JSON line listing each kernel and bf16 variant with its path, its
     launches there, its error against its plain version, times and bound;
  9. last line: ``{"ok": true, "device": {...}}``.

With no CUDA device it exits with code 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet), the roofline of bound_ms
F32_FLOPS = 67e12  # FP32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12

GRU_ATOL = 1e-4  # f32; K=1024 sums in another order, compounded over steps
# bf16 kernels vs their plain versions, compared in bf16: the JAX package's
# bf16 bands (tests/test_pallas_gru.py, tests/test_pallas_gru_grad.py), as
# in tests/test_torch_bf16.py: outputs within an absolute 1e-2, gradients
# within a relative L2 error of 2e-2 (a last-bit carry difference can move
# the next step's bf16 operand by an ulp)
BF16_ATOL = 1e-2
BF16_GRAD_RL2 = 2e-2
# cuDNN's bf16 GRU rounds at other points than the kernel's (a bf16 carry),
# so its final state is held only loosely: a check of the weight mapping
LIB_BF16_ATOL = 0.25
# gru_bwd vs the plain BPTT loop: max abs error <= this * max |reference| per
# output (dxw, dhn, db, dh0), since the sums compound over T steps
GRU_BWD_RTOL = 1e-4
# one train step at batch 8, card vs CPU: loss and grad_norm relative errors;
# each gradient tensor's max abs error relative to its largest entry (f32
# sums in other orders through up to 64 BPTT steps and two hinge passes)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3
TRAIN_GRAD_RTOL = 1e-3
TRAIN_STEPS = 8
# Phase 5's learning rate, the low end of the range the config names for
# the reference. At the preset's 1e-3, Adam's first sign-sized step from
# random weights spreads the embeddings and the hardest-negative terms
# rise for several steps, so the falling-loss check would test that
# transient rather than the gradients (PERF.md, Findings).
TRAIN_LR = 2e-4
# phase 6: two runs' parameters and Adam moments, tensor by tensor, within
# this fraction of the tensor's largest entry
STATE_RTOL = 1e-6
# phase 6's fit: correlated synthetic videos at the preset's widths
FIT_TRAIN_VIDEOS = 384  # 6 steps an epoch at batch 64
FIT_VAL_VIDEOS = 256
FIT_EPOCHS = 2
FIT_SNAPSHOT = 4  # snapshot_step
FIT_KILL_AFTER = 5  # 6b kills the second run after this many steps
FIT_PIPELINE_STEPS = 6  # 6d's steps a timed window
PACK_REPS = 20  # 7a: host timings a packer
# phase 7's reference-layout data: ActivityNet-like lengths, as phase 4's
CLI_TRAIN_VIDEOS = 384
CLI_VAL_VIDEOS = 256
CLI_CLIPS = (1, 9)  # 1-8 clips a video (half-open, as rng.randint takes it)
CLI_ROWS = (4, 65)  # 4-64 feature rows a clip
ENCODE_ATOL = 1e-4  # card vs CPU embeddings of one full-width batch
SCORE_ATOL = 1e-4  # served top-k scores vs the gallery embeddings' products
# Random weights embed every video close to every other (cosines near 1), so
# scores crowd together: a rank may move across an item whose score lies
# within float32 summation noise (~1e-7 at |s| ~ 1) of the positive's.
RANK_TIE_TOL = 1e-5
REQUESTS = 6  # each direction: the first call, then steady state
# The bf16 model against the f32 one on the same weights (phase 4c): about
# three times what was read at seed 0 (max abs 9.5e-4, lowest cosine
# 0.999991; PERF.md), so a wrong bf16 path shows
BF16_EMB_ATOL = 3e-3
BF16_EMB_COS = 0.99997
# phase 5d: data seeds (from --seed + 2) of the card-vs-CPU bf16 step;
# bf16's relative spacing at 1; the pinned objective against the objective
# at its own picks, all gradients' relative L2: the two differ only where
# an f32 difference in the loss's arithmetic flips the bf16 rounding of an
# embedding's cotangent, by an ulp
PARITY_BF16_SEEDS = 4
BF16_ULP = 2.0**-8
CONSISTENT = BF16_ULP
# a parameter whose bf16 gradient lies within this relative L2 distance of
# its f32 gradient (the same weights and negatives) is one bf16 determines
DETERMINED = 0.1


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls
    (CUDA events; warm L2)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` in ms, replayed ``reps`` times from a
    CUDA graph captured once (CUDA events; warm L2): the device's time with
    no host launch overhead between calls, for work of tens of
    microseconds, where back-to-back eager calls time the host. Every call
    warms up and captures on one side stream: cuBLAS keeps a workspace
    (32 MiB on the H100) for each stream it has run on until the process
    ends, so a new stream a call would hold 0.22 GiB by phase 5."""
    import torch

    if not hasattr(graph_ms, "stream"):
        graph_ms.stream = torch.cuda.Stream()
    stream = graph_ms.stream
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up outside the capture (builds, caches)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float,
             peak: float = F32_FLOPS) -> tuple[float, str]:
    """Least time the card could take: the larger of the two rooflines,
    operations at ``peak`` (the rate of their type)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_generator(torch, rng):
    """A generator on the card, seeded from the script's numpy stream:
    large random inputs are drawn there, not on the host."""
    return torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))


def gru_inputs(torch, rng, b: int, t: int, d: int, h: int):
    """Random GRU inputs on the card: x [b, t, d] ~ N(0, 1) and w_i, w_h,
    b_i, b_h uniform in +-1/sqrt(h), the port's init."""
    gen = card_generator(torch, rng)
    scale = 1.0 / h ** 0.5

    def uniform(*shape):
        return (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) \
            * scale

    x = torch.randn(b, t, d, device="cuda", generator=gen)
    return (x, uniform(d, 3 * h), uniform(h, 3 * h), uniform(3 * h),
            uniform(3 * h))


def phase_gru(torch, rng, shapes) -> dict:
    """gru_fwd vs gru_recurrence_plain; times at each shape. ``shapes``:
    list of (label, lengths int32 [B], T, D)."""
    from cmhse_tpu_torch.models.gru import gru_input_projection
    from cmhse_tpu_torch.ops import gru_kernel

    h = 1024
    dev = torch.device("cuda")
    rows = []
    for label, lengths_np, t, d in shapes:
        b = lengths_np.shape[0]
        x, w_i, w_h, b_i, b_h = gru_inputs(torch, rng, b, t, d, h)
        lengths = torch.from_numpy(lengths_np).to(dev)
        with torch.inference_mode():
            xw = gru_input_projection(x, w_i, b_i).contiguous()
            outs, final = gru_kernel.gru_recurrence(xw, w_h, b_h, lengths)
            want_outs, want_final = gru_kernel.gru_recurrence_plain(
                xw, w_h, b_h, lengths)
            torch.cuda.synchronize()
            err = max((outs - want_outs).abs().max().item(),
                      (final - want_final).abs().max().item())
            if not err <= GRU_ATOL:
                raise AssertionError(f"gru_fwd {label}: max abs err {err} > "
                                     f"{GRU_ATOL}")
            ms = cuda_ms(lambda: gru_kernel.gru_recurrence(xw, w_h, b_h,
                                                           lengths))
            plain = cuda_ms(lambda: gru_kernel.gru_recurrence_plain(
                xw, w_h, b_h, lengths), reps=3, warmup=1)
            library = library_gru_ms(torch, x, lengths_np, w_i, w_h, b_i,
                                     b_h, final)
        live = int(lengths_np.clip(0, t).sum())
        bms, by = gru_bounds(b, t, h, live)
        row = dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=bms, bound_by=by, library_ms=library)
        log(f"  gru_fwd {label}: err {err:.3g}  kernel {ms:.4f} ms  plain "
            f"{plain:.4f} ms  cuDNN {library:.4f} ms  "
            f"bound {bms:.4f} ms ({by}, {live} live steps)")
        rows.append(row)
    return rows


def library_gru_ms(torch, x, lengths_np, w_i, w_h, b_i, b_h, final,
                   h0=None, mode: str = "inference",
                   dtype=None) -> float | None:
    """torch.nn.GRU (cuDNN) over the same sequences, packed. Packing refuses
    length-0 rows, whose result is the initial state anyway, so they are
    left out. cuDNN includes the input projection and zero-fills padded
    steps, so only ``final`` is compared (a check of the weight mapping).
    ``mode``: "inference" times the forward under the caller's no-grad
    mode; "train" the training forward (it keeps cuDNN's reserve space for
    the backward); "backward" the backward alone (input and weight
    gradients) through one retained graph, for random cotangents.
    ``dtype``: the type cuDNN runs in (f32 by default). In bf16 cuDNN rounds
    at its own points, so its final is held only within LIB_BF16_ATOL; if
    it refuses the type, the error is printed and None returned."""
    dtype = dtype or torch.float32
    atol = GRU_ATOL if dtype == torch.float32 else LIB_BF16_ATOL
    nz = torch.from_numpy(lengths_np > 0).to(x.device)
    x, final = x[nz].to(dtype), final[nz].float()
    hx = None if h0 is None else h0[nz][None].to(dtype).contiguous()
    lengths_np = lengths_np[lengths_np > 0]
    gru = torch.nn.GRU(w_i.shape[0], w_h.shape[0],
                       batch_first=True).to(x.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(w_i.T)
        gru.weight_hh_l0.copy_(w_h.T)
        gru.bias_ih_l0.copy_(b_i)
        gru.bias_hh_l0.copy_(b_h)
    gru = gru.to(dtype)
    with torch.enable_grad() if mode != "inference" else torch.no_grad():
        xin = x.detach().requires_grad_(mode == "backward")
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            xin, torch.from_numpy(lengths_np).long(), batch_first=True,
            enforce_sorted=False)
        try:
            out, h_n = gru(packed, hx)
        except RuntimeError as e:
            if dtype == torch.float32:
                raise
            log(f"    cuDNN GRU refuses {dtype}: {e}")
            return None
        err = (h_n[0].float() - final).abs().max().item()
        if not err <= atol:
            raise AssertionError(f"cuDNN GRU final differs from gru_fwd by "
                                 f"{err}")
        if mode != "backward":
            return cuda_ms(lambda: gru(packed, hx))
        cot = (torch.randn_like(out.data), torch.randn_like(h_n))
        wrt = [xin, *gru.parameters()]
        return cuda_ms(lambda: torch.autograd.grad(
            (out.data, h_n), wrt, cot, retain_graph=True))


def gru_bounds(b, t, h, live, gates=False, seeded=False,
               backward=False, bf16=False) -> tuple[float, str]:
    """bound_ms of one K1 or K2 call: the recurrent product's FLOPs over the
    live row-steps, and each input read and output written once, counting
    what this run's lengths need (K1 reads xw and writes gates on live
    steps only; outs at every step). In bf16 the streams and W_h take 2
    bytes an element (b_h, lengths and the bias sums stay 4) and the
    product runs at the bf16 tensor-core peak."""
    flops = 2.0 * live * h * 3 * h
    if not backward:
        streams = (live * 3 * h + h * 3 * h + b * t * h + b * h
                   + (live * 4 * h if gates else 0)
                   + (b * h if seeded else 0))
        words = 3 * h + b
    else:  # gates and h_prev of live steps, douts, dfinal, W_h, h0 in;
        # dxw, dhn, dh0 out; lengths in and the bias sums out
        streams = (live * 5 * h + b * t * h + b * h + 3 * h * h
                   + (b * h if seeded else 0) + b * t * 4 * h + b * h)
        words = b + 4 * h
    return bound_ms(flops, (2.0 if bf16 else 4.0) * streams + 4.0 * words,
                    BF16_FLOPS if bf16 else F32_FLOPS)


def phase_gru_train(torch, rng, shapes, h: int = 1024) -> tuple[list, list]:
    """2b: gru_fwd's save_gates (and with_h0) variants and 2c: gru_bwd,
    each against its plain version at the training path's shapes, with
    times. ``shapes``: (label, lengths int32 [B], T, D, seeded). The saved
    gates are compared on live steps only (the kernel leaves the others
    unwritten); gru_bwd against the plain BPTT loop for random cotangents
    ``douts``/``dfinal`` (and ``h0``), by max abs error relative to the
    largest reference entry."""
    from cmhse_tpu_torch.models.gru import gru_input_projection
    from cmhse_tpu_torch.ops import gru_kernel as gk

    dev = torch.device("cuda")
    fwd_rows, bwd_rows = [], []
    for label, lengths_np, t, d, seeded in shapes:
        b = lengths_np.shape[0]
        x, w_i, w_h, b_i, b_h = gru_inputs(torch, rng, b, t, d, h)
        gen = card_generator(torch, rng)
        h0 = (torch.rand(b, h, device=dev, generator=gen) * 2 - 1
              if seeded else None)
        douts = torch.randn(b, t, h, device=dev, generator=gen)
        dfinal = torch.randn(b, h, device=dev, generator=gen)
        lengths = torch.from_numpy(lengths_np).to(dev)
        live_mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
        live = int(lengths_np.clip(0, t).sum())
        with torch.no_grad():
            xw = gru_input_projection(x, w_i, b_i).contiguous()
            outs, final, gates = gk.gru_forward(xw, w_h, b_h, lengths, h0,
                                                save_gates=True)
            w_outs, w_final, w_gates = gk.gru_recurrence_plain(
                xw, w_h, b_h, lengths, h0, save_gates=True)
            torch.cuda.synchronize()
            err = max((outs - w_outs).abs().max().item(),
                      (final - w_final).abs().max().item(),
                      (gates[live_mask] - w_gates[live_mask]).abs().max()
                      .item() if live else 0.0)
            if not err <= GRU_ATOL:
                raise AssertionError(f"gru_fwd save_gates {label}: max abs "
                                     f"err {err} > {GRU_ATOL}")
            ms = cuda_ms(lambda: gk.gru_forward(xw, w_h, b_h, lengths, h0,
                                                save_gates=True))
            plain = cuda_ms(lambda: gk.gru_recurrence_plain(
                xw, w_h, b_h, lengths, h0, save_gates=True), reps=3, warmup=1)
            library = library_gru_ms(torch, x, lengths_np, w_i, w_h, b_i, b_h,
                                     final, h0, mode="train")
            bms, by = gru_bounds(b, t, h, live, gates=True, seeded=seeded)
            fwd_rows.append(dict(shape=label, max_abs_err=err, ms=ms,
                                 plain_ms=plain, bound_ms=bms, bound_by=by,
                                 library_ms=library, seeded=seeded))
            log(f"  2b gru_fwd save_gates{'+h0' if seeded else ''} {label}: "
                f"err {err:.3g}  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                f"cuDNN train fwd {library:.4f} ms  bound {bms:.4f} ms ({by})")

            got = gk.gru_backward(gates, outs, lengths, w_h, douts, dfinal, h0)
            want = gk.gru_backward_plain(gates, outs, lengths, w_h, douts,
                                         dfinal, h0)
            torch.cuda.synchronize()
            rel, abs_err = {}, 0.0
            for name, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"gru_bwd {label}: non-finite {name}")
                e = (g - w).abs().max().item()
                abs_err = max(abs_err, e)
                rel[name] = e / max(w.abs().max().item(), 1e-30)
            if not max(rel.values()) <= GRU_BWD_RTOL:
                raise AssertionError(f"gru_bwd {label}: relative errors {rel} "
                                     f"> {GRU_BWD_RTOL}")
            ms = cuda_ms(lambda: gk.gru_backward(gates, outs, lengths, w_h,
                                                 douts, dfinal, h0))
            plain = cuda_ms(lambda: gk.gru_backward_plain(
                gates, outs, lengths, w_h, douts, dfinal, h0), reps=3,
                warmup=1)
        library = library_gru_ms(torch, x, lengths_np, w_i, w_h, b_i, b_h,
                                 final, h0, mode="backward")
        bms, by = gru_bounds(b, t, h, live, seeded=seeded, backward=True)
        bwd_rows.append(dict(shape=label, max_abs_err=abs_err, ms=ms,
                             plain_ms=plain, bound_ms=bms, bound_by=by,
                             library_ms=library, seeded=seeded,
                             rel_err=rel))
        log(f"  2c gru_bwd{' +h0' if seeded else ''} {label}: rel err "
            + " ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  cuDNN bwd "
            f"{library:.4f} ms  bound {bms:.4f} ms ({by})")
        del xw, outs, final, gates, w_outs, w_final, w_gates, got, want
    return fwd_rows, bwd_rows


def phase_gru_bf16(torch, rng, enc_shapes, train_shapes,
                   h: int = 1024) -> dict:
    """2d: K1 in bf16 (encode variant at phase 2's shapes; save_gates and
    save_gates + with_h0 at 2b's) and K2 in bf16 (2c's shapes), each
    against its plain version in bf16 on the same inputs, with times,
    bounds in bf16 bytes at the bf16 tensor-core peak, and cuDNN's GRU in
    bf16 as the library yardstick. Returns rows per variant."""
    from cmhse_tpu_torch.models.gru import gru_input_projection
    from cmhse_tpu_torch.ops import gru_kernel as gk

    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    rows = {"encode": [], "save_gates": [], "save_gates_h0": [],
            "bwd": [], "bwd_h0": []}
    shapes = ([(label, lens, t, d, False, "encode")
               for label, lens, t, d in enc_shapes]
              + [(label, lens, t, d, seeded, "train")
                 for label, lens, t, d, seeded in train_shapes])
    for label, lengths_np, t, d, seeded, kind in shapes:
        b = lengths_np.shape[0]
        x, w_i, w_h, b_i, b_h = gru_inputs(torch, rng, b, t, d, h)
        gen = card_generator(torch, rng)
        h0 = ((torch.rand(b, h, device=dev, generator=gen) * 2 - 1).to(bf16)
              if seeded else None)
        lengths = torch.from_numpy(lengths_np).to(dev)
        live_mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
        live = int(lengths_np.clip(0, t).sum())
        save = kind == "train"
        with torch.no_grad():
            xw = gru_input_projection(x.to(bf16), w_i, b_i).contiguous()
            w_hb = w_h.to(bf16)
            got = gk.gru_forward(xw, w_hb, b_h, lengths, h0, save_gates=save)
            want = gk.gru_recurrence_plain(xw, w_hb, b_h, lengths, h0,
                                           save_gates=save)
            torch.cuda.synchronize()
            errs = [(got[0] - want[0]).abs().max().item(),
                    (got[1] - want[1]).abs().max().item()]
            if save and live:
                errs.append((got[2][live_mask].float()
                             - want[2][live_mask].float()).abs().max().item())
            err = max(errs)
            name = ("encode" if not save else
                    "save_gates_h0" if seeded else "save_gates")
            if not err <= BF16_ATOL:
                raise AssertionError(f"gru_fwd bf16 {name} {label}: max abs "
                                     f"err {err} > {BF16_ATOL}")
            ms = cuda_ms(lambda: gk.gru_forward(xw, w_hb, b_h, lengths, h0,
                                                save_gates=save))
            plain = cuda_ms(lambda: gk.gru_recurrence_plain(
                xw, w_hb, b_h, lengths, h0, save_gates=save), reps=3,
                warmup=1)
            library = library_gru_ms(
                torch, x, lengths_np, w_i, w_h, b_i, b_h, got[1], h0,
                mode="train" if save else "inference", dtype=bf16)
        bms, by = gru_bounds(b, t, h, live, gates=save, seeded=seeded,
                             bf16=True)
        rows[name].append(dict(shape=label, max_abs_err=err, ms=ms,
                               plain_ms=plain, bound_ms=bms, bound_by=by,
                               library_ms=library))
        log(f"  2d gru_fwd bf16 {name} {label}: err {err:.3g}  kernel "
            f"{ms:.4f} ms  plain {plain:.4f} ms  cuDNN bf16 "
            f"{'refused' if library is None else f'{library:.4f} ms'}  "
            f"bound {bms:.4f} ms ({by})")
        if not save:
            continue

        outs, final, gates = got
        douts = torch.randn(b, t, h, device=dev, generator=gen).to(bf16)
        dfinal = torch.randn(b, h, device=dev, generator=gen).to(bf16)
        with torch.no_grad():
            got = gk.gru_backward(gates, outs, lengths, w_hb, douts, dfinal,
                                  h0)
            want = gk.gru_backward_plain(gates, outs, lengths, w_hb, douts,
                                         dfinal, h0)
            torch.cuda.synchronize()
            rel, abs_err = {}, 0.0
            for part, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
                g, w = g.float(), w.float()
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"gru_bwd bf16 {label}: non-finite "
                                         f"{part}")
                abs_err = max(abs_err, (g - w).abs().max().item())
                rel[part] = ((g - w).norm() / w.norm().clamp_min(1e-30)
                             ).item()
            if not max(rel.values()) <= BF16_GRAD_RL2:
                raise AssertionError(f"gru_bwd bf16 {label}: relative L2 "
                                     f"errors {rel} > {BF16_GRAD_RL2}")
            ms = cuda_ms(lambda: gk.gru_backward(gates, outs, lengths, w_hb,
                                                 douts, dfinal, h0))
            plain = cuda_ms(lambda: gk.gru_backward_plain(
                gates, outs, lengths, w_hb, douts, dfinal, h0), reps=3,
                warmup=1)
        library = library_gru_ms(torch, x, lengths_np, w_i, w_h, b_i, b_h,
                                 final, h0, mode="backward", dtype=bf16)
        bms, by = gru_bounds(b, t, h, live, seeded=seeded, backward=True,
                             bf16=True)
        rows["bwd_h0" if seeded else "bwd"].append(dict(
            shape=label, max_abs_err=abs_err, ms=ms, plain_ms=plain,
            bound_ms=bms, bound_by=by, library_ms=library, rel_l2=rel))
        log(f"  2d gru_bwd bf16{' +h0' if seeded else ''} {label}: rel L2 "
            + " ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  cuDNN bf16 bwd "
            f"{'refused' if library is None else f'{library:.4f} ms'}  "
            f"bound {bms:.4f} ms ({by})")
    return rows


def exact_rows(rng, n: int, d: int):
    """l2-normalized rows on the card (from a seed drawn from ``rng``),
    rounded to multiples of 2**-10: every dot product is then exact in f32
    whatever the summation order, so kernel and plain counts must be equal,
    ties included."""
    import torch

    x = torch.randn(n, d, device="cuda",
                    generator=card_generator(torch, rng))
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return torch.round(x * 1024) / 1024


def phase_rankcount(torch, rng, shapes) -> list:
    from cmhse_tpu_torch.ops import rankcount_kernel as rk

    dev = torch.device("cuda")
    rows = []
    for q, n, d in shapes:
        queries = exact_rows(rng, q, d)
        gallery = exact_rows(rng, n, d)
        pos_idx = torch.from_numpy(rng.randint(0, n, q).astype("int32")).to(dev)
        valid = torch.from_numpy(rng.rand(n) > 0.03).to(dev)  # holes
        with torch.inference_mode():
            pos = (queries * gallery[pos_idx.long()]).sum(1)
            pos[q // 2] = float("nan")
            got = rk.violation_counts(queries, gallery, pos, valid, pos_idx)
            want = rk.violation_counts_plain(queries, gallery, pos, valid,
                                             pos_idx)
            n_diff = int((got != want).sum())
            if n_diff:
                raise AssertionError(f"rankcount Q={q} N={n}: {n_diff} counts "
                                     "differ from the plain version")
            ranks = rk.rank_counts(queries, gallery, pos, valid, pos_idx)
            if int(ranks[q // 2]) != int(valid.sum()):
                raise AssertionError("NaN positive did not rank worst")
            ms = cuda_ms(lambda: rk.violation_counts(queries, gallery, pos,
                                                     valid, pos_idx))
            plain = cuda_ms(lambda: rk.violation_counts_plain(
                queries, gallery, pos, valid, pos_idx), reps=5)
            library = cuda_ms(lambda: torch.matmul(queries, gallery.T))
        n_valid = int(valid.sum())
        bms, by = bound_ms(2.0 * q * n_valid * d,
                           rankcount_bytes(q, n, d, queries.element_size()))
        label = f"Q={q} N={n} D={d}"
        log(f"  rankcount {label}: counts equal  kernel {ms:.4f} ms  plain "
            f"{plain:.4f} ms  matmul {library:.4f} ms  bound {bms:.4f} ms "
            f"({by})")
        rows.append(dict(shape=label, max_abs_err=0.0, ms=ms, plain_ms=plain,
                         bound_ms=bms, bound_by=by, library_ms=library))
    return rows


def rankcount_bytes(q: int, n: int, d: int, itemsize: int) -> float:
    """Bytes a rank count must move: both operands in the type read, pos,
    posidx and the counts (4 bytes a query each), gvalid (1 a row)."""
    return itemsize * (q + n) * d + 12.0 * q + n


def kernel_resources(source: str) -> list[str]:
    """ptxas's registers, shared memory, stack and spills for each kernel
    of ``source`` in the build's log, one line a kernel."""
    import re

    from cmhse_tpu_torch.ops import cuda_lib

    log_text = cuda_lib.build_log()
    part = log_text.split(f"== {source} ", 1)[-1].split("\n== ", 1)[0]
    out, name = [], None
    for line in part.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, check=True).stdout.strip()
            except (OSError, subprocess.CalledProcessError):
                pass
        elif name and "spill" in line:
            short = name.replace("(anonymous namespace)::", "")
            short = short.removeprefix("void ").split("(")[0]
            out.append(f"{short}: {line.strip()}")
        elif name and "Used" in line:
            out[-1] += "; " + line.split(":", 1)[1].strip()
    return out


def phase_rankcount_lowp(torch, rng, q: int = 1024, n: int = 100_000,
                         d: int = 1024) -> list:
    """3d: the rankcount kernel's lowp branch (precision="bfloat16": both
    operands rounded to bf16, f32 accumulation) against its plain version,
    from bf16 operands (read as they are) and from f32 ones (rounded by the
    wrapper, the cast timed as part of the call). On exact-arithmetic rows
    the rounded products sum exactly in any order, so the counts must be
    equal; on random rows each count must lie in the near-tie band
    (RANK_TIE_TOL) of the plain version's dense block. Timed beside
    ``torch.matmul`` of the bf16 block (from f32 operands: with the same
    casts)."""
    from cmhse_tpu_torch.ops import rankcount_kernel as rk

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    queries = exact_rows(rng, q, d)
    gallery = exact_rows(rng, n, d)
    qb, gb = queries.to(bf16), gallery.to(bf16)
    pos_idx = torch.from_numpy(rng.randint(0, n, q).astype("int32")).to(dev)
    valid = torch.from_numpy(rng.rand(n) > 0.03).to(dev)
    n_valid = int(valid.sum())
    rows = []
    with torch.inference_mode():
        pos = (queries * gallery[pos_idx.long()]).sum(1)
        pos[q // 2] = float("nan")
        want = rk.violation_counts_plain(queries, gallery, pos, valid,
                                         pos_idx, precision="bfloat16")
        plain = cuda_ms(lambda: rk.violation_counts_plain(
            queries, gallery, pos, valid, pos_idx, precision="bfloat16"),
            reps=5)
        for label, a, b, library in (
                ("bf16 operands", qb, gb, lambda: torch.matmul(qb, gb.T)),
                ("f32 operands, cast included", queries, gallery,
                 lambda: torch.matmul(queries.to(bf16), gallery.to(bf16).T))):
            got = rk.violation_counts(a, b, pos, valid, pos_idx,
                                      precision="bfloat16")
            n_diff = int((got != want).sum())
            if n_diff:
                raise AssertionError(f"rankcount lowp ({label}): {n_diff} "
                                     "counts differ from the plain version "
                                     "on exact rows")
            ms = cuda_ms(lambda: rk.violation_counts(
                a, b, pos, valid, pos_idx, precision="bfloat16"))
            lib_ms = cuda_ms(library)
            bms, by = bound_ms(2.0 * q * n_valid * d,
                               rankcount_bytes(q, n, d, a.element_size()),
                               BF16_FLOPS)
            shape = f"Q={q} N={n} D={d}, {label}"
            rows.append(dict(shape=shape, max_abs_err=0.0, ms=ms,
                             plain_ms=plain, bound_ms=bms, bound_by=by,
                             library_ms=lib_ms))
            log(f"  rankcount lowp {shape}: counts equal on exact rows  "
                f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bf16 matmul "
                f"{lib_ms:.4f} ms  bound {bms:.4f} ms ({by})")

        # random rows: the kernel's count within the plain block's band,
        # from both operand types
        gen = card_generator(torch, rng)
        rq = torch.randn(q, d, device=dev, generator=gen)
        rg = torch.randn(n, d, device=dev, generator=gen)
        rq /= rq.norm(dim=1, keepdim=True)
        rg /= rg.norm(dim=1, keepdim=True)
        rpos = (rq * rg[pos_idx.long()]).sum(1)
        gq, gg = rq.to(bf16).float(), rg.to(bf16).float()
        lo, hi = [], []
        for s in range(0, q, 128):
            sims = gq[s:s + 128] @ gg.T
            sims[:, ~valid] = float("-inf")
            sims.scatter_(1, pos_idx[s:s + 128, None].long(), float("-inf"))
            p = rpos[s:s + 128, None]
            lo.append((sims > p + RANK_TIE_TOL).sum(1))
            hi.append((sims > p - RANK_TIE_TOL).sum(1))
        lo, hi = torch.cat(lo), torch.cat(hi)
        for a, b in ((rq, rg), (rq.to(bf16), rg.to(bf16))):
            got = rk.violation_counts(a, b, rpos, valid, pos_idx,
                                      precision="bfloat16")
            if not bool(((lo <= got) & (got <= hi)).all()):
                raise AssertionError("rankcount lowp: counts on random rows "
                                     "outside the plain block's near-tie "
                                     f"band ({a.dtype} operands)")
        n_band = int((lo != hi).sum())
    log(f"  rankcount lowp on random rows: within the +-{RANK_TIE_TOL} band "
        f"from both operand types ({n_band} queries have a score inside "
        "it)")
    return rows


def phase_simhinge(torch, rng, sizes, d: int = 1024) -> list:
    """3c: the simhinge kernel (both directions in one launch) against its
    plain version (two row passes), on exact-arithmetic rows, so maxima and
    argmaxes must be equal. Each size carries a tie at a row's maximum and
    at a column's (duplicate rows, the lowest index must win), a row with no
    negative, and a column with none; the ragged size fills no whole
    tile."""
    import numpy as np

    from cmhse_tpu_torch.ops import simhinge_kernel as sk

    dev = torch.device("cuda")
    rows = []
    for n in sizes:
        a = exact_rows(rng, n, d)
        p = exact_rows(rng, n, d)
        i1, i2 = 1, n - 2  # row 10's best negatives: two equal columns
        p[i2] = p[i1]
        a[10] = p[i1]
        j1, j2 = 7, n - 3  # column 20's best negatives: two equal rows
        a[j2] = a[j1]
        p[20] = a[j1]
        neg = rng.rand(n, n) > 0.3
        np.fill_diagonal(neg, False)
        neg[10, [i1, i2]] = True
        neg[[j1, j2], 20] = True
        neg[4] = False     # row 4 has no negative
        neg[:, 6] = False  # nor has column 6
        ta, tp, tneg = a, p, torch.from_numpy(neg).to(dev)
        with torch.inference_mode():
            diag = torch.sum(ta * tp, dim=1)
            got = sk.simhinge_pair(ta, tp, tneg, diag, diag, 0.2)
            want = sk.simhinge_pair_plain(ta, tp, tneg, diag, diag, 0.2)
            torch.cuda.synchronize()
            for name, g, w in zip(("row_max", "row_arg", "col_max",
                                   "col_arg"), got, want):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"simhinge n={n}: {int((g != w).sum())} of {name} "
                        f"differ, max err {(g - w).abs().max()}")
            if (int(got[1][10]), int(got[3][20])) != (i1, j1):
                raise AssertionError(f"simhinge ties went to {int(got[1][10])}"
                                     f" and {int(got[3][20])}")
            if not (got[0][4] == sk.NEG_INF and int(got[1][4]) == 0
                    and got[2][6] == sk.NEG_INF and int(got[3][6]) == 0):
                raise AssertionError("simhinge: a row or column with no "
                                     "negative")
            call_ms = cuda_ms(lambda: sk.simhinge_pair(ta, tp, tneg, diag,
                                                       diag, 0.2))
            ms = graph_ms(lambda: sk.simhinge_pair(ta, tp, tneg, diag, diag,
                                                   0.2))
            plain = graph_ms(lambda: sk.simhinge_pair_plain(
                ta, tp, tneg, diag, diag, 0.2))
            library = graph_ms(lambda: torch.matmul(ta, tp.T))
        n_neg = int(neg.sum())  # the products both directions' data need
        bms, by = bound_ms(2.0 * n_neg * d,
                           4.0 * (2 * n * d + n) + n * n + 16.0 * n)
        label = f"{n}x{n} D={d}"
        log(f"  simhinge {label}: maxima and argmaxes of both directions "
            f"equal (ties to the lowest index)  kernel {ms:.4f} ms (graph "
            f"replay; {call_ms:.4f} ms a call back to back)  plain "
            f"{plain:.4f} ms  matmul {library:.4f} ms  bound {bms:.4f} ms "
            f"({by})")
        rows.append(dict(shape=label, max_abs_err=0.0, ms=ms, plain_ms=plain,
                         bound_ms=bms, bound_by=by, library_ms=library,
                         call_ms=call_ms))
    return rows


def launch_counts() -> dict:
    """Every kernel wrapper's launches since the last
    ``cuda_lib.reset_launches()``, keyed "kernel dtype variant"."""
    from cmhse_tpu_torch.ops import cuda_lib

    return {" ".join(k): n for k, n in sorted(cuda_lib.launches.items())}


def total(counts: dict, prefix: str) -> int:
    """Launches of the keys of ``counts`` that start with ``prefix``."""
    return sum(n for k, n in counts.items() if k.startswith(prefix))


def reachable_cuda_tensors(torch, top: int = 4) -> str:
    """The CUDA tensors the garbage collector can reach: their total and
    the largest few (shape, dtype, MiB)."""
    import gc

    import warnings

    found = {}
    with warnings.catch_warnings():  # deprecated objects warn on isinstance
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if torch.is_tensor(obj) and obj.is_cuda:
                    found[obj.untyped_storage().data_ptr()] = obj
            except Exception:  # objects that refuse inspection
                continue
    sizes = sorted(((x.untyped_storage().nbytes(), tuple(x.shape), x.dtype)
                    for x in found.values()), key=lambda v: -v[0])
    largest = ", ".join(f"{list(s)} {str(d).removeprefix('torch.')} "
                        f"{n / 2**20:.1f} MiB" for n, s, d in sizes[:top])
    return (f"{sum(v[0] for v in sizes) / 2**30:.3f} GiB in {len(sizes)} "
            f"storages ({largest or 'none'})")


def train_setup(torch, seed: int, bf16: bool = False):
    """Phase 5's training set-up at full cmhse_full width (``bf16``:
    ``dtype`` and ``feature_dtype`` bfloat16): one fixed 64-video batch
    from the seed, the model's random weights, Adam at TRAIN_LR. Returns
    (cfg, model, state, batch)."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import create_train_state, set_learning_rate

    cfg = get_preset("cmhse_full")
    if bf16:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"),
            data=dataclasses.replace(cfg.data, feature_dtype="bfloat16"))
    dc, mc = cfg.data, cfg.model
    log(f"  dtype {mc.dtype} features {dc.feature_dtype} lr {TRAIN_LR} clip "
        f"{cfg.train.grad_clip} loss {cfg.loss}")
    ds = SyntheticHierarchicalDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=seed + 1)
    batch = next(batches_from_dataset(ds, dc, shuffle=False))
    model = CMHSE(mc, dc.vocab_size,
                  generator=torch.Generator().manual_seed(seed))
    state = set_learning_rate(create_train_state(cfg, model), TRAIN_LR)
    return cfg, model, state, batch


def step_memory(torch, state, batch, loss_cfg, top: int = 6) -> dict:
    """Device memory of one ``train_step``: the bytes allocated at its
    start (parameters, Adam's state, whatever else is alive), its peak
    (``torch.cuda.max_memory_allocated()``), and what is live at that peak.
    The allocator's trace of the step (``torch.cuda.memory`` history,
    Python frames only) is replayed to the peak; the blocks live there are
    summed by the innermost frame in the port that allocated them. Returns
    dict(start, peak, sites=[(site, bytes), ...] largest first)."""
    from cmhse_tpu_torch.train import train_step

    mem = torch.cuda.memory
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mem._record_memory_history(max_entries=1_000_000, stacks="python")
    try:
        train_step(state, batch, loss_cfg)
        torch.cuda.synchronize()
        trace = mem._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        mem._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()

    def site(frames):
        for f in frames:
            if "cmhse_tpu_torch" in f["filename"]:
                path = f["filename"].split("cmhse_tpu_torch")[-1]
                return f"cmhse_tpu_torch{path}:{f['line']} {f['name']}"
        return "outside the port"

    live, cur, best = {}, start, (start, {})
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], site(ev["frames"]))
            cur += ev["size"]
            if cur > best[0]:
                best = (cur, dict(live))
        elif ev["action"] == "free_requested":
            cur -= ev["size"]
            live.pop(ev["addr"], None)
    sites = {}
    for size, where in best[1].values():
        sites[where] = sites.get(where, 0) + size
    ranked = sorted(sites.items(), key=lambda kv: -kv[1])[:top]
    return dict(start=start, peak=peak, sites=ranked)


def log_step_memory(m: dict) -> None:
    log(f"  one step's device memory: {m['start'] / 2**30:.3f} GiB at its "
        f"start, peak {m['peak'] / 2**30:.3f} GiB; live at the peak and "
        f"allocated in the step, by site:")
    for where, size in m["sites"]:
        log(f"    {size / 2**20:10.1f} MiB  {where}")


def phase_train(torch, np, seed: int, bf16: bool = False) -> dict:
    """5 (f32) and 5d (``bf16``: ``dtype`` and ``feature_dtype`` bfloat16):
    the training path at full cmhse_full width: TRAIN_STEPS
    ``train_step``s on one fixed 64-video batch (handed over from the host
    each step, as a loader would), then ``validate_metrics(streaming=True)``
    on that batch with the trained weights. Launch counts are read after
    the steps and after the validation; a bf16 step must launch only the
    bf16 GRU kernels. Then one more step's device memory
    (``step_memory``), outside the counts."""
    from cmhse_tpu_torch.eval import format_table, validate_metrics
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.train import train_step

    log(f"  allocated before the set-up (earlier phases): "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, of which CUDA "
        f"tensors reachable from Python: {reachable_cuda_tensors(torch)}")
    cfg, model, state, batch = train_setup(torch, seed, bf16)
    mc = cfg.model
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    losses, norms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, cfg.loss)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        log(f"  step {i + 1}: {step_ms[-1]:.2f} ms  "
            + "  ".join(f"{k} {v:.6f}" for k, v in m.items()))
    step_counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    val = validate_metrics(model, [batch], streaming=True)
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    counts = launch_counts()
    memory = step_memory(torch, state, batch, cfg.loss)
    log(f"  median step {float(np.median(step_ms)):.3f} ms over "
        f"{TRAIN_STEPS} steps (first {step_ms[0]:.3f} ms); peak device "
        f"memory {peak_gib:.2f} GiB; validate_metrics(streaming) on the "
        f"trained weights: {t_val * 1e3:.1f} ms")
    log_step_memory(memory)
    log(format_table(val))
    log(f"  launches in {TRAIN_STEPS} steps: {step_counts}; with the "
        f"validation: {counts}")

    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if not all(np.isfinite(x) for x in val.values()):
        raise AssertionError(f"non-finite metrics {val}")
    dt = mc.dtype  # only this element type's GRU kernels may launch
    want = {f"gru_fwd {dt} save_gates": 4,
            f"gru_fwd {dt} save_gates+with_h0": 2,
            f"gru_bwd {dt} zero_h0": 4, f"gru_bwd {dt} with_h0": 2,
            "simhinge float32 pair": 2}
    got = {k: v / TRAIN_STEPS for k, v in step_counts.items()}
    if got != want:
        raise AssertionError(f"launches per step {got}, expected {want}")
    return dict(counts=counts, state=state, batch=batch, loss_cfg=cfg.loss)


def phase_train_breakdown(torch, state, batch, loss_cfg) -> None:
    """5b: where one train step's device time goes (torch.profiler), by
    kernel family, and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from cmhse_tpu_torch.train import train_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, loss_cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"gru_fwd": 0.0, "gru_bwd": 0.0, "simhinge": 0.0,
                "matrix products": 0.0, "copies": 0.0, "other kernels": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.key.startswith("Activity Buffer"):
            continue
        us = e.self_device_time_total
        key = e.key.lower()
        if "gru_fwd" in key:
            families["gru_fwd"] += us
        elif "gru_bwd" in key:
            families["gru_bwd"] += us
        elif "simhinge" in key:
            families["simhinge"] += us
        elif any(w in key for w in ("gemm", "gemv", "xmma", "cutlass")):
            families["matrix products"] += us
        elif key.startswith(("memcpy", "memset")) or "copy" in key:
            families["copies"] += us
        else:
            families["other kernels"] += us
    busy_ms = sum(families.values()) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"  one step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for name, us in families.items():
        log(f"    {name}: {us / 1e3:.3f} ms ({100 * us / 1e3 / busy_ms:.1f}%)")


def phase_train_parity(torch, np, seed: int) -> None:
    """5c: one step's loss, grad_norm and every parameter gradient on a
    batch of 8 videos at full width, card against the CPU plain path from
    the same weights. Gradients, not post-step weights: Adam's first step
    is about lr * sign(g), so a weight whose gradient is near 0 may move
    either way."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import global_norm, total_loss

    cfg = get_preset("cmhse_full")
    dc = dataclasses.replace(cfg.data, batch_size=8)
    ds = SyntheticHierarchicalDataset(
        num_videos=8, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
        max_clips=dc.max_clips, max_frames=dc.max_frames,
        max_words=dc.max_words, seed=seed + 2)
    host = next(batches_from_dataset(ds, dc, shuffle=False))
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = CMHSE(cfg.model, dc.vocab_size, device=dev,
                      generator=torch.Generator().manual_seed(seed))
        b = host.to(dev)
        loss, metrics = total_loss(model(b), b, cfg.loss)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).cpu()
                 for k, p in model.named_parameters()}
        res[dev] = dict(loss=loss.item(), grads=grads,
                        norm=global_norm(list(grads.values())).item(),
                        metrics={k: v.item() for k, v in metrics.items()},
                        s=time.perf_counter() - t0)
    card, cpu = res["cuda"], res["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_rel = abs(card["norm"] - cpu["norm"]) / abs(cpu["norm"])
    grad_rel = {k: float((g - cpu["grads"][k]).abs().max()
                         / cpu["grads"][k].abs().max().clamp_min(1e-30))
                for k, g in card["grads"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"  batch 8: card {card['metrics']} grad_norm {card['norm']:.6f}; "
        f"CPU {cpu['metrics']} grad_norm {cpu['norm']:.6f} "
        f"({cpu['s']:.1f} s on the CPU)")
    log(f"  loss rel err {loss_rel:.3g} (limit {TRAIN_LOSS_RTOL}), grad_norm "
        f"{norm_rel:.3g} (limit {TRAIN_NORM_RTOL}), worst of "
        f"{len(grad_rel)} gradients {worst} {grad_rel[worst]:.3g} (limit "
        f"{TRAIN_GRAD_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL
            and grad_rel[worst] <= TRAIN_GRAD_RTOL):
        raise AssertionError("card and CPU train steps differ")


def leaf_bands(got: dict, want: dict, want32: dict) -> tuple:
    """Each parameter gradient's error against its band, as a share of it
    (<= 1 passes), as tests/test_torch_bf16.py holds the port to JAX. A
    parameter bf16 determines (its bf16 and f32 reference gradients within
    DETERMINED): relative L2 within BF16_GRAD_RL2 plus three times that
    spread (at most 0.32, so a zero or sign-flipped gradient fails). Any
    other (only the attention pools': near-cancelling sums that bf16
    rounding alone moves by 20-340%): max abs error within BF16_ULP of the
    largest gradient entry of its encoder stage. Returns (shares of the
    determined, shares of the others)."""
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    spread = {k: rel(want[k], want32[k]) for k in want}
    loose = {k for k, v in spread.items() if v > DETERMINED}
    if not all(".attn_pool." in k for k in loose):
        raise AssertionError(f"bf16 leaves these gradients undetermined: "
                             f"{sorted(loose)}")
    stage = {}
    for k, w in want.items():
        name = k.split(".")[0]
        stage[name] = max(stage.get(name, 0.0), float(w.abs().max()))
    tight = {k: rel(got[k], want[k]) / (BF16_GRAD_RL2 + 3 * spread[k])
             for k in want if k not in loose}
    rest = {k: float((got[k] - want[k]).abs().max())
            / (BF16_ULP * max(stage[k.split(".")[0]], 1e-30)) for k in loose}
    return tight, rest


def phase_train_parity_bf16(torch, np, seed: int) -> dict:
    """5d: one bf16 step at batch 8, full width, card against the CPU's
    plain path from the same weights, on PARITY_BF16_SEEDS batches. At
    random init the similarities nearly tie, so a bf16 ulp may change a
    hardest negative, which sends a row's gradient elsewhere; the gradients
    are therefore compared with the negatives pinned to the CPU's bf16
    picks on both sides (``total_loss_at``), in the bands of
    tests/test_torch_bf16.py: loss within rtol 1e-2, all gradients
    together within relative L2 2e-2, each as ``leaf_bands`` says. On the
    card the pinned objective at its own picks must give the objective's
    gradients (through the simhinge kernel) within CONSISTENT. Counts how
    often the card's picks differ from the CPU's, and the CPU's bf16 picks
    from its f32 ones."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import (hardest_negatives, total_loss,
                                       total_loss_at)

    cfg = get_preset("cmhse_full")
    dc = dataclasses.replace(cfg.data, batch_size=8,
                             feature_dtype="bfloat16")

    def grads(model, loss, retain=False):
        named = list(model.named_parameters())
        gs = torch.autograd.grad(loss, [p for _, p in named],
                                 retain_graph=retain, allow_unused=True)
        return {k: (torch.zeros_like(p) if g is None else g).float().cpu()
                for (k, p), g in zip(named, gs)}

    def rel_all(a, b):
        keys = sorted(b)
        x = torch.cat([a[k].ravel() for k in keys])
        y = torch.cat([b[k].ravel() for k in keys])
        return float((x - y).norm() / y.norm().clamp_min(1e-30))

    worst = dict(loss=0.0, consistency=0.0, all=0.0, determined=("", 0.0),
                 pools=("", 0.0))
    n_queries = n_card_cpu = n_bf16_f32 = 0
    cpu_s = 0.0
    runs = (("cpu", "bfloat16"), ("cuda", "bfloat16"), ("cpu", "float32"))
    models = {run: CMHSE(dataclasses.replace(cfg.model, dtype=run[1]),
                         dc.vocab_size, device=run[0],
                         generator=torch.Generator().manual_seed(seed))
              for run in runs}
    for k in range(PARITY_BF16_SEEDS):
        ds = SyntheticHierarchicalDataset(
            num_videos=8, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
            max_clips=dc.max_clips, max_frames=dc.max_frames,
            max_words=dc.max_words, seed=seed + 2 + k)
        host = next(batches_from_dataset(ds, dc, shuffle=False))
        res, ref = {}, None
        for dev, dtype in runs:
            t0 = time.perf_counter()
            model = models[(dev, dtype)]
            b = host.to(dev)
            out = model(b)
            loss, _ = total_loss(out, b, cfg.loss)
            own = hardest_negatives(out, b, cfg.loss)
            ref = ref or [p.cpu() for p in own]  # the CPU's bf16 picks
            r = dict(loss=loss.item(), picks=[p.cpu() for p in own])
            if dev == "cuda":
                r["real"] = grads(model, loss, retain=True)
                r["own"] = grads(model, total_loss_at(out, b, cfg.loss, own),
                                 retain=True)
            r["pinned"] = grads(model, total_loss_at(
                out, b, cfg.loss, [p.to(dev) for p in ref]))
            res[(dev, dtype)] = r
            if dev == "cpu":
                cpu_s += time.perf_counter() - t0
        card, cpu, f32 = (res[("cuda", "bfloat16")], res[("cpu", "bfloat16")],
                          res[("cpu", "float32")])
        n_queries += sum(int((p >= 0).sum()) for p in cpu["picks"])
        n_card_cpu += sum(int((a != b).sum())
                          for a, b in zip(card["picks"], cpu["picks"]))
        n_bf16_f32 += sum(int((a != b).sum())
                          for a, b in zip(cpu["picks"], f32["picks"]))
        tight, rest = leaf_bands(card["pinned"], cpu["pinned"],
                                 f32["pinned"])
        worst["loss"] = max(worst["loss"], abs(card["loss"] - cpu["loss"])
                            / abs(cpu["loss"]))
        worst["consistency"] = max(worst["consistency"],
                                   rel_all(card["own"], card["real"]))
        worst["all"] = max(worst["all"], rel_all(card["pinned"],
                                                 cpu["pinned"]))
        for key, shares in (("determined", tight), ("pools", rest)):
            if shares:
                name = max(shares, key=shares.get)
                if shares[name] > worst[key][1]:
                    worst[key] = (name, shares[name])
    log(f"  batch 8, bf16, {PARITY_BF16_SEEDS} batches ({cpu_s:.1f} s on the "
        f"CPU): hardest negatives that differ, card vs CPU {n_card_cpu} of "
        f"{n_queries}; CPU bf16 vs CPU f32 {n_bf16_f32} of {n_queries}")
    log(f"  worst: loss rel err {worst['loss']:.3g} (limit 1e-2); pinned vs "
        f"searched negatives on the card, all gradients rel L2 "
        f"{worst['consistency']:.3g} (limit {CONSISTENT}); card vs CPU, "
        f"negatives pinned: all gradients rel L2 {worst['all']:.3g} (limit "
        f"{BF16_GRAD_RL2}), against its band {worst['determined'][0]} "
        f"{worst['determined'][1]:.3g}, attention pools "
        f"{worst['pools'][0]} {worst['pools'][1]:.3g} (limit 1)")
    if not (worst["loss"] <= 1e-2 and worst["consistency"] <= CONSISTENT
            and worst["all"] <= BF16_GRAD_RL2
            and worst["determined"][1] <= 1.0 and worst["pools"][1] <= 1.0):
        raise AssertionError("card and CPU bf16 train steps differ")
    return dict(queries=n_queries, card_vs_cpu=n_card_cpu,
                bf16_vs_f32=n_bf16_f32)


def stack_batches(np, batches):
    """One ``[K, B, ...]`` batch from K host batches of one shape (the
    loader's grouping for ``steps_per_dispatch`` K)."""
    import dataclasses

    from cmhse_tpu_torch.data import Batch

    return Batch(**{f.name: np.stack([getattr(b, f.name) for b in batches])
                    for f in dataclasses.fields(Batch)})


def compare_states(torch, a: dict, b: dict) -> dict:
    """Two train states tensor by tensor, each a ``TrainState.state_dict()``
    or a checkpoint's payload: every parameter and Adam's two moments.
    Returns dict(worst=(name, largest |a - b| over the tensor's largest
    |entry|), bitwise=all equal, max_abs={name: largest |a - b|},
    steps=(a's step, b's step))."""
    def tensors(sd):
        moments = sd["optimizer"]["state"]
        out = {}
        for i, (name, p) in enumerate(sd["model"].items()):
            out[name] = p
            out[name + " exp_avg"] = moments[i]["exp_avg"]
            out[name + " exp_avg_sq"] = moments[i]["exp_avg_sq"]
        return out

    ta, tb = tensors(a), tensors(b)
    max_abs, rel, bitwise = {}, {}, True
    for k, x in ta.items():
        y = tb[k].to(x.device)
        d = (x.float() - y.float()).abs().max().item()
        max_abs[k] = d
        rel[k] = d / max(x.float().abs().max().item(), 1e-30)
        bitwise &= bool(torch.equal(x, y))
    worst = max(rel, key=rel.get)
    return dict(worst=(worst, rel[worst]), bitwise=bitwise, max_abs=max_abs,
                steps=(int(a["step"]), int(b["step"])))


def phase_graph_probe(torch, np, seed: int) -> dict:
    """6a: can one train step be captured in a CUDA graph on this card?
    ``train_steps`` over two stacked batches of 8 videos at full width,
    dispatched twice (the first runs eagerly and captures, the second
    replays the graph), against four ``train_step``s from the same
    weights: every parameter and Adam moment within STATE_RTOL of its
    largest entry."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import (create_train_state, train_step,
                                       train_steps)

    cfg = get_preset("cmhse_full")
    dc = dataclasses.replace(cfg.data, batch_size=8)
    ds = SyntheticHierarchicalDataset(
        num_videos=16, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
        max_clips=dc.max_clips, max_frames=dc.max_frames,
        max_words=dc.max_words, seed=seed + 3)
    host = list(batches_from_dataset(ds, dc, shuffle=False))
    stacked = stack_batches(np, host)
    states = {}
    for mode in ("graph", "eager"):
        model = CMHSE(cfg.model, dc.vocab_size,
                      generator=torch.Generator().manual_seed(seed))
        state = create_train_state(cfg, model)
        losses = []
        for _ in range(2):
            if mode == "graph":
                state, m = train_steps(state, stacked, cfg.loss)
                losses += m["loss"].tolist()
            else:
                for b in host:
                    state, m = train_step(state, b, cfg.loss)
                    losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        states[mode] = state
        log(f"  {mode}: losses {losses}")
    cmp = compare_states(torch, states["graph"].state_dict(),
                         states["eager"].state_dict())
    log(f"  train_steps (K=2) replayed a graph {states['graph'].graph_replays}"
        f" time(s); against 4 train_steps: steps {cmp['steps']}, bitwise "
        f"equal {cmp['bitwise']}, worst {cmp['worst'][0]} "
        f"{cmp['worst'][1]:.3g} of its largest entry (limit {STATE_RTOL})")
    if states["graph"].graph_replays != 1:
        raise AssertionError("train_steps did not replay its graph")
    if not cmp["worst"][1] <= STATE_RTOL or cmp["steps"] != (4, 4):
        raise AssertionError("the graph's steps differ from train_step's")
    return cmp


def serve(torch, np, model, batches, qb, picks) -> dict:
    """Encode -> serve both directions -> validate, with the checks of the
    served answers: encode the gallery (``encode_gallery_device``), answer
    REQUESTS text->video and video->text top-10 requests for the 8 videos
    ``picks`` (query batch ``qb``), score with
    ``validate_metrics(streaming=True)``. Checks: shape and finite values,
    served top-k against the gallery's own f32 product, streaming ranks
    against the dense block's near-tie band."""
    from cmhse_tpu_torch.eval import (Retriever, encode_gallery_device,
                                      format_table, validate_metrics)
    from cmhse_tpu_torch.ops.ranking import bidirectional_metrics
    from cmhse_tpu_torch.ops.similarity import cosine_sim
    from cmhse_tpu_torch.ops.topk import topk_lowest_index

    n_videos = sum(int(np.asarray(b.valid).sum()) for b in batches)
    t0 = time.perf_counter()
    encoded = encode_gallery_device(model, batches)
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    v, p, valid = encoded
    videos = Retriever(model)
    videos.build_gallery(encoded=encoded, side="video")
    texts = Retriever(model)
    texts.build_gallery(encoded=encoded, side="text")
    req_ms = {"text": [], "video": []}
    for _ in range(REQUESTS):  # answers come back as numpy: each call syncs
        t0 = time.perf_counter()
        t2v_scores, t2v_idx = videos.retrieve(qb.words, qb.word_len,
                                              qb.sent_len, k=10)
        req_ms["text"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        v2t_scores, v2t_idx = texts.retrieve_video(qb.frames, qb.frame_len,
                                                   qb.clip_len, k=10)
        req_ms["video"].append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    metrics, ranks = validate_metrics(model, batches, streaming=True,
                                      return_ranks=True)
    torch.cuda.synchronize()
    t_validate = time.perf_counter() - t0
    log(f"  encode {n_videos} videos ({v.dtype}): {t_encode:.3f} s "
        f"({n_videos / t_encode:.1f} videos/s); validate_metrics(streaming, "
        f"re-encode + rank): {t_validate:.3f} s")
    for side, ms in req_ms.items():
        log(f"  {side} request (8 queries, k=10): first {ms[0]:.2f} ms, "
            f"median of the next {len(ms) - 1}: "
            f"{float(np.median(ms[1:])):.2f} ms")
    for name, idx in (("text->video", t2v_idx), ("video->text", v2t_idx)):
        for row, i in zip(idx, picks):
            log(f"  {name} query {i}: {row.tolist()}")
    log(format_table(metrics))

    # ---- checks -----------------------------------------------------------
    if tuple(v.shape) != (n_videos, model.cfg.embed_size) or \
            not bool(valid.all()):
        raise AssertionError(f"gallery shape {tuple(v.shape)}")
    if not (torch.isfinite(v).all() and torch.isfinite(p).all()):
        raise AssertionError("non-finite embeddings")
    for name, scores, idx, qside, gside in (
            ("text->video", t2v_scores, t2v_idx, p, v),
            ("video->text", v2t_scores, v2t_idx, v, p)):
        ref = (qside[torch.as_tensor(picks, device=qside.device)].float()
               @ gside.float().T)
        want_s, want_i = topk_lowest_index(ref, 10)
        got_i = torch.as_tensor(idx, device=ref.device)
        got_ref = torch.gather(ref, 1, got_i)
        err = max(float(np.abs(scores - want_s.cpu().numpy()).max()),
                  float(np.abs(scores - got_ref.cpu().numpy()).max()))
        if not err <= SCORE_ATOL:
            raise AssertionError(f"{name}: served top-k off by {err}")
        # an index may differ from the reference's only where its score lies
        # within the near-tie band of the reference's score at that place
        moved = got_i != want_i
        gap = float((got_ref - want_s).abs()[moved].max()) if moved.any() \
            else 0.0
        if not gap <= RANK_TIE_TOL:
            raise AssertionError(f"{name}: served index off the reference's "
                                 f"top-10 by a score gap of {gap}")
        log(f"  {name} top-10 vs the gallery's own product: "
            f"{int(moved.sum())} of {moved.numel()} indices differ (largest "
            f"gap {gap:.3g}, limit {RANK_TIE_TOL}); scores within {err:.3g}")
    # The streaming ranks come from the kernel's own product; the dense path
    # sums in another order, so a rank may differ where another item's score
    # lies within float32 noise of the positive's. Each streaming rank must
    # lie in [1 + #(s > pos + tol), 1 + #(s > pos - tol)] of the dense block.
    sims = cosine_sim(v, p)
    dense = bidirectional_metrics(sims, return_ranks=True)
    n_rank_diff = 0
    for key, s in (("v2p_ranks", sims), ("p2v_ranks", sims.T)):
        check_rank_band(torch, ranks[key], s, key)
        got = torch.as_tensor(ranks[key], device=s.device)
        n_rank_diff += int((dense[key] != got).sum())
    log(f"  streaming vs dense ranks: {n_rank_diff} of {2 * n_videos} differ, "
        f"all within the +-{RANK_TIE_TOL} near-tie band")
    if not all(np.isfinite(x) for x in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    return dict(encoded=encoded, metrics=metrics, sims=sims)


def check_rank_band(torch, ranks, sims, key: str) -> None:
    """Each rank (1-based, of the diagonal's score in its row of ``sims``)
    must lie in [1 + #(s > pos + tol), 1 + #(s > pos - tol)]."""
    got = torch.as_tensor(ranks, device=sims.device)
    pos = torch.diagonal(sims)[:, None]
    lo = 1 + (sims > pos + RANK_TIE_TOL).sum(1)
    hi = 1 + (sims > pos - RANK_TIE_TOL).sum(1)
    if not bool(((lo <= got) & (got <= hi)).all()):
        raise AssertionError(f"{key}: ranks outside the dense near-tie band")


def serving_data(torch, np, seed: int, n_videos: int):
    """Phase 4's synthetic gallery batches (made on the host, timed as
    set-up), the 8 picked videos and their query batch."""
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset, pad_batch)
    from cmhse_tpu_torch.data.bucketing import BucketSpec

    dc = get_preset("cmhse_full").data
    ds = SyntheticHierarchicalDataset(
        num_videos=n_videos, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
        max_clips=dc.max_clips, max_frames=dc.max_frames,
        max_words=dc.max_words, seed=seed)
    t0 = time.perf_counter()
    batches = list(batches_from_dataset(ds, dc, shuffle=False))
    log(f"  synthetic data, {len(batches)} padded batches (host): "
        f"{time.perf_counter() - t0:.3f} s")
    picks = np.linspace(0, n_videos - 1, 8).astype(int)
    spec = BucketSpec(8, dc.max_clips, dc.max_frames, dc.max_sentences,
                      dc.max_words, dc.feat_dim)
    qb = pad_batch([ds[int(i)] for i in picks], spec)
    return batches, picks, qb


def phase_main_path(torch, np, seed: int, n_videos: int) -> dict:
    """4: encode -> serve both directions -> validate, at cmhse_full width,
    in f32; the first batch re-encoded on the CPU must agree."""
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.eval.encode import encode_batch
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.ops import cuda_lib

    cfg = get_preset("cmhse_full")
    dc, mc = cfg.data, cfg.model
    log(f"  config cmhse_full: vocab {dc.vocab_size} word_dim {mc.word_dim} "
        f"feat {mc.feat_dim} H {mc.rnn_hidden} E {mc.embed_size} Cmax "
        f"{dc.max_clips} Fmax {dc.max_frames} Smax {dc.max_sentences} Wmax "
        f"{dc.max_words} batch {dc.batch_size} attention_pool "
        f"{mc.attention_pool}")
    batches, picks, qb = serving_data(torch, np, seed, n_videos)
    model = CMHSE(mc, dc.vocab_size,
                  generator=torch.Generator().manual_seed(seed))
    cuda_lib.reset_launches()
    out = serve(torch, np, model, batches, qb, picks)
    counts = launch_counts()
    log(f"  launches on the main path: {counts}")
    if set(counts) != {"gru_fwd float32 encode", "rankcount float32 f32"}:
        raise AssertionError(f"serving launches {counts}")
    v, p, _ = out["encoded"]
    first = batches[0]
    cpu_model = CMHSE(mc, dc.vocab_size, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    cv, cp, _, _ = encode_batch(cpu_model, first)
    t_cpu = time.perf_counter() - t0
    err = max((cv - v[:dc.batch_size].cpu()).abs().max().item(),
              (cp - p[:dc.batch_size].cpu()).abs().max().item())
    log(f"  first batch, card vs CPU (plain versions, {t_cpu:.1f} s): max abs "
        f"err {err:.3g} (limit {ENCODE_ATOL})")
    if not err <= ENCODE_ATOL:
        raise AssertionError(f"card and CPU embeddings differ by {err}")
    return dict(counts=counts, model=model, batches=batches, picks=picks,
                qb=qb, encoded=out["encoded"])


def phase_serving_bf16(torch, np, f32: dict) -> dict:
    """4c: the serving path of the bf16 configuration (``dtype`` and
    ``feature_dtype`` bfloat16) at full width, on phase 4's weights and
    synthetic batches (their frames rounded to bf16 on the host, as
    ``pad_batch`` rounds them: set-up, not timed). Then the bf16-multiply
    rank count (``precision="bfloat16"``) over the bf16 gallery, whose
    ranks must lie in the f32 count's near-tie band. The first batch is
    re-encoded on the CPU in bf16 (plain versions) and must agree within
    BF16_ATOL; all embeddings are held against phase 4's f32 model on the
    same weights."""
    import dataclasses

    from cmhse_tpu_torch.eval.encode import encode_batch
    from cmhse_tpu_torch.eval.retrieval import streaming_bidirectional_metrics
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.ops import cuda_lib

    f32_model = f32["model"]
    mc = dataclasses.replace(f32_model.cfg, dtype="bfloat16")
    model = CMHSE(mc, f32_model.vocab_size)
    model.load_state_dict(f32_model.state_dict())
    t0 = time.perf_counter()
    batches = [dataclasses.replace(
        b, frames=torch.from_numpy(b.frames).to(torch.bfloat16))
        for b in f32["batches"]]
    qb = f32["qb"]
    qb = dataclasses.replace(qb, frames=torch.from_numpy(qb.frames).to(
        torch.bfloat16))
    log(f"  frames rounded to bf16 on the host: "
        f"{time.perf_counter() - t0:.3f} s")
    cuda_lib.reset_launches()
    out = serve(torch, np, model, batches, qb, f32["picks"])
    v, p, valid = out["encoded"]
    with torch.inference_mode():
        lowp = streaming_bidirectional_metrics(v, p, valid=valid,
                                               return_ranks=True,
                                               precision="bfloat16")
    for key, s in (("v2p_ranks", out["sims"]), ("p2v_ranks", out["sims"].T)):
        check_rank_band(torch, lowp[key], s, f"lowp {key}")
    counts = launch_counts()
    log(f"  lowp rank count over the bf16 gallery: rsum "
        f"{float(lowp['rsum']):.1f} (f32 count {out['metrics']['rsum']:.1f}),"
        f" ranks within the +-{RANK_TIE_TOL} band of the dense block")
    log(f"  launches on the bf16 serving path: {counts}")
    if set(counts) != {"gru_fwd bfloat16 encode", "rankcount float32 f32",
                       "rankcount bfloat16 lowp"}:
        raise AssertionError(f"bf16 serving launches {counts}")
    # the same weights in f32: one GRU stack rounds at every bf16 point
    fv, fp, _ = f32["encoded"]
    err = max((v.float() - fv).abs().max().item(),
              (p.float() - fp).abs().max().item())
    cos = min(torch.nn.functional.cosine_similarity(v.float(), fv).min()
              .item(), torch.nn.functional.cosine_similarity(p.float(), fp)
              .min().item())
    log(f"  bf16 vs f32 embeddings, same weights: max abs err {err:.3g} "
        f"(limit {BF16_EMB_ATOL}), lowest cosine {cos:.6f} (limit "
        f"{BF16_EMB_COS})")
    if not (err <= BF16_EMB_ATOL and cos >= BF16_EMB_COS):
        raise AssertionError("bf16 embeddings stray from the f32 model's")
    cpu_model = CMHSE(mc, f32_model.vocab_size, device="cpu")
    cpu_model.load_state_dict(f32_model.state_dict())
    t0 = time.perf_counter()
    with torch.inference_mode():
        cv, cp, _, _ = encode_batch(cpu_model, batches[0])
    t_cpu = time.perf_counter() - t0
    n = batches[0].frames.shape[0]
    err = max((cv.float() - v[:n].float().cpu()).abs().max().item(),
              (cp.float() - p[:n].float().cpu()).abs().max().item())
    log(f"  first batch in bf16, card vs CPU (plain versions, {t_cpu:.1f} "
        f"s): max abs err {err:.3g} (limit {BF16_ATOL})")
    if not err <= BF16_ATOL:
        raise AssertionError(f"card and CPU bf16 embeddings differ by {err}")
    return dict(counts=counts, model=model, batches=batches)


def encode_pageable(torch, model, batches):
    """The encode as it ran before the prefetch: each batch copied from
    pageable host memory by ``Batch.to`` on the compute stream, then
    encoded."""
    from cmhse_tpu_torch.eval.encode import encode_batch

    out = [encode_batch(model, b) for b in batches]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def profile_families(torch, fn) -> dict:
    """torch.profiler over ``fn()``: wall and device-busy ms, device time
    by kernel family, and the streams the host-to-device copies and the
    ``gru_fwd`` kernels ran on (None where the profiler gives no stream)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"gru_fwd": 0.0, "host-to-device copy": 0.0,
                "matrix products": 0.0, "other kernels": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.key.startswith("Activity Buffer"):
            continue  # host-side ops, and the profiler's own buffer
        us = e.self_device_time_total
        if "gru_fwd" in e.key:
            families["gru_fwd"] += us
        elif e.key.startswith("Memcpy HtoD"):
            families["host-to-device copy"] += us
        elif any(w in e.key for w in ("gemm", "gemv", "xmma")):
            families["matrix products"] += us
        else:
            families["other kernels"] += us
    streams = {"copy": set(), "gru_fwd": set()}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        sid = getattr(e, "device_resource_id", None)
        if e.name.startswith("Memcpy HtoD"):
            streams["copy"].add(sid)
        elif "gru_fwd" in e.name:
            streams["gru_fwd"].add(sid)
    busy_ms = sum(families.values()) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, families=families,
                streams=streams)


def phase_breakdown(torch, model, batches) -> None:
    """Where the encode's device time goes: torch.profiler over two
    full-width batches through ``encode_gallery_device`` (the prefetch),
    device time summed by kernel family; in brackets the same two batches
    through the pageable ``Batch.to`` path. Checks that the prefetch's
    host-to-device copies left the compute stream."""
    from cmhse_tpu_torch.eval import encode_gallery_device

    runs = {"prefetch": profile_families(
                torch, lambda: encode_gallery_device(model, batches[:2])),
            "pageable": profile_families(
                torch, lambda: encode_pageable(torch, model, batches[:2]))}
    new, old = runs["prefetch"], runs["pageable"]
    log(f"  2 batches: wall {new['wall_ms']:.3f} ms [{old['wall_ms']:.3f}], "
        f"device busy {new['busy_ms']:.3f} ms [{old['busy_ms']:.3f}] "
        f"({100 * new['busy_ms'] / new['wall_ms']:.1f}% "
        f"[{100 * old['busy_ms'] / old['wall_ms']:.1f}%])")
    for name, us in new["families"].items():
        was = old["families"][name]
        log(f"    {name}: {us / 1e3:.3f} ms "
            f"({100 * us / 1e3 / new['busy_ms']:.1f}%) [{was / 1e3:.3f} ms, "
            f"{100 * was / 1e3 / old['busy_ms']:.1f}%]")
    for label, run in runs.items():
        st = run["streams"]
        known = None not in st["copy"] | st["gru_fwd"]
        shared = bool(st["copy"] & st["gru_fwd"]) if known else None
        log(f"  {label}: host-to-device copies on stream(s) "
            f"{sorted(map(str, st['copy']))}, gru_fwd on "
            f"{sorted(map(str, st['gru_fwd']))}: the copy "
            + ("sits on the compute stream" if shared else
               "is off the compute stream" if known else
               "stream not reported by the profiler"))
        if label == "prefetch" and shared:
            raise AssertionError("the prefetch's copies ran on the compute "
                                 "stream")


def phase_encode_pipeline(torch, np, model, batches) -> dict:
    """The whole gallery's encode through the prefetch
    (``encode_gallery_device``) and through the pageable ``Batch.to`` path,
    timed in turns (pageable, prefetch, prefetch, pageable) on the same
    batches; the embeddings of the two paths must be equal."""
    from cmhse_tpu_torch.eval import encode_gallery_device

    n = sum(int(np.asarray(b.valid).sum()) for b in batches)
    rates = {"prefetch": [], "pageable": []}
    outs = {}
    for label in ("pageable", "prefetch", "prefetch", "pageable"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (encode_gallery_device(model, batches)[:2]
               if label == "prefetch" else
               encode_pageable(torch, model, batches))
        torch.cuda.synchronize()
        rates[label].append(n / (time.perf_counter() - t0))
        outs[label] = out
    same = all(torch.equal(a, b) for a, b in zip(outs["prefetch"],
                                                 outs["pageable"]))
    new, old = (float(np.mean(rates[k])) for k in ("prefetch", "pageable"))
    log(f"  encode {n} videos: prefetch {new:.1f} videos/s (turns "
        f"{rates['prefetch'][0]:.1f}, {rates['prefetch'][1]:.1f}) "
        f"[pageable {old:.1f}: {rates['pageable'][0]:.1f}, "
        f"{rates['pageable'][1]:.1f}]; embeddings equal: {same}")
    if not same:
        raise AssertionError("the prefetch changed the embeddings")
    return dict(prefetch=new, pageable=old)


def phase_topk(torch, rng) -> None:
    """The Retriever's two top-k paths (plain torch ops). The streaming one
    returns the dense one's indices, tie order included, on a 100,000-row
    gallery with padding holes. Then both are timed, with their peak
    memory, on both sides of ``DENSE_TOPK_MAX_BYTES``: the crossover the
    Retriever's choice rests on."""
    from cmhse_tpu_torch.ops.similarity import l2norm
    from cmhse_tpu_torch.ops.topk import (DENSE_TOPK_MAX_BYTES, dense_sim_topk,
                                          prepare_topk_gallery,
                                          should_stream_topk,
                                          streaming_sim_topk)

    dev = torch.device("cuda")
    g = exact_rows(rng, 100_000, 1024)
    g[77_777] = g[3]  # an exact duplicate in another chunk: a true tie
    valid = torch.from_numpy(rng.rand(100_000) > 0.01).to(dev)
    valid[[3, 77_777]] = True
    prepared = prepare_topk_gallery(g, valid)
    for q_rows in (8, 1024):
        q = exact_rows(rng, q_rows, 1024)
        q[0] = g[3]
        with torch.inference_mode():
            _, s_i = streaming_sim_topk(q, prepared, 10)
            _, d_i = dense_sim_topk(q, g, valid, 10)
        if not torch.equal(s_i, d_i):
            raise AssertionError("streaming and dense top-k differ")
        if s_i[0, :2].tolist() != [3, 77_777]:
            raise AssertionError(f"tie order {s_i[0, :2].tolist()}")
        log(f"  top-10 over 100,000 rows, {q_rows} queries: streaming and "
            "dense indices equal (ties lowest-index first)")
    del g, valid, prepared

    def mib_and_ms(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20, cuda_ms(fn)

    gen = card_generator(torch, rng)
    log(f"  dense vs streaming top-10, D=1024 (dense block budget "
        f"{DENSE_TOPK_MAX_BYTES / 2**20:.0f} MiB):")
    for n, q_list in ((100_000, (8, 1024)), (1_000_000, (8, 256, 1024))):
        g = l2norm(torch.randn(n, 1024, device=dev, generator=gen))
        valid = torch.rand(n, device=dev, generator=gen) > 0.01
        prepared = prepare_topk_gallery(g, valid)
        for q_rows in q_list:
            q = l2norm(torch.randn(q_rows, 1024, device=dev, generator=gen))
            with torch.inference_mode():
                d_mib, d_ms = mib_and_ms(
                    lambda: dense_sim_topk(q, g, valid, 10))
                s_mib, s_ms = mib_and_ms(
                    lambda: streaming_sim_topk(q, prepared, 10))
            path = ("streaming" if should_stream_topk(q_rows, n)
                    else "dense")
            log(f"    Q={q_rows} N={n}: block {4 * q_rows * n / 2**20:.1f} "
                f"MiB; dense {d_ms:.4f} ms, peak {d_mib:.1f} MiB; streaming "
                f"{s_ms:.4f} ms, peak {s_mib:.1f} MiB; Retriever takes {path}")
        del g, valid, prepared, q
        torch.cuda.empty_cache()


class patched:
    """Set ``obj.name = value`` for the ``with`` block, then restore it."""

    def __init__(self, obj, name: str, value) -> None:
        self.obj, self.name, self.value = obj, name, value

    def __enter__(self):
        self.saved = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.value)

    def __exit__(self, *exc) -> None:
        setattr(self.obj, self.name, self.saved)


class Killed(RuntimeError):
    """Phase 6's simulated kill: the process dies mid-epoch, with no chance
    to run the end-of-epoch save."""


def fit_datasets(seed: int):
    """Phase 6's data at the preset's widths: correlated synthetic train and
    validation splits (one topic space, disjoint videos), each drawn once
    into a list of examples (set-up): the runs then pay for padding the
    batches, as a loader over stored features would, not for drawing
    random frames again each epoch."""
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import CorrelatedSyntheticDataset

    dc = get_preset("cmhse_full").data

    def make(n, s):
        return CorrelatedSyntheticDataset(
            num_videos=n, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
            max_clips=dc.max_clips, max_frames=dc.max_frames,
            max_words=dc.max_words, seed=s)

    t0 = time.perf_counter()
    out = tuple([ds[i] for i in range(len(ds))] for ds in (
        make(FIT_TRAIN_VIDEOS, seed), make(FIT_VAL_VIDEOS, seed + 1)))
    log(f"  {FIT_TRAIN_VIDEOS} + {FIT_VAL_VIDEOS} synthetic videos drawn "
        f"(host): {time.perf_counter() - t0:.3f} s")
    return out


def fit_config(seed: int, ckpt_dir: str, **train):
    """cmhse_full at its published widths with phase 6's schedule."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset

    cfg = get_preset("cmhse_full")
    over = dict(num_epochs=FIT_EPOCHS, lr_update=1, val_step=0,
                snapshot_step=FIT_SNAPSHOT, log_step=1, seed=seed,
                checkpoint_dir=ckpt_dir)
    over.update(train)
    return cfg.replace(train=dataclasses.replace(cfg.train, **over))


def jsonl(path: str, event: str) -> list:
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["event"] == event]


def phase_fit(torch, np, seed: int, train_ds, val_ds) -> dict:
    """6: ``fit`` at full cmhse_full width, f32, on the card: FIT_EPOCHS
    epochs of FIT_TRAIN_VIDEOS correlated synthetic videos (batch 64),
    validating FIT_VAL_VIDEOS at each epoch's end, a snapshot every
    FIT_SNAPSHOT steps, lr decay each epoch. Then 6b: a second run killed
    after step FIT_KILL_AFTER and resumed from its last snapshot, held
    against the first tensor by tensor; 6c: one epoch at two steps a
    dispatch (train_steps, a CUDA graph) against the first run's
    checkpoint after its first epoch.
    Checkpoints go to a temporary directory, removed at the end."""
    import os
    import shutil
    import tempfile

    import cmhse_tpu_torch.train.loop as loop_mod
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.train.checkpoint import CheckpointManager

    root = tempfile.mkdtemp(prefix="cmhse_fit_")
    real_step, real_val = loop_mod.train_step, loop_mod.validate_metrics
    real_save = CheckpointManager.save
    timings = {"step": [], "val": [], "save": []}

    def timed_step(state, batch, loss_cfg):
        t0 = time.perf_counter()
        out = real_step(state, batch, loss_cfg)
        torch.cuda.synchronize()
        timings["step"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_val(*a, **kw):
        t0 = time.perf_counter()
        m = real_val(*a, **kw)
        torch.cuda.synchronize()
        timings["val"].append((time.perf_counter() - t0, m["rsum"]))
        return m

    def timed_save(self, *a, **kw):
        t0 = time.perf_counter()
        real_save(self, *a, **kw)
        timings["save"].append(time.perf_counter() - t0)

    try:
        cfg_a = fit_config(seed, os.path.join(root, "a"))
        log(f"  {FIT_TRAIN_VIDEOS} train / {FIT_VAL_VIDEOS} validation "
            f"videos (CorrelatedSyntheticDataset), batch "
            f"{cfg_a.data.batch_size}, {FIT_EPOCHS} epochs, lr "
            f"{cfg_a.train.lr} decay x{cfg_a.train.lr_decay} each epoch, "
            f"snapshot every {FIT_SNAPSHOT} steps, seed {seed}")
        with patched(loop_mod, "train_step", timed_step), \
                patched(loop_mod, "validate_metrics", timed_val), \
                patched(CheckpointManager, "save", timed_save):
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            state_a, best = loop_mod.fit(cfg_a, train_ds, val_ds)
            t_fit = time.perf_counter() - t0
            counts = launch_counts()
        log_path = os.path.join(cfg_a.train.checkpoint_dir, "log.jsonl")
        steps = jsonl(log_path, "train_step")
        losses = [e["loss"] for e in steps]
        epochs = jsonl(log_path, "epoch_end")
        ckpt_dir = os.path.join(cfg_a.train.checkpoint_dir, "ckpt")
        best_payload = torch.load(os.path.join(cfg_a.train.checkpoint_dir,
                                               "best"), weights_only=True)
        size = os.path.getsize(os.path.join(ckpt_dir, str(state_a.step)))
        log(f"  fit: {t_fit:.2f} s, {state_a.step} steps; median step "
            f"{float(np.median(timings['step'])):.3f} ms (first "
            f"{timings['step'][0]:.3f}); seconds per epoch "
            + ", ".join(f"{e['seconds']:.3f}" for e in epochs))
        log("  losses: " + json.dumps(losses))
        log("  validations: " + ", ".join(
            f"{t:.3f} s rsum {r:.2f}" for t, r in timings["val"])
            + f"; best rsum {best:.2f}, best checkpoint at step "
            f"{best_payload['step']} (epoch {best_payload['epoch']})")
        log(f"  checkpoints: {len(timings['save'])} saves, "
            f"{sum(timings['save']):.2f} s in all ({size / 2**30:.3f} GiB a "
            f"file); kept steps {sorted(map(int, os.listdir(ckpt_dir)))}")
        per_epoch = {k: v / FIT_EPOCHS for k, v in counts.items()}
        log(f"  launches per epoch (steps and validation): {per_epoch}")
        if len(losses) != state_a.step or not all(np.isfinite(losses)):
            raise AssertionError(f"fit's losses {losses}")
        if not (np.isfinite(best) and len(timings["val"]) == FIT_EPOCHS):
            raise AssertionError("fit's validations")
        if len(os.listdir(ckpt_dir)) > 3:
            raise AssertionError("more than three checkpoints kept")
        for k in ("gru_fwd float32 save_gates", "gru_bwd float32 zero_h0",
                  "simhinge float32 pair"):
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"{k} was not launched by fit")

        # 6b: kill after step FIT_KILL_AFTER, resume from the snapshot
        calls = {"n": 0}

        def killer(state, batch, loss_cfg):
            if calls["n"] >= FIT_KILL_AFTER:
                raise Killed()
            calls["n"] += 1
            return real_step(state, batch, loss_cfg)

        cfg_b = fit_config(seed, os.path.join(root, "b"))
        with patched(loop_mod, "train_step", killer):
            try:
                loop_mod.fit(cfg_b, train_ds, val_ds)
                raise AssertionError("the run was not killed")
            except Killed:
                pass
        mgr = CheckpointManager(cfg_b.train.checkpoint_dir)
        snap = torch.load(os.path.join(mgr.ckpt_dir, str(mgr.latest_step())),
                          weights_only=True)
        log(f"  killed after step {FIT_KILL_AFTER}: last snapshot step "
            f"{snap['step']}, epoch {snap['epoch']}, {snap['groups_done']} "
            f"groups done")
        if (snap["step"], snap["epoch"], snap["groups_done"]) != \
                (FIT_SNAPSHOT, 0, FIT_SNAPSHOT):
            raise AssertionError("the snapshot is not where it should be")
        t0 = time.perf_counter()
        cfg_r = fit_config(seed, cfg_b.train.checkpoint_dir,
                           resume=cfg_b.train.checkpoint_dir)
        state_b, _ = loop_mod.fit(cfg_r, train_ds, val_ds)
        resume_cmp = compare_states(torch, state_a.state_dict(),
                                    state_b.state_dict())
        log(f"  resumed run: {time.perf_counter() - t0:.2f} s; against the "
            f"uninterrupted run: steps {resume_cmp['steps']}, bitwise equal "
            f"{resume_cmp['bitwise']}, worst {resume_cmp['worst'][0]} "
            f"{resume_cmp['worst'][1]:.3g} of its largest entry (limit "
            f"{STATE_RTOL})")
        log("  max abs difference per tensor: "
            + json.dumps(resume_cmp["max_abs"]))
        if resume_cmp["worst"][1] > STATE_RTOL or \
                resume_cmp["steps"][0] != resume_cmp["steps"][1]:
            raise AssertionError("the resumed run differs")
        del state_b

        # 6c: one epoch at two steps a dispatch against the first run's
        # checkpoint after its first epoch (step 6: validation and
        # snapshots change no weight)
        cfg_d = fit_config(seed, os.path.join(root, "spd2"), num_epochs=1,
                           snapshot_step=0, steps_per_dispatch=2)
        t0 = time.perf_counter()
        state_d, _ = loop_mod.fit(cfg_d, train_ds, None)
        after_one = torch.load(os.path.join(ckpt_dir, str(state_d.step)),
                               weights_only=True,
                               map_location=state_d.model.device)
        spd_cmp = compare_states(torch, after_one, state_d.state_dict())
        log(f"  one epoch at two steps a dispatch: "
            f"{time.perf_counter() - t0:.2f} s, graph replays "
            f"{state_d.graph_replays}; against the first run's step-"
            f"{state_d.step} checkpoint: steps {spd_cmp['steps']}, bitwise "
            f"equal {spd_cmp['bitwise']}, worst {spd_cmp['worst'][0]} "
            f"{spd_cmp['worst'][1]:.3g} of its largest entry (limit "
            f"{STATE_RTOL})")
        log("  max abs difference per tensor: "
            + json.dumps(spd_cmp["max_abs"]))
        if spd_cmp["worst"][1] > STATE_RTOL or state_d.graph_replays <= 0 \
                or spd_cmp["steps"][0] != spd_cmp["steps"][1]:
            raise AssertionError("train_steps differs from train_step")
        del state_d, state_a
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(counts=counts, step_ms=float(np.median(timings["step"])),
                epoch_s=[e["seconds"] for e in epochs])


def phase_step_pipeline(torch, np, seed: int, train_ds) -> dict:
    """6d: train steps at full width with their batches through the
    prefetch (the loop's way) and through the pageable ``Batch.to`` path,
    on the same FIT_PIPELINE_STEPS host batches, timed in turns (pageable,
    prefetch, prefetch, pageable) after one untimed prefetch pass; a
    window's ms a step is its wall time over its steps, one
    synchronisation at its end."""
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import Prefetcher, batches_from_dataset
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import create_train_state, train_step

    cfg = get_preset("cmhse_full")
    n = FIT_PIPELINE_STEPS * cfg.data.batch_size
    host = list(batches_from_dataset(train_ds[:n], cfg.data, shuffle=False))
    model = CMHSE(cfg.model, cfg.data.vocab_size,
                  generator=torch.Generator().manual_seed(seed))
    state = create_train_state(cfg, model)
    pre = Prefetcher(model.device)

    def window(label: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "prefetch":
            for _, b in pre(host):
                train_step(state, b, cfg.loss)
        else:
            for b in host:
                train_step(state, b, cfg.loss)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(host)

    window("prefetch")
    ms = {"prefetch": [], "pageable": []}
    for label in ("pageable", "prefetch", "prefetch", "pageable"):
        ms[label].append(window(label))
    new, old = (float(np.mean(ms[k])) for k in ("prefetch", "pageable"))
    log(f"  {len(host)} steps a window: prefetch {new:.3f} ms a step (turns "
        f"{ms['prefetch'][0]:.3f}, {ms['prefetch'][1]:.3f}) [pageable "
        f"{old:.3f}: {ms['pageable'][0]:.3f}, {ms['pageable'][1]:.3f}]")
    return dict(prefetch=new, pageable=old)


def phase_lr_check(torch, np, seed: int) -> list:
    """6e: the card's side of ``scripts/lr_rise_check.py``: phase 5's
    batch, weights drawn with numpy from the seed (the same on every
    machine), eight steps at lr 1e-3."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import lr_rise_check

    cfg, batch, weights = lr_rise_check.setup(seed)
    losses = lr_rise_check.run_port(cfg, batch, weights, "cuda")
    log("  " + json.dumps({"run": "port, card", "lr": lr_rise_check.LR,
                           "losses": losses}))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    return losses


def phase_packer(torch, np, train_ds, epoch_s: list) -> None:
    """7a: the native packer against ``pad_batch`` on one 64-video batch of
    phase 6's examples, f32 and bf16: every field equal, frames bit for
    bit; host ms of each (median of PACK_REPS), and the share of phase 6's
    median epoch that packing an epoch's batches (train and validation)
    this way saves."""
    from cmhse_tpu_torch import native
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import BucketSpec, pad_batch

    dc = get_preset("cmhse_full").data
    examples = train_ds[:dc.batch_size]
    batches_a_epoch = (-(-FIT_TRAIN_VIDEOS // dc.batch_size)
                       - (-FIT_VAL_VIDEOS // dc.batch_size))
    t0 = time.perf_counter()
    native.library()
    log(f"  packer built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({native.build()})")
    for dtype in ("float32", "bfloat16"):
        spec = BucketSpec(dc.batch_size, dc.max_clips, dc.max_frames,
                          dc.max_sentences, dc.max_words, dc.feat_dim, dtype)
        got = native.pack_batch_native(examples, spec)
        want = pad_batch(examples, spec)
        for f in ("frames", "frame_len", "clip_len", "words", "word_len",
                  "sent_len", "video_ids", "valid"):
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(a, torch.Tensor):
                a, b = a.view(torch.int16).numpy(), b.view(torch.int16).numpy()
            elif a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"packer {dtype} {f} differs from "
                                     "pad_batch")
        ms = {}
        for name, fn in (("pad_batch", pad_batch),
                         ("packer", native.pack_batch_native)):
            times = []
            for _ in range(PACK_REPS):
                t0 = time.perf_counter()
                fn(examples, spec)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = float(np.median(times))
        saved = (ms["pad_batch"] - ms["packer"]) * batches_a_epoch / 1e3
        log(f"  {dtype}: every field equal to pad_batch's, frames bit for "
            f"bit; host ms a batch (median of {PACK_REPS}): pad_batch "
            f"{ms['pad_batch']:.3f}, packer {ms['packer']:.3f}; "
            f"{batches_a_epoch} batches an epoch save {saved:.4f} s, "
            f"{saved / float(np.median(epoch_s)):.1%} of phase 6's median "
            f"epoch ({float(np.median(epoch_s)):.3f} s)")


def read_hits(text: str) -> dict:
    """``cli.retrieve``'s printout -> {query line: [(key, score), ...]}."""
    out, current = {}, None
    for line in text.splitlines():
        if line.startswith(("query: ", "video query: ")):
            current = out.setdefault(line, [])
        elif line.startswith("  ") and current is not None:
            _, key, score = line.split()
            current.append((key, float(score.split("=")[1])))
    return out


def dump_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_cli(torch, np, seed: int) -> dict:
    """7b-7f: the command-line chain at cmhse_full's published widths over a
    reference-layout directory written by the port's fixtures: build_vocab,
    train (one epoch), evaluate --streaming --dump_ranks (a subprocess, then
    in the process), export_torch, import_torch, evaluate of the import,
    retrieve. Each stage of the chain runs with the launch counts set to 0
    and read after; the comparisons run outside them."""
    import collections
    import contextlib
    import importlib.util
    import io
    import os
    import shutil
    import tempfile

    from cmhse_tpu_torch.cli import (build_vocab, evaluate, export_torch,
                                     import_torch, retrieve)
    from cmhse_tpu_torch.cli import train as train_cli
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      batches_from_dataset)
    from cmhse_tpu_torch.data.fixtures import write_reference_dataset
    from cmhse_tpu_torch.eval.encode import encode_gallery_device
    from cmhse_tpu_torch.eval.retrieval import validate_metrics
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    cfg = get_preset("cmhse_full")
    dc, mc = cfg.data, cfg.model
    cli_counts = collections.Counter()
    stage_s = {}

    def stage(name, fn, counted=True):
        """Run one stage of the chain; its wall seconds, and its launches
        into the chain's counts."""
        if counted:
            cuda_lib.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_s[name] = time.perf_counter() - t0
        counts = launch_counts() if counted else {}
        cli_counts.update(counts)
        log(f"  {name}: {stage_s[name]:.2f} s; launches {counts}")
        return out, counts

    def ok(rc, what):
        if rc != 0:
            raise AssertionError(f"{what} returned {rc}")

    root = tempfile.mkdtemp(prefix="cmhse_cli_")
    try:
        data, run = os.path.join(root, "data"), os.path.join(root, "run")
        layout = "h5" if importlib.util.find_spec("h5py") else "npy"
        t0 = time.perf_counter()
        info = write_reference_dataset(
            data, n_train=CLI_TRAIN_VIDEOS, n_val=CLI_VAL_VIDEOS,
            feat_dim=dc.feat_dim, seed=seed, features=layout,
            clips=CLI_CLIPS, rows=CLI_ROWS)
        val_keys = set(info["keys"]["val"])
        log(f"  7b: {CLI_TRAIN_VIDEOS} train / {CLI_VAL_VIDEOS} val videos "
            f"in the reference layout, features as {layout} (h5py "
            f"{'present' if layout == 'h5' else 'absent'}), clips "
            f"{CLI_CLIPS[0]}-{CLI_CLIPS[1] - 1} of "
            f"{CLI_ROWS[0]}-{CLI_ROWS[1] - 1} rows, feat {dc.feat_dim}: "
            f"{time.perf_counter() - t0:.2f} s (set-up)")

        widths = ["--vocab_size", str(dc.vocab_size), "--word_dim",
                  str(mc.word_dim), "--feat_dim", str(mc.feat_dim),
                  "--rnn_hidden", str(mc.rnn_hidden), "--embed_size",
                  str(mc.embed_size), "--max_clips", str(dc.max_clips),
                  "--max_frames", str(dc.max_frames), "--max_sentences",
                  str(dc.max_sentences), "--max_words", str(dc.max_words),
                  "--batch_size", str(dc.batch_size)]
        log("  7c: cli.build_vocab, cli.train (cmhse_full, "
            + " ".join(widths) + ", 1 epoch)")
        stage("build_vocab", lambda: ok(build_vocab.main(
            ["--data_path", data, "--threshold", "1"]), "build_vocab"),
            counted=False)
        _, train_counts = stage("train", lambda: ok(train_cli.main(
            ["--preset", "cmhse_full", "--data_path", data, *widths,
             "--num_epochs", "1", "--snapshot_step", "4", "--val_step", "0",
             "--log_step", "1", "--seed", str(seed), "--logger_name", run]),
            "train"))
        events = {e for e in ("train_step", "epoch_end", "validate")
                  if jsonl(os.path.join(run, "log.jsonl"), e)}
        if events != {"train_step", "epoch_end", "validate"} or \
                not os.path.exists(os.path.join(run, "best")):
            raise AssertionError(f"the train run logged {events}")
        for k in ("gru_fwd float32 save_gates",
                  "gru_fwd float32 save_gates+with_h0", "gru_bwd float32",
                  "simhinge float32", "gru_fwd float32 encode"):
            if total(train_counts, k) <= 0:
                raise AssertionError(f"cli.train launched no {k}")

        log("  7d: cli.evaluate --streaming --dump_ranks, as a module in a "
            "subprocess, then in this process")
        dump_sub = os.path.join(root, "ranks_sub.jsonl")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc, _ = stage("evaluate (subprocess)", lambda: subprocess.run(
            [sys.executable, "-m", "cmhse_tpu_torch.cli.evaluate", run,
             "--streaming", "--dump_ranks", dump_sub], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600), counted=False)
        log("  " + "\n  ".join(proc.stdout.strip().splitlines()[-4:]))
        if proc.returncode != 0:
            raise AssertionError(f"cli.evaluate: rc {proc.returncode}\n"
                                 f"{proc.stderr[-4000:]}")
        dump_in = os.path.join(root, "ranks_in.jsonl")
        _, eval_counts = stage("evaluate (in process)", lambda: ok(
            evaluate.main([run, "--streaming", "--dump_ranks", dump_in]),
            "evaluate"))
        rows = dump_rows(dump_sub)
        if total(eval_counts, "rankcount float32") != 2 or \
                total(eval_counts, "gru_fwd float32 encode") <= 0:
            raise AssertionError(f"cli.evaluate launches {eval_counts}")
        if dump_rows(dump_in) != rows or len(rows) != CLI_VAL_VIDEOS:
            raise AssertionError("the subprocess's dump differs from the "
                                 "in-process one")

        def dense():
            model, rcfg = restore_for_eval(run)
            ds = PrecompDataset(data, "val",
                                Vocabulary.load(os.path.join(
                                    data, "vocab.json")),
                                feat_dim=rcfg.data.feat_dim)
            batches = list(batches_from_dataset(ds, rcfg.data,
                                                shuffle=False))
            _, ranks = validate_metrics(model, batches, streaming=False,
                                        return_ranks=True)
            v, p, valid = encode_gallery_device(model, batches)
            return ranks, (v[valid] @ p[valid].T).float()

        (ranks, sims), _ = stage("dense validate_metrics (comparison)",
                                 dense, counted=False)
        n_diff, gaps = 0, []
        for key, direction, s in (("v2p_ranks", "v2p_rank", sims),
                                  ("p2v_ranks", "p2v_rank", sims.T)):
            dumped = np.asarray([r[direction] for r in rows])
            differ = np.flatnonzero(dumped != ranks[key])
            n_diff += len(differ)
            check_rank_band(torch, dumped, s, direction)
            for i in differ:  # how near the positive's closest rival lies
                gap = (s[i] - s[i, i]).abs()
                gap[i] = float("inf")
                gaps.append(float(gap.min()))
        log(f"  the dump against validate_metrics(streaming=False): {n_diff} "
            f"of {2 * len(rows)} ranks differ, all within the "
            f"+-{RANK_TIE_TOL} near-tie band (largest gap to the nearest "
            f"rival among them {max(gaps, default=0.0):.3g}); keys "
            f"{rows[0]['key']}..{rows[-1]['key']}")

        log("  7e: cli.export_torch -> .pth.tar, cli.import_torch, "
            "cli.evaluate --dump_ranks of the import")
        pth = os.path.join(root, "exported.pth.tar")
        imported = os.path.join(root, "imported")
        stage("export_torch", lambda: ok(export_torch.main([run, pth]),
                                         "export_torch"))
        stage("import_torch", lambda: ok(import_torch.main([pth, imported]),
                                         "import_torch"))
        a, _ = restore_for_eval(run, device="cpu")
        b, _ = restore_for_eval(imported, device="cpu")
        sa, sb = a.state_dict(), b.state_dict()
        unequal = [k for k in sa if k not in sb or not torch.equal(sa[k],
                                                                   sb[k])]
        if unequal or sorted(sa) != sorted(sb):
            raise AssertionError(f"the round trip changed {unequal}")
        n_params = sum(v.numel() for v in sa.values())
        log(f"  round trip: {len(sa)} tensors, {n_params:,} parameters, "
            f"bit-equal; {os.path.getsize(pth) / 2**20:.1f} MiB file")
        dump_imp = os.path.join(root, "ranks_imported.jsonl")
        stage("evaluate (import)", lambda: ok(evaluate.main(
            [imported, "--data_path", data, "--streaming", "--dump_ranks",
             dump_imp]), "evaluate"))
        if dump_rows(dump_imp) != rows:
            raise AssertionError("the imported model's dump differs")

        log("  7f: cli.retrieve, one --query and one --query_video, -k 5")
        buf = io.StringIO()
        query = "a man runs in the park."
        qkey = info["keys"]["val"][0]

        def run_retrieve():
            with contextlib.redirect_stdout(buf):
                ok(retrieve.main([run, "--query", query, "--query_video",
                                  qkey, "-k", "5"]), "retrieve")

        stage("retrieve", run_retrieve)
        hits = read_hits(buf.getvalue())
        for label, got in hits.items():
            log(f"  {label} -> " + ", ".join(f"{k} {s:.4f}" for k, s in got))
        if len(hits) != 2 or any(len(h) != 5 or not {k for k, _ in h}
                                 <= val_keys for h in hits.values()):
            raise AssertionError(f"cli.retrieve's hits {hits}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("  stage seconds: " + json.dumps(
        {k: round(v, 3) for k, v in stage_s.items()}))
    return dict(counts=dict(cli_counts))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # 512 keeps the whole script, phase 6 included, inside the two minutes
    # it is held to on a busy host
    ap.add_argument("--videos", type=int, default=512,
                    help="synthetic gallery size of the serving path")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def phase(title: str) -> None:
        held, torch_mod = "", sys.modules.get("torch")
        if torch_mod is not None and torch_mod.cuda.is_initialized():
            gib = torch_mod.cuda.memory_allocated() / 2**30
            held = f"; {gib:.3f} GiB allocated"
        log(f"{title}  [{time.perf_counter() - t_start:.1f} s{held}]")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import cmhse_tpu_torch
    from cmhse_tpu_torch.ops import cuda_lib

    if Path(cmhse_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError("cmhse_tpu_torch was not imported from this "
                           f"checkout ({cmhse_tpu_torch.__file__})")

    phase("phase 0: build kernels")
    t0 = time.perf_counter()
    cuda_lib.library()
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    phase("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"  {kind}, {count} device(s)")
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)

    rng = np.random.RandomState(args.seed)
    dc = get_preset("cmhse_full").data
    ds = SyntheticHierarchicalDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=args.seed)
    b0 = next(batches_from_dataset(ds, dc, shuffle=False))
    ragged = rng.randint(0, 20, 100).astype(np.int32)
    ragged[::7] = 0
    phase("phase 2: gru_fwd vs plain (lengths of the main path's first batch)")
    enc_shapes = [
        ("video_low 512x64 D=500", b0.frame_len.reshape(-1), dc.max_frames,
         500),
        ("text_low 512x32 D=300", b0.word_len.reshape(-1), dc.max_words, 300),
        ("video_high 64x8 D=1024", b0.clip_len, dc.max_clips, 1024),
        ("ragged 100x20 D=1024, zero rows", ragged, 20, 1024),
    ]
    gru_rows = phase_gru(torch, rng, enc_shapes)
    train_shapes = [
        ("video_low 512x64 D=500", b0.frame_len.reshape(-1), dc.max_frames,
         500, False),
        ("text_low 512x32 D=300", b0.word_len.reshape(-1), dc.max_words, 300,
         False),
        ("video_high 64x8 D=1024", b0.clip_len, dc.max_clips, 1024, False),
        ("text_high 64x8 D=1024", b0.sent_len, dc.max_sentences, 1024,
         False),
        ("video_decoder 64x8 D=1024 h0", b0.clip_len, dc.max_clips, 1024,
         True),
        ("text_decoder 64x8 D=1024 h0", b0.sent_len, dc.max_sentences, 1024,
         True),
        ("ragged 100x20 D=1024, zero rows", ragged, 20, 1024, False),
        ("ragged 100x20 D=1024, zero rows, h0", ragged, 20, 1024, True),
    ]
    phase("phase 2b/2c: gru_fwd save_gates/with_h0 and gru_bwd vs plain "
          "(the training path's shapes)")
    fwd_rows, bwd_rows = phase_gru_train(torch, rng, train_shapes)
    phase("phase 2d: gru_fwd (three variants) and gru_bwd in bf16 vs plain "
          "(phase 2's and 2b/2c's shapes)")
    bf16_rows = phase_gru_bf16(torch, rng, enc_shapes, train_shapes)
    phase("phase 3: rankcount vs plain (exact-arithmetic rows)")
    for line in kernel_resources("rankcount.cu"):
        log("  ptxas " + line)
    log("  dynamic shared memory a block: f32 "
        f"{cuda_lib.library().cmhse_rankcount_smem_bytes(0):,} bytes, lowp "
        f"{cuda_lib.library().cmhse_rankcount_smem_bytes(1):,} bytes")
    rc_rows = phase_rankcount(torch, rng, [(1024, 100_000, 1024),
                                           (args.videos, args.videos, 1024)])
    phase("phase 3b: streaming top-k vs dense")
    phase_topk(torch, rng)
    phase("phase 3c: simhinge vs plain (exact-arithmetic rows)")
    sh_rows = phase_simhinge(torch, rng, (512, 64, 300))
    phase("phase 3d: rankcount lowp (bf16 multiplies) vs plain")
    lowp_rows = phase_rankcount_lowp(torch, rng)
    phase("phase 4: serving path at full cmhse_full width")
    main_out = phase_main_path(torch, np, args.seed, args.videos)
    counts = main_out["counts"]
    phase_encode_pipeline(torch, np, main_out["model"], main_out["batches"])
    phase("phase 4b: where the encode's device time goes (torch.profiler; "
          "the pageable path in brackets)")
    phase_breakdown(torch, main_out["model"], main_out["batches"])
    phase("phase 4c: serving path in bf16 (dtype and feature_dtype "
          "bfloat16), same weights and batches")
    bf16_serve = phase_serving_bf16(torch, np, main_out)
    bf16_counts = bf16_serve["counts"]
    phase_encode_pipeline(torch, np, bf16_serve["model"],
                          bf16_serve["batches"])
    phase("phase 4c: where the bf16 encode's device time goes "
          "(torch.profiler; the pageable path in brackets)")
    phase_breakdown(torch, bf16_serve["model"], bf16_serve["batches"])
    del main_out, bf16_serve
    phase(f"phase 5: training path at full cmhse_full width ({TRAIN_STEPS} "
          "train_steps, then validate_metrics)")
    train_out = phase_train(torch, np, args.seed)
    tcounts = train_out["counts"]
    phase("phase 5b: where one train step's device time goes (torch.profiler)")
    phase_train_breakdown(torch, train_out["state"], train_out["batch"],
                          train_out["loss_cfg"])
    del train_out
    phase("phase 5c: one train step at batch 8, card vs CPU")
    phase_train_parity(torch, np, args.seed)
    phase(f"phase 5d: training path in bf16 ({TRAIN_STEPS} train_steps, "
          "then validate_metrics)")
    bf16_train = phase_train(torch, np, args.seed, bf16=True)
    bcounts = bf16_train["counts"]
    phase("phase 5d: where one bf16 train step's device time goes "
          "(torch.profiler)")
    phase_train_breakdown(torch, bf16_train["state"], bf16_train["batch"],
                          bf16_train["loss_cfg"])
    del bf16_train
    phase("phase 5d: one bf16 train step at batch 8, card vs CPU")
    phase_train_parity_bf16(torch, np, args.seed)
    phase("phase 6a: can a train step be captured in a CUDA graph? "
          "(train_steps, K=2, batch 8, against train_step)")
    phase_graph_probe(torch, np, args.seed)
    phase(f"phase 6: fit at full cmhse_full width, f32 ({FIT_EPOCHS} epochs; "
          "6b kill and resume; 6c two steps a dispatch)")
    train_ds, val_ds = fit_datasets(args.seed)
    fit_out = phase_fit(torch, np, args.seed, train_ds, val_ds)
    fcounts = fit_out["counts"]
    phase("phase 6d: train steps with the prefetch and with pageable copies")
    phase_step_pipeline(torch, np, args.seed, train_ds)
    phase("phase 6e: phase 5's batch, numpy-drawn weights, lr 1e-3 "
          "(scripts/lr_rise_check.py's card run)")
    phase_lr_check(torch, np, args.seed)
    phase("phase 7a: the native packer vs pad_batch (64 of phase 6's videos)")
    phase_packer(torch, np, train_ds, fit_out["epoch_s"])
    del train_ds, val_ds
    phase("phase 7: the command-line chain at full cmhse_full width")
    cli_out = phase_cli(torch, np, args.seed)
    ccounts = cli_out["counts"]

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "cmhse_tpu.")))
    if leaked:
        raise AssertionError(f"the port loaded JAX modules: {leaked[:5]}")

    def entry(name, source, replaces, rows, path, launches, **extra):
        head = rows[0]
        return dict(
            name=name, route="cuda", source=f"cmhse_tpu_torch/csrc/{source}",
            replaces=replaces, path=path, launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=head["shape"], other_shapes=rows[1:], **extra)

    k1, k2 = "cmhse_tpu/ops/pallas_gru.py:51", \
        "cmhse_tpu/ops/pallas_gru_grad.py:70"
    k4 = "cmhse_tpu/ops/pallas_sim.py:286"
    entries = [
        entry("gru_fwd", "gru_fwd.cu", k1, gru_rows + fwd_rows,
              "serve+train+fit+cli", total(counts, "gru_fwd float32")
              + total(tcounts, "gru_fwd float32")
              + total(fcounts, "gru_fwd float32")
              + total(ccounts, "gru_fwd float32"),
              launches_by_path={"serve": total(counts, "gru_fwd"),
                                "train": total(tcounts, "gru_fwd"),
                                "fit": total(fcounts, "gru_fwd"),
                                "cli": total(ccounts, "gru_fwd")},
              launches_train_by_variant={
                  k: n for k, n in tcounts.items() if k.startswith("gru_fwd")},
              launches_fit_by_variant={k: n for k, n in fcounts.items()
                                       if k.startswith("gru_fwd")},
              launches_cli_by_variant={k: n for k, n in ccounts.items()
                                       if k.startswith("gru_fwd")}),
        entry("gru_bwd", "gru_bwd.cu", k2, bwd_rows, "train+fit+cli",
              total(tcounts, "gru_bwd float32")
              + total(fcounts, "gru_bwd float32")
              + total(ccounts, "gru_bwd float32"),
              launches_by_path={"train": total(tcounts, "gru_bwd"),
                                "fit": total(fcounts, "gru_bwd"),
                                "cli": total(ccounts, "gru_bwd")}),
        entry("simhinge", "simhinge.cu", "cmhse_tpu/ops/pallas_sim.py:58",
              sh_rows, "train+fit+cli",
              total(tcounts, "simhinge") + total(bcounts, "simhinge")
              + total(fcounts, "simhinge") + total(ccounts, "simhinge"),
              launches_by_path={"train": total(tcounts, "simhinge"),
                                "train bf16": total(bcounts, "simhinge"),
                                "fit": total(fcounts, "simhinge"),
                                "cli": total(ccounts, "simhinge")},
              ms_from="CUDA-graph replay of one call (graph_ms)",
              call_ms=sh_rows[0]["call_ms"]),
        entry("rankcount", "rankcount.cu", k4, rc_rows, "serve+train+cli",
              total(counts, "rankcount float32")
              + total(tcounts, "rankcount float32")
              + total(ccounts, "rankcount float32"),
              launches_by_path={"serve": total(counts, "rankcount"),
                                "train": total(tcounts, "rankcount"),
                                "cli": total(ccounts, "rankcount")}),
        entry("gru_fwd bf16", "gru_fwd.cu", k1, bf16_rows["encode"],
              "serve bf16", total(bf16_counts, "gru_fwd bfloat16 encode")),
        entry("gru_fwd bf16 save_gates", "gru_fwd.cu", k1,
              bf16_rows["save_gates"], "train bf16",
              bcounts.get("gru_fwd bfloat16 save_gates", 0)),
        entry("gru_fwd bf16 save_gates+with_h0", "gru_fwd.cu", k1,
              bf16_rows["save_gates_h0"], "train bf16",
              bcounts.get("gru_fwd bfloat16 save_gates+with_h0", 0)),
        entry("gru_bwd bf16", "gru_bwd.cu", k2, bf16_rows["bwd"],
              "train bf16", bcounts.get("gru_bwd bfloat16 zero_h0", 0)),
        entry("gru_bwd bf16 with_h0", "gru_bwd.cu", k2, bf16_rows["bwd_h0"],
              "train bf16", bcounts.get("gru_bwd bfloat16 with_h0", 0)),
        entry("rankcount lowp", "rankcount.cu", k4, lowp_rows, "serve bf16",
              bf16_counts.get("rankcount bfloat16 lowp", 0),
              branch="lowp, cmhse_tpu/ops/pallas_sim.py:297-304"),
    ]
    for e in entries:
        if e["launches"] <= 0:
            raise AssertionError(f"kernel {e['name']} was not launched on "
                                 f"its path ({e['path']})")
        if "cli" in e.get("launches_by_path", {}) and \
                e["launches_by_path"]["cli"] <= 0:
            raise AssertionError(f"the command-line chain launched no "
                                 f"{e['name']}")
    phase("done")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
