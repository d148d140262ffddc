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
     in bf16, with cuDNN's GRU in bf16 as the yardstick; 2e. both kernels
     (``gru_fwd`` in its encode and ``save_gates`` variants) at H = 2,048
     (past every resident W_h limit: the streamed variants), f32 and bf16,
     and at H = 30 (padded to 32), at video_low's lengths; 2f. the
     ``live_gemm`` kernel (the GRU's products over its live row-steps: the
     input projection, dX, dW_i with db_i, dW_h) against its plain version
     at video_low, text_low and video_high, at the main path's lengths and
     at full density, with torch.matmul over every row-step as the
     yardstick; 2g. its grouped forms (the routed experts' ``moe_*``
     kernels) at DeepSeek-V2-Lite's widths on ``cmhse_dsv2_lite.train``'s
     routing against their plain versions, timed beside a per-expert
     ``torch.matmul`` loop;
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
     re-encoded on the CPU (plain versions) and must agree; then the
     gallery's encode through the prefetch, timed, and two batches of it
     under torch.profiler: the host-to-device copies off the compute
     stream; 4c. the same in the bf16 configuration (``dtype`` and
     ``feature_dtype`` bfloat16) on the same weights and batches, plus the
     lowp rank count; embeddings held against the f32 model's, the first
     batch re-encoded on the CPU in bf16;
  5. the training path at the same width: 8 ``train_step``s on one 64-video
     batch (finite losses and grad norms, the last loss below the first,
     6 + 6 + 23 + 2 kernel launches in the first, eager step, none in its
     graph's 7 replays), then ``validate_metrics`` on the
     trained weights; 5c. one step at batch 8, card against the CPU's plain
     path: loss, grad_norm and every parameter gradient; 5d. the same three
     in bf16 (only the bf16 GRU kernels may launch; card vs CPU on four
     batches with the hardest negatives pinned, in the bf16 bands of
     ``tests/test_torch_bf16.py``; how often bf16 changes the picks);
  6. the training loop at the same width, f32: 6a. can ``train_steps``
     (K steps in one CUDA graph) capture and replay the step, against
     eager steps at batch 8; 6. ``fit`` for 2 epochs over 384
     correlated synthetic videos (validation of 256 at each epoch's end,
     snapshots, a best checkpoint; losses, step and validation times,
     checkpoint seconds, launches per epoch); 6b. a run killed after step 5
     and resumed from its step-4 snapshot, against the uninterrupted run
     tensor by tensor; 6c. one epoch at two steps a dispatch against the
     first run's checkpoint after one epoch; 6e. eight steps at lr 1e-3
     on phase 5's batch from weights drawn with numpy (the card's side of
     ``scripts/lr_rise_check.py``);
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
  8. the serving stack at the same width: 8a. the int8 two-stage top-k
     against the exact streaming one over 1,048,576 unit rows (+128
     invalid), Q=1024, k=10, at the Retriever level: every differing
     (query, rank) slot a pool miss or a near tie, the capture rate;
     prepare, queries per second, an append of 4,096 rows against a
     re-prepare, a compaction after a 1% remove (the top-k mapped through
     ``old_to_new``); the int8 product (``torch._int_mm`` against the
     values as f32) and the grouped pre-select against the plain per-chunk
     top-k, timed; 8b. ``serve_daemon.main`` on phase 7's best checkpoint
     and data, on a thread (``--socket --warm --batch_window_ms 2``),
     driven by the port's client: 8 text and 8 video_key requests against
     a direct Retriever, an add of a 64-video split while a second client
     queries, remove, compact, stats, shutdown; 8c. a daemon context with
     40,000 spliced rows, ``--quantized``: the same queries, an add, a
     remove with auto-compaction, against the exact top-k; 8d.
     ``scripts/torch_serve_soak.py``'s ``main`` for 10 s at its defaults
     (4 query clients and an add -> remove churn that compacts each
     cycle): ``ok``, a compaction, and K1 launches on its path; then its
     fixture again: K1's encode at its shapes (E 512, H 256) card vs
     CPU, and its daemon's final answers vs a direct Retriever;
  9. one NCCL rank (world size 1, from torchrun's variables on a free
     local port) at full width: 9a. 3 data-parallel ``train_step``s
     against 3 plain ones from the same weights (bit for bit, median ms of
     both); 9b. ``train_steps`` K=2 under the mesh, captured with its
     collectives, against eager steps (bit for bit); 9c.
     ``validate_metrics(mesh, mode)`` in both modes on phase 4's videos
     (streaming: K4) and ``sharded_ranks`` on 10,000 rows, equal to the
     single device's; 9d. ``sharded_sim_topk`` and the int8 prepared path
     at 100,000 rows, Q=1024, k=10, equal to the single-device top-k; 9e.
     K1 and K2 while all-reduces of 256 MiB are in flight, equal to a
     quiet run (a faulthandler watchdog turns a hang into a failure); 9f.
     one DP step at rnn_hidden 2,048 (f32, bf16: the streamed K1/K2) and
     30 (padded);
  10. the Retriever's mesh at the same width: a local mesh of 4 shards on
     cuda:0 (one process, the shard and merge code of one shard a card),
     exact and int8 over 100,000 unit rows (+24 invalid), Q=1024, k=10,
     against one device's exact top-k after a build, an add of 4,096 rows
     (the shards rebuilt), a 1% remove (masks, not rebuilds) and a
     compaction: differing slots near ties (exact) or pool misses or near
     ties (int8, capture >= 0.99); build, add, query ms and the merge's
     share; then ``serve_daemon.build_context(sharded=True)`` on phase 7's
     run, a text and a video_key request against a direct Retriever on
     the same mesh;
  11. ``python -m cmhse_tpu_torch.cli.bench`` in a subprocess: its one
     JSON line (printed), the value and every metric finite, K1-K4
     launched;
     11b. the JAX package's other training presets at their published
     widths (vocab 10,000, word_dim 300, feat_dim 500, H = E = 1024) on
     correlated synthetic data, random weights from the seed: ``didemo``
     (bucketed, length-grouped batches; attention pools, no decoders):
     one step at batch 8, card against the CPU's plain path in 5c's bands,
     at the smallest and the largest bucket its loader gives 512 videos;
     its 64 batches of 8 through the prefetch twice (host ms of the pass
     that grows the pinned ring, and of the next; each batch equal to
     ``Batch.to``'s); ``python -m cmhse_tpu_torch.cli.train --preset
     didemo --synthetic --correlated --synthetic_videos 768 --num_epochs
     2`` in its own process (run as ``-m`` runs it, each step timed): its
     buckets, steps, median step ms a bucket, epoch seconds, launches a
     step (K1 ``save_gates`` 4, K2 4, K3 2, no ``with_h0``), finite losses
     of which a later one is below the first, a ``best`` checkpoint, more
     than one bucket; ``cli.evaluate <run>/best --streaming --dump_ranks``
     (K4) on a reference-layout val split of 256 didemo-shaped videos,
     the dump against a dense ``validate_metrics``; ``fit`` of 2 epochs
     over 256 videos at batch 64, killed after step 6 and resumed from its
     step-6 snapshot, bitwise equal to the uninterrupted run;
     ``flat_anet_subset`` (one GRU a modality, T = 128 frames / 96
     words): one step at batch 8 card against CPU, ``fit`` for 2 epochs
     over its 100 videos at batch 32 (K1 2, K2 2, K3 1 a step); hier_anet:
     one step at batch 8 card against CPU, then 8 steps on one batch of
     64 (K1 4, K2 4, K3 2 a step); then K1 (encode, ``save_gates``) and K2
     against their plain versions at flat's 32 x 128 (D = 500) and 32 x
     96 (D = 300) and at didemo's largest bucket, 384 x 48 (D = 500), with
     cuDNN's times, and K3 at 384 rows;
  12. one JSON line listing each kernel and bf16 variant with its path, its
     launches there, its error against its plain version, times and bound;
  13. last line: ``{"ok": true, "device": {...}}``.

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
# live_gemm vs its plain version (cuBLAS over the gathered live rows): max
# abs error <= this * max |reference| (f32 sums over up to 8k live
# row-steps in another order)
LIVE_GEMM_RTOL = 1e-5
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


def live_gemm_cases(torch, rng, b: int, t: int, d: int, h: int,
                    lengths_np):
    """The four products over a GRU layer's row-steps (live_gemm.cu) at one
    shape: name -> (kernel call, plain call, library call, live FLOPs,
    bytes). The gradients are zero at dead row-steps, as gru_bwd gives
    them; the library call is ``torch.matmul`` over every row-step, the
    product the model made before the live row-steps were walked."""
    import numpy as np

    from cmhse_tpu_torch.ops import gru_kernel as gk
    from cmhse_tpu_torch.ops import live_gemm as lg

    dev = torch.device("cuda")
    x, w_i, _, b_i, _ = gru_inputs(torch, rng, b, t, d, h)
    gen = card_generator(torch, rng)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    dead = ~(torch.arange(t, device=dev)[None, :] < lengths[:, None])
    g = torch.randn(b, t, 3 * h, device=dev, generator=gen)
    dhn = torch.randn(b, t, h, device=dev, generator=gen)
    outs = torch.randn(b, t, h, device=dev, generator=gen)
    g[dead], dhn[dead] = 0.0, 0.0
    plan = gk._live_plan(x, lengths)
    live = int(lengths_np.clip(0, t).sum())
    x2, g2 = x.reshape(b * t, d), g.reshape(b * t, 3 * h)
    first = torch.zeros(b, 1, h, device=dev)
    n3 = 3 * h

    def library_dw_h():
        h_prev = torch.cat([first, outs[:, :-1]], dim=1).reshape(b * t, h)
        return torch.cat([h_prev.T @ g[..., :2 * h].reshape(b * t, -1),
                          h_prev.T @ dhn.reshape(b * t, h)], dim=1)

    return {
        "forward": (lambda: lg.rows_product(x, w_i, b_i, lengths, plan),
                    lambda: lg.rows_product_plain(x, w_i, b_i, lengths),
                    lambda: x2 @ w_i + b_i, 2.0 * live * d * n3,
                    4.0 * (live * d + d * n3 + live * n3 + n3)),
        "dX": (lambda: lg.rows_product(g, w_i, None, lengths, plan,
                                       w_nk=True, zero_dead=True),
               lambda: lg.rows_product_plain(g, w_i, None, lengths,
                                             w_nk=True),
               lambda: g2 @ w_i.T, 2.0 * live * d * n3,
               4.0 * (live * n3 + d * n3 + b * t * d)),
        "dW_i": (lambda: lg.rows_reduce(x, g, lengths, plan,
                                        column_sums=True),
                 lambda: lg.rows_reduce_plain(x, g, lengths,
                                              column_sums=True),
                 lambda: (x2.T @ g2, g2.sum(0)), 2.0 * live * (d + 1) * n3,
                 4.0 * (live * d + live * n3 + (d + 1) * n3)),
        "dW_h": (lambda: lg.rows_reduce(outs, g, lengths, plan,
                                        g_cols=2 * h, g_tail=dhn,
                                        shift=True),
                 lambda: lg.rows_reduce_plain(outs, g, lengths, g_cols=2 * h,
                                              g_tail=dhn, shift=True),
                 library_dw_h, 2.0 * live * h * n3,
                 4.0 * (live * h + live * n3 + h * n3)),
    }, dead


def phase_live_gemm(torch, rng, shapes, h: int = 1024) -> list:
    """2f: the products over the GRU's live row-steps (live_gemm.cu), the
    input projection, its dX, dW_i (with db_i) and dW_h, each against its
    plain version (the live rows gathered), with times: the kernel, its
    bound (the live FLOPs at the f32 peak), the plain version and
    ``torch.matmul`` over every row-step. ``shapes``: (label, lengths int32
    [B], T, D); each also at full density (every row T long). The forward
    is compared on live rows (the kernel leaves dead ones unwritten); dX
    must be zero on dead rows; the results of two calls equal bit for
    bit."""
    import numpy as np

    rows = []
    for label, lengths_np, t, d in shapes:
        b = lengths_np.shape[0]
        for density, lens in (("", lengths_np),
                              (", full", np.full(b, t, np.int32))):
            cases, dead = live_gemm_cases(torch, rng, b, t, d, h, lens)
            live = int(lens.clip(0, t).sum())
            for name, (kernel, plain, library, flops, nbytes) in \
                    cases.items():
                with torch.no_grad():
                    got, again, want = (
                        tuple(x for x in (r if isinstance(r, tuple) else (r,))
                              if x is not None)
                        for r in (kernel(), kernel(), plain()))
                    torch.cuda.synchronize()
                    if name == "forward":
                        got, again, want = ((r[~dead],) for r in
                                            (got[0], again[0], want[0]))
                    if name == "dX" and bool(got[0][dead].any()):
                        raise AssertionError(f"live_gemm dX {label}: a "
                                             f"dead row is not zero")
                    if not all(torch.equal(p, q) for p, q in
                               zip(got, again)):
                        raise AssertionError(f"live_gemm {name} {label}: "
                                             f"two calls differ")
                    err = max(((p - q).abs().max()
                               / q.abs().max().clamp_min(1e-30)).item()
                              if q.numel() else 0.0
                              for p, q in zip(got, want))
                    if not err <= LIVE_GEMM_RTOL:
                        raise AssertionError(
                            f"live_gemm {name} {label}{density}: error "
                            f"{err} of the largest entry > {LIVE_GEMM_RTOL}")
                    ms = cuda_ms(kernel)
                    plain_ms = cuda_ms(plain, reps=3, warmup=1)
                    library_ms = cuda_ms(library)
                bms, by = bound_ms(flops, nbytes)
                shape = f"{name} {label}{density}"
                rows.append(dict(shape=shape, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=by, library_ms=library_ms,
                                 live_share=live / (b * t),
                                 tflops=flops / ms / 1e9))
                log(f"  2f live_gemm {shape}: err {err:.3g}  kernel "
                    f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)  plain "
                    f"{plain_ms:.4f} ms  torch.matmul (every row-step) "
                    f"{library_ms:.4f} ms  bound {bms:.4f} ms ({by}, "
                    f"{100.0 * live / (b * t):.1f}% live)")
            del cases
    return rows


def phase_moe_grouped(torch, rng, rows: int = 16384, d: int = 2048,
                      width: int = 1408, experts: int = 64, held: int = 32,
                      k: int = 6, live_share: float = 0.19) -> list:
    """2g: the routed experts' grouped products (live_gemm.cu's ``moe_*``
    kernels) at DeepSeek-V2-Lite's widths on ``cmhse_dsv2_lite.train``'s
    routing (512 sentences x 32 slots, ~19% live, top-6 of 64 experts, 32
    held: ~300 slots an expert), each against its plain version, with
    times: the kernel, its bound (the FLOPs at the f32 peak), and a
    per-expert ``torch.matmul`` loop over the same groups (their slices
    read to the host once, outside the timing)."""
    from cmhse_tpu_torch.ops import live_gemm as lg

    dev = torch.device("cuda")
    gen = card_generator(torch, rng)
    live = torch.rand(rows, device=dev, generator=gen) < live_share
    top = torch.rand(rows, experts, device=dev, generator=gen).topk(k)
    tok, assign, gstarts, _ = lg.moe_plan(top.indices, live, held, 0)
    cap = rows * k
    starts = gstarts.tolist()
    groups = [(e, starts[e], starts[e + 1]) for e in range(held)
              if starts[e + 1] > starts[e]]
    slots = starts[held]

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    x, dy = randn(rows, d), randn(rows, d)
    w_gu, w_down = randn(held, d, 2 * width) * d ** -0.5, \
        randn(held, width, d) * width ** -0.5
    act, d_gu = randn(cap, width), randn(cap, 2 * width)
    scale = torch.rand(cap, device=dev, generator=gen)
    tok_l, assign_l = tok.long(), assign.long()

    def loop_rows(a, w, n, a_idx=None, c_idx=None, sc=None, w_nk=False):
        out = torch.zeros(cap, n, device=dev)
        for e, lo, hi in groups:
            src = a[a_idx[lo:hi]] if a_idx is not None else a[lo:hi]
            y = src @ (w[e].T if w_nk else w[e])
            if sc is not None:
                y = y * sc[lo:hi, None]
            if c_idx is not None:
                out[c_idx[lo:hi]] = y
            else:
                out[lo:hi] = y
        return out

    def loop_reduce(a, g, a_idx=None, g_idx=None):
        out = torch.zeros(held, a.shape[1], g.shape[1], device=dev)
        for e, lo, hi in groups:
            aa = a[a_idx[lo:hi]] if a_idx is not None else a[lo:hi]
            gg = g[g_idx[lo:hi]] if g_idx is not None else g[lo:hi]
            out[e] = aa.T @ gg
        return out

    f = 2.0 * slots * d * width
    cases = {
        "gate/up (2048 -> 2 x 1408)": (
            lambda: lg.moe_rows(x, w_gu, gstarts,
                                torch.zeros(cap, 2 * width, device=dev),
                                a_idx=tok),
            lambda: loop_rows(x, w_gu, 2 * width, a_idx=tok_l), 2 * f),
        "down (1408 -> 2048, scored)": (
            lambda: lg.moe_rows(act, w_down, gstarts,
                                torch.zeros(cap, d, device=dev),
                                c_idx=assign, scale=scale),
            lambda: loop_rows(act, w_down, d, c_idx=assign_l, sc=scale), f),
        "dX of down (2048 -> 1408)": (
            lambda: lg.moe_rows(dy, w_down, gstarts,
                                torch.zeros(cap, width, device=dev),
                                a_idx=tok, w_nk=True),
            lambda: loop_rows(dy, w_down, width, a_idx=tok_l, w_nk=True),
            f),
        "dX of gate/up (2 x 1408 -> 2048)": (
            lambda: lg.moe_rows(d_gu, w_gu, gstarts,
                                torch.zeros(cap, d, device=dev),
                                c_idx=assign, w_nk=True),
            lambda: loop_rows(d_gu, w_gu, d, c_idx=assign_l, w_nk=True),
            2 * f),
        "dW of down (reduction)": (
            lambda: lg.moe_reduce(act, dy, gstarts, g_idx=tok),
            lambda: loop_reduce(act, dy, g_idx=tok_l), f),
        "dW of gate/up (reduction)": (
            lambda: lg.moe_reduce(x, d_gu, gstarts, a_idx=tok),
            lambda: loop_reduce(x, d_gu, a_idx=tok_l), 2 * f),
    }
    out = []
    for name, (kernel, loop, flops) in cases.items():
        with torch.no_grad():
            got, again, want = kernel(), kernel(), loop()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"moe {name}: two calls differ")
            err = ((got - want).abs().max()
                   / want.abs().max().clamp_min(1e-30)).item()
            if not err <= LIVE_GEMM_RTOL:
                raise AssertionError(f"moe {name}: error {err} of the "
                                     f"largest entry > {LIVE_GEMM_RTOL}")
            ms = cuda_ms(kernel)
            loop_ms = cuda_ms(loop, reps=5, warmup=1)
        bms, by = bound_ms(flops, 0.0)
        out.append(dict(shape=name, max_abs_err=err, ms=ms, loop_ms=loop_ms,
                        bound_ms=bms, tflops=flops / ms / 1e9, slots=slots))
        log(f"  2g moe {name}: err {err:.3g}  kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)  per-expert torch.matmul "
            f"loop {loop_ms:.4f} ms  bound {bms:.4f} ms ({slots} slots in "
            f"{len(groups)} experts)")
    return out


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
    replays = state.graph_replays
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
    if dt == "float32":  # six GRUs' products; no dX for the frames' GRU
        want.update({"live_gemm float32 rows": 11,
                     "live_gemm float32 reduce": 12})
    # the first step launches from the host; the others replay its graph
    if step_counts != want or replays != TRAIN_STEPS - 1:
        raise AssertionError(f"launches {step_counts}, expected {want} in "
                             f"the first step; {replays} replays")
    return dict(counts=counts, state=state, batch=batch, loss_cfg=cfg.loss)


def phase_train_parity(torch, np, seed: int) -> None:
    """5c: one cmhse_full step at batch 8 and full width, card against the
    CPU's plain path (``step_parity``)."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)

    cfg = get_preset("cmhse_full")
    dc = dataclasses.replace(cfg.data, batch_size=8)
    ds = SyntheticHierarchicalDataset(
        num_videos=8, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
        max_clips=dc.max_clips, max_frames=dc.max_frames,
        max_words=dc.max_words, seed=seed + 2)
    step_parity(torch, cfg, next(batches_from_dataset(ds, dc, shuffle=False)),
                seed)


def step_parity(torch, cfg, host, seed: int, label: str = "batch 8",
                card="cuda") -> None:
    """One step's loss, grad_norm and every parameter gradient on the host
    batch ``host`` at ``cfg``'s widths, ``card`` against the CPU plain path
    from the same weights (drawn from ``seed``), within TRAIN_LOSS_RTOL,
    TRAIN_NORM_RTOL and TRAIN_GRAD_RTOL. Gradients, not post-step weights:
    Adam's first step is about lr * sign(g), so a weight whose gradient is
    near 0 may move either way."""
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import global_norm, total_loss

    res = {}
    for dev in (card, "cpu"):
        t0 = time.perf_counter()
        model = CMHSE(cfg.model, cfg.data.vocab_size, device=dev,
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
    card, cpu = res[card], res["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_rel = abs(card["norm"] - cpu["norm"]) / abs(cpu["norm"])
    grad_rel = {k: float((g - cpu["grads"][k]).abs().max()
                         / cpu["grads"][k].abs().max().clamp_min(1e-30))
                for k, g in card["grads"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"  {label}: card {card['metrics']} grad_norm {card['norm']:.6f}; "
        f"CPU {cpu['metrics']} grad_norm {cpu['norm']:.6f} "
        f"({cpu['s']:.1f} s on the CPU)")
    log(f"  loss rel err {loss_rel:.3g} (limit {TRAIN_LOSS_RTOL}), grad_norm "
        f"{norm_rel:.3g} (limit {TRAIN_NORM_RTOL}), worst of "
        f"{len(grad_rel)} gradients {worst} {grad_rel[worst]:.3g} (limit "
        f"{TRAIN_GRAD_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL
            and grad_rel[worst] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"card and CPU train steps differ ({label})")


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


def eager_step(state, batch, loss_cfg, mesh=None):
    """One step run eagerly, as ``train_step`` runs the first batch of a
    shape (no graph): the reference the graphs are held against."""
    from cmhse_tpu_torch.train.state import _update

    metrics = _update(state, batch.to(state.model.device), loss_cfg, mesh)
    state.step += 1
    return state, metrics


def phase_graph_probe(torch, np, seed: int) -> dict:
    """6a: can one train step be captured in a CUDA graph on this card?
    ``train_steps`` over two stacked batches of 8 videos at full width,
    dispatched twice (the first runs eagerly and captures, the second
    replays the graph), against four eager steps from the same weights:
    every parameter and Adam moment within STATE_RTOL of its largest
    entry."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import create_train_state, train_steps

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
                    state, m = eager_step(state, b, cfg.loss)
                    losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        states[mode] = state
        log(f"  {mode}: losses {losses}")
    cmp = compare_states(torch, states["graph"].state_dict(),
                         states["eager"].state_dict())
    log(f"  train_steps (K=2) replayed a graph {states['graph'].graph_replays}"
        f" time(s); against 4 eager steps: steps {cmp['steps']}, bitwise "
        f"equal {cmp['bitwise']}, worst {cmp['worst'][0]} "
        f"{cmp['worst'][1]:.3g} of its largest entry (limit {STATE_RTOL})")
    if states["graph"].graph_replays != 1:
        raise AssertionError("train_steps did not replay its graph")
    if not cmp["worst"][1] <= STATE_RTOL or cmp["steps"] != (4, 4):
        raise AssertionError("the graph's steps differ from the eager ones")
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
    if set(counts) != {"gru_fwd float32 encode", "live_gemm float32 rows",
                       "rankcount float32 f32"}:
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
        b, frames=torch.as_tensor(b.frames).to(torch.bfloat16))
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


def phase_encode_pipeline(torch, np, model, batches) -> None:
    """The whole gallery's encode through the prefetch
    (``encode_gallery_device``), timed twice; then two batches of it under
    torch.profiler, whose host-to-device copies must have left the compute
    stream (the one ``gru_fwd`` ran on)."""
    from torch.profiler import ProfilerActivity, profile

    from cmhse_tpu_torch.eval import encode_gallery_device

    n = sum(int(np.asarray(b.valid).sum()) for b in batches)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode_gallery_device(model, batches)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    log(f"  encode {n} videos: prefetch {float(np.mean(rates)):.1f} "
        f"videos/s (turns {rates[0]:.1f}, {rates[1]:.1f})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        encode_gallery_device(model, batches[:2])
        torch.cuda.synchronize()
    streams = {"copy": set(), "gru_fwd": set()}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        sid = getattr(e, "device_resource_id", None)
        if e.name.startswith("Memcpy HtoD"):
            streams["copy"].add(sid)
        elif "gru_fwd" in e.name:
            streams["gru_fwd"].add(sid)
    known = None not in streams["copy"] | streams["gru_fwd"]
    shared = bool(streams["copy"] & streams["gru_fwd"]) if known else None
    log(f"  2 batches: host-to-device copies on stream(s) "
        f"{sorted(map(str, streams['copy']))}, gru_fwd on "
        f"{sorted(map(str, streams['gru_fwd']))}: the copy "
        + ("sits on the compute stream" if shared else
           "is off the compute stream" if known else
           "stream not reported by the profiler"))
    if shared:
        raise AssertionError("the prefetch's copies ran on the compute "
                             "stream")


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
            path = ("streaming" if should_stream_topk(q_rows, n_gallery=n)
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


def dump_against_dense(torch, np, checkpoint: str, data: str, rows: list,
                       device=None) -> None:
    """A ``--dump_ranks`` file's rows against ``validate_metrics(streaming=
    False)`` of the same checkpoint on the val split of ``data``: each rank
    equal, or moved only across a rival inside the near-tie band."""
    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      batches_from_dataset)
    from cmhse_tpu_torch.eval.encode import encode_gallery_device
    from cmhse_tpu_torch.eval.retrieval import validate_metrics
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    model, rcfg = restore_for_eval(checkpoint, device=device)
    ds = PrecompDataset(data, "val", Vocabulary.load(
        str(Path(data) / "vocab.json")), feat_dim=rcfg.data.feat_dim,
        flat=not rcfg.model.hierarchical)
    batches = list(batches_from_dataset(ds, rcfg.data, shuffle=False))
    _, ranks = validate_metrics(model, batches, streaming=False,
                                return_ranks=True)
    v, p, valid = encode_gallery_device(model, batches)
    sims = (v[valid] @ p[valid].T).float()
    n_diff, gaps = 0, []
    for key, direction, s in (("v2p_ranks", "v2p_rank", sims),
                              ("p2v_ranks", "p2v_rank", sims.T)):
        dumped = np.asarray([r[direction] for r in rows])
        if dumped.shape != ranks[key].shape:
            raise AssertionError(f"the dump has {dumped.shape} {direction}s, "
                                 f"validate_metrics {ranks[key].shape}")
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


def phase_cli(torch, np, seed: int, root: str) -> dict:
    """7b-7f: the command-line chain at cmhse_full's published widths over a
    reference-layout directory written by the port's fixtures under
    ``root``: build_vocab, train (one epoch), evaluate --streaming
    --dump_ranks (a subprocess, then in the process), export_torch,
    import_torch, evaluate of the import, retrieve. Each stage of the chain
    runs with the launch counts set to 0 and read after; the comparisons run
    outside them. Returns the launch counts, the run and the data directory
    (phase 8 serves them)."""
    import collections
    import contextlib
    import importlib.util
    import io
    import os

    from cmhse_tpu_torch.cli import (build_vocab, evaluate, export_torch,
                                     import_torch, retrieve)
    from cmhse_tpu_torch.cli import train as train_cli
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data.fixtures import write_reference_dataset
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

    stage("dense validate_metrics (comparison)",
          lambda: dump_against_dense(torch, np, run, data, rows),
          counted=False)

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
    log("  stage seconds: " + json.dumps(
        {k: round(v, 3) for k, v in stage_s.items()}))
    return dict(counts=dict(cli_counts), run=run, data=data,
                val_keys=info["keys"]["val"])


# phase 8: the serving stack
INT8_ROWS = 1 << 20  # 8a: unit rows, plus INT8_PAD invalid tail rows
INT8_PAD = 128
INT8_QUERIES = 1024
INT8_APPEND = 4096
DAEMON_QUERIES = 8  # 8b: text requests, and video_key requests
LIVE_VIDEOS = 64    # 8b: the split added while the daemon serves
SPLICE_ROWS = 40_000  # 8c: the JAX package's streaming-scale gallery
# the least share of the exact top-k rows in the int8 pool (8a, 8c): a
# broken quantizer or scale lowers it; 1.0 was measured at every size
CAPTURE_FLOOR = 0.99


def int8_pool(torch, q, prep, k: int, rescore_m=None):
    """The candidate pool ``quantized_sim_topk`` rescores for each query
    (its first stage, step by step, through the module's own helpers)."""
    from cmhse_tpu_torch.ops import topk

    n_chunks, csize, _ = prep.int8_chunks.shape
    m = min(max(64, 4 * k) if rescore_m is None else rescore_m,
            n_chunks * csize)
    kk = min(max(k, -(-m // n_chunks)), csize)
    qi, _ = topk._quantize_rows_int8(q)
    cand = []
    for ci in range(n_chunks):
        sims = (topk.int8_product(qi, prep.int8_chunks[ci]).float()
                * prep.int8_scale[ci][None, :])
        sims = torch.where(prep.valid[ci][None, :], sims, float("-inf"))
        cand.append(topk._chunk_topk(sims, kk)[1] + ci * csize)
    return torch.cat(cand, dim=1)


def classify_slots(torch, want_s, want_i, got_s, got_i, pool=None) -> dict:
    """The (query, rank) slots whose index differs between an exact top-k
    (``want``) and another (``got``), each explained as a pool miss (an
    exact row at this rank or above is not in the query's pool, which
    shifts the ranks below it) or a near tie (the two scores at this rank
    within RANK_TIE_TOL); ``other`` counts the rest. ``capture``: the share
    of exact rows in the pool."""
    want_s, want_i, got_s, got_i = (torch.as_tensor(x).to(want_i.device)
                                    for x in (want_s, want_i, got_s, got_i))
    moved = got_i != want_i
    near = (got_s - want_s).abs() <= RANK_TIE_TOL
    if pool is None:
        in_pool = torch.ones_like(moved)
    else:
        in_pool = (pool[:, :, None] == want_i[:, None, :]).any(dim=1)
    missed_above = torch.cummax((~in_pool).int(), dim=1).values.bool()
    miss = moved & missed_above
    tie = moved & ~miss & near
    other = moved & ~miss & ~near
    return dict(slots=moved.numel(), differ=int(moved.sum()),
                miss=int(miss.sum()), tie=int(tie.sum()),
                other=int(other.sum()),
                capture=None if pool is None
                else float(in_pool.float().mean()))


def profile_kernels(torch, fn, top: int = 6) -> tuple[float, float, list]:
    """torch.profiler over ``fn()``: wall ms, device-busy ms, and the
    ``top`` kernels by device time as (name, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("Activity Buffer")),
                     key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    return wall_ms, busy_ms, kernels[:top]


def check_slots(what: str, c: dict) -> None:
    capture = ("" if c["capture"] is None
               else f"; capture rate {c['capture']:.6f}")
    log(f"  {what}: {c['differ']} of {c['slots']} (query, rank) slots "
        f"differ from the reference: {c['miss']} below a pool miss, "
        f"{c['tie']} near ties (<= {RANK_TIE_TOL}){capture}")
    if c["other"]:
        raise AssertionError(f"{what}: {c['other']} slots differ with no "
                             "pool miss and no near tie")
    if c["capture"] is not None and not c["capture"] >= CAPTURE_FLOOR:
        raise AssertionError(f"{what}: capture rate {c['capture']} below "
                             f"{CAPTURE_FLOOR}")


def phase_int8(torch, np, rng) -> None:
    """8a: the int8 two-stage top-k against the exact streaming one at a
    million rows, at the Retriever level: prepare, queries per second,
    an append against a re-prepare, a compaction after a 1% remove; the
    int8 product's two candidates and the grouped pre-select against the
    plain per-chunk top-k, each timed in the whole top-k."""
    from cmhse_tpu_torch.eval.serve import Retriever
    from cmhse_tpu_torch.ops import topk
    from cmhse_tpu_torch.ops.similarity import l2norm

    dev = torch.device("cuda")
    gen = card_generator(torch, rng)
    n, d, k = INT8_ROWS, 1024, 10
    rows = n + INT8_PAD
    g = l2norm(torch.randn(rows, d, device=dev, generator=gen))
    valid = torch.arange(rows, device=dev) < n
    q = l2norm(torch.randn(INT8_QUERIES, d, device=dev, generator=gen))
    encoded = (g, g, valid, np.arange(rows))
    retr = {}
    for name, quantize in (("exact", False), ("int8", True)):
        r = Retriever(None, quantize=quantize)
        t0 = time.perf_counter()
        r.build_gallery(encoded=encoded)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        prep_ms = cuda_ms(lambda: topk.prepare_topk_gallery(
            g, valid, quantize=quantize), reps=3, warmup=1)
        retr[name] = r
        log(f"  {name}: prepare {prep_ms:.3f} ms (build_gallery with the "
            f"key index {build_s:.3f} s); chunks "
            f"{tuple(r._prepared.chunks.shape)}")
    exact, int8 = retr["exact"], retr["int8"]
    pe, p8 = exact._prepared, int8._prepared
    if not topk.should_stream_topk(INT8_QUERIES, n_gallery=rows):
        raise AssertionError("the exact path would not stream here")

    with torch.inference_mode():
        want_s, want_i = topk.streaming_sim_topk(q, pe, k)
        got_s, got_i = topk.quantized_sim_topk(q, p8, k)
        pool = int8_pool(torch, q, p8, k)
        check_slots(f"int8 vs exact top-{k}, {n:,} rows, Q={INT8_QUERIES}",
                    classify_slots(torch, want_s, want_i, got_s, got_i,
                                   pool))
        dense_s, dense_i = topk.dense_sim_topk(q[:64], g, valid, k)
        check_slots("exact streaming vs dense (64 queries)",
                    classify_slots(torch, dense_s, dense_i, want_s[:64],
                                   want_i[:64]))

        # the int8 product: torch._int_mm against the int8 values as f32
        # (exact while 127^2 * D < 2^24), on one chunk and in the top-k
        qi, _ = topk._quantize_rows_int8(q)
        g8 = p8.int8_chunks[0]

        def f32_product(a, b):
            return a.float() @ b.float().T

        same = torch.equal(topk.int8_product(qi, g8).float(),
                           f32_product(qi, g8))
        mm_ms = cuda_ms(lambda: topk.int8_product(qi, g8))
        f32_ms = cuda_ms(lambda: f32_product(qi, g8))
        ops = 2.0 * INT8_QUERIES * g8.shape[0] * d
        log(f"  int8 product of one chunk ({INT8_QUERIES}x{d} by "
            f"{g8.shape[0]}x{d}): _int_mm {mm_ms:.4f} ms "
            f"({ops / mm_ms / 1e9:.1f} TOP/s), int8 values as f32 "
            f"{f32_ms:.4f} ms; equal {same}")
        if not same:
            raise AssertionError("the two int8 products differ")
        q_ms = cuda_ms(lambda: topk.quantized_sim_topk(q, p8, k), reps=5)
        with patched(topk, "int8_product", f32_product):
            q_f32_ms = cuda_ms(lambda: topk.quantized_sim_topk(q, p8, k),
                               reps=5)
        e_ms = cuda_ms(lambda: topk.streaming_sim_topk(q, pe, k), reps=5)

        def plain(sims, kk):
            return topk.topk_lowest_index(sims, kk)

        with patched(topk, "_chunk_topk", plain):
            e_plain_ms = cuda_ms(lambda: topk.streaming_sim_topk(q, pe, k),
                                 reps=5)
            q_plain_ms = cuda_ms(lambda: topk.quantized_sim_topk(q, p8, k),
                                 reps=5)
            if not torch.equal(topk.streaming_sim_topk(q, pe, k)[1], want_i) \
                    or not torch.equal(
                        topk.quantized_sim_topk(q, p8, k)[1], got_i):
                raise AssertionError("the plain per-chunk top-k differs "
                                     "from the grouped pre-select")
        for name, fn in (
                ("int8", lambda: topk.quantized_sim_topk(q, p8, k)),
                ("exact", lambda: topk.streaming_sim_topk(q, pe, k))):
            wall, busy, kernels = profile_kernels(torch, fn)
            log(f"  where one {name} call's device time goes "
                f"(torch.profiler): wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms")
            for kname, ms, calls in kernels:
                log(f"    {ms:.3f} ms ({100 * ms / busy:.1f}%) in {calls} "
                    f"call(s): {kname[:100]}")
    qps = {name: INT8_QUERIES / ms * 1e3 for name, ms in
           (("int8", q_ms), ("exact", e_ms))}
    log(f"  top-{k}, Q={INT8_QUERIES}, {n:,} rows: int8 {q_ms:.3f} ms "
        f"({qps['int8']:,.0f} queries/s; with the f32 product "
        f"{q_f32_ms:.3f} ms); exact streaming {e_ms:.3f} ms "
        f"({qps['exact']:,.0f} queries/s); plain per-chunk top-k instead "
        f"of the grouped pre-select: exact {e_plain_ms:.3f} ms, int8 "
        f"{q_plain_ms:.3f} ms")

    new = l2norm(torch.randn(INT8_APPEND, d, device=dev, generator=gen))
    grown = torch.cat([g, new])
    grown_valid = torch.cat([valid, torch.ones(INT8_APPEND, dtype=torch.bool,
                                               device=dev)])
    for name, prep, quantize in (("exact", pe, False), ("int8", p8, True)):
        app = topk.append_to_prepared(prep, new, n_existing=rows)
        fresh = topk.prepare_topk_gallery(grown, grown_valid,
                                          quantize=quantize)
        total_rows = rows + INT8_APPEND
        for field in ("chunks", "valid", "int8_chunks", "int8_scale"):
            a, b = getattr(app, field), getattr(fresh, field)
            if a is None:
                continue
            if not torch.equal(a.reshape(-1, *a.shape[2:])[:total_rows],
                               b.reshape(-1, *b.shape[2:])[:total_rows]):
                raise AssertionError(f"{name}: append != re-prepare "
                                     f"({field})")
        del app, fresh
        a_ms = cuda_ms(lambda: topk.append_to_prepared(
            prep, new, n_existing=rows), reps=3, warmup=1)
        r_ms = cuda_ms(lambda: topk.prepare_topk_gallery(
            torch.cat([g, new]), grown_valid, quantize=quantize), reps=3,
            warmup=1)
        log(f"  {name}: append {INT8_APPEND:,} rows {a_ms:.3f} ms vs a "
            f"re-prepare of the concatenation {r_ms:.3f} ms; rows equal")
    del new, grown, grown_valid

    # the same 1% tombstoned in both; the exact answer after the
    # compaction equals the one before it mapped through old_to_new (up to
    # near ties), and the int8 answer after it is held against the exact
    drop = rng.choice(n, n // 100, replace=False)
    del pe, p8
    after = {}
    for name, r in (("exact", exact), ("int8", int8)):
        if r.remove_from_gallery(drop.tolist()) != len(drop):
            raise AssertionError(f"{name}: remove")
        before_s, before_i = r._search(q, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = r.plan_compaction()
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        old_to_new = r.apply_compaction(plan)
        apply_s = time.perf_counter() - t0
        del plan
        after[name] = [torch.as_tensor(x, device=dev)
                       for x in r._search(q, k)]
        log(f"  {name}: removed {len(drop):,} rows (1%); plan_compaction "
            f"{plan_s:.3f} s, apply_compaction {apply_s * 1e3:.3f} ms; "
            f"{r.n_valid:,} valid rows")
        if name == "exact":
            c = classify_slots(
                torch, torch.as_tensor(before_s, device=dev),
                torch.as_tensor(old_to_new[before_i], device=dev),
                *after["exact"])
            check_slots(f"exact top-{k} after the compaction vs before, "
                        "mapped through old_to_new", c)
        else:
            with torch.inference_mode():
                pool = int8_pool(torch, q, r._prepared, k)
            check_slots(f"int8 top-{k} after the compaction vs the exact",
                        classify_slots(torch, *after["exact"],
                                       *after["int8"], pool))
    del exact, int8, retr, g, valid, q, encoded, after
    torch.cuda.empty_cache()


def embed_texts(torch, model, vocab, cfg, texts):
    """Text embeddings of ``texts`` as the Retriever makes them."""
    from cmhse_tpu_torch.eval.serve import text_query_batch

    batch = text_query_batch(vocab, texts, cfg.data.max_sentences,
                             cfg.data.max_words)
    with torch.inference_mode():
        return model.encode_text(*(torch.as_tensor(a).to(model.device)
                                   for a in batch))[0]


def wait_for_socket(path: str, thread, seconds: float = 300.0) -> None:
    """Until the daemon at ``path`` accepts a connection (its start-up
    encode done); raises if its thread died or time ran out."""
    import socket

    deadline = time.monotonic() + seconds
    while True:
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(10)
                s.connect(path)
            return
        except OSError:
            if not thread.is_alive() or time.monotonic() > deadline:
                raise AssertionError("the daemon did not start")
            time.sleep(0.05)


def same_hits(torch, what, hits, want_keys, want_s, key_rows) -> dict:
    """A daemon's hit lists against a direct top-k (keys and scores), as
    (query, rank) slots: differences must be near ties."""
    got_i = torch.tensor([[key_rows[h["key"]] for h in row]
                          for row in hits])
    got_s = torch.tensor([[h["score"] for h in row] for row in hits])
    want_i = torch.tensor([[key_rows[k] for k in row] for row in want_keys])
    err = float((got_s - torch.as_tensor(want_s).float()).abs().max())
    if not err <= SCORE_ATOL:
        raise AssertionError(f"{what}: scores off by {err}")
    c = classify_slots(torch, torch.as_tensor(want_s).float(), want_i,
                       got_s, got_i)
    check_slots(what, c)
    return c


def phase_daemon(torch, np, seed: int, cli: dict) -> dict:
    """8b: ``serve_daemon.main`` on phase 7's best checkpoint and data on a
    thread of this process (``--socket --warm --batch_window_ms 2``),
    driven by the port's client: text and video_key requests against a
    direct Retriever, an add racing a second client's queries, remove,
    compact, stats, shutdown. The direct Retrievers' answers and the
    add's reference encode are made first; the launch counts are set to 0
    just before the daemon starts and read after it stops, so they are the
    daemon's own. The add's gru_fwd launches are counted on its own thread
    (the racing client's queries launch on others) and held to those of
    one encode of the same split."""
    import os
    import threading

    from cmhse_tpu_torch.cli import serve_daemon
    from cmhse_tpu_torch.client import ServeClient
    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      batches_from_dataset)
    from cmhse_tpu_torch.data.fixtures import (make_sentence,
                                               write_reference_dataset)
    from cmhse_tpu_torch.eval.encode import encode_gallery_device
    from cmhse_tpu_torch.eval.serve import Retriever, video_query_batch
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    run, data = cli["run"], cli["data"]
    rng = np.random.RandomState(seed + 8)
    texts = [make_sentence(rng) for _ in range(DAEMON_QUERIES)]
    vkeys = cli["val_keys"][:DAEMON_QUERIES]
    # the direct Retrievers the daemon's answers are held against
    model, cfg = restore_for_eval(run)
    t0 = time.perf_counter()
    write_reference_dataset(data, splits=[("live", LIVE_VIDEOS)],
                            feat_dim=cfg.data.feat_dim, seed=seed + 8,
                            features="npy", clips=CLI_CLIPS, rows=CLI_ROWS)
    log(f"  a 'live' split of {LIVE_VIDEOS} videos written under the data "
        f"root for the add: {time.perf_counter() - t0:.2f} s (set-up)")
    vocab = Vocabulary.load(os.path.join(data, "vocab.json"))
    ds = PrecompDataset(data, "val", vocab, feat_dim=cfg.data.feat_dim)
    enc = encode_gallery_device(
        model, batches_from_dataset(ds, cfg.data, shuffle=False),
        return_ids=True)
    direct_v, direct_t = Retriever(model), Retriever(model)
    direct_v.build_gallery(encoded=enc, side="video")
    direct_t.build_gallery(encoded=enc, side="text")
    key_rows = {k: i for i, k in enumerate(ds.keys)}
    ids = enc[3]
    from cmhse_tpu_torch.eval.serve import text_query_batch

    ws, wi = direct_v.retrieve(*text_query_batch(
        vocab, texts, cfg.data.max_sentences, cfg.data.max_words), k=10)
    vs, vi = direct_t.retrieve_video(
        *video_query_batch(ds, cfg.data, vkeys), k=10)
    # one encode of the live split, as the daemon's add makes it
    live = PrecompDataset(data, "live", vocab, feat_dim=cfg.data.feat_dim,
                          flat=not cfg.model.hierarchical)
    before = cuda_lib.thread_launch_count("gru_fwd")
    encode_gallery_device(model, batches_from_dataset(live, cfg.data,
                                                      shuffle=False),
                          return_ids=True)
    want_add_launches = cuda_lib.thread_launch_count("gru_fwd") - before
    if want_add_launches < 4:  # 4 GRUs a batch
        raise AssertionError(f"an encode of the live split launched "
                             f"{want_add_launches} gru_fwd")
    add_launches = {}

    def counted_add(req, ctx, _add=serve_daemon._handle_add):
        before = cuda_lib.thread_launch_count("gru_fwd")
        try:
            return _add(req, ctx)
        finally:
            add_launches["n"] = (cuda_lib.thread_launch_count("gru_fwd")
                                 - before)

    sock = os.path.join(os.path.dirname(run), "daemon.sock")
    rc = {}

    def serve():
        try:
            rc["rc"] = serve_daemon.main([run, "--socket", sock,
                                          "--data_path", data, "--warm",
                                          "--batch_window_ms", "2"])
        except BaseException as e:  # reported by the checks below
            rc["error"] = repr(e)
            raise

    cuda_lib.reset_launches()
    t_start = time.perf_counter()
    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    try:
        wait_for_socket(sock, thread)
    except AssertionError:
        raise AssertionError(f"the daemon did not start: {rc}")
    start_s = time.perf_counter() - t_start
    log(f"  daemon up in {start_s:.2f} s (restore, encode of "
        f"{len(ds)} videos, --warm)")
    with ServeClient(socket_path=sock, timeout=300) as c:
        t_hits, v_hits, req_ms = [], [], []
        for text in texts:
            t0 = time.perf_counter()
            t_hits.append(c.query(text, k=10))
            req_ms.append((time.perf_counter() - t0) * 1e3)
        for key in vkeys:
            t0 = time.perf_counter()
            v_hits.append(c.query_video(key, k=10))
            req_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  {DAEMON_QUERIES} text and {DAEMON_QUERIES} video_key "
            f"requests, k=10, round trips (ms, in order): "
            + " ".join(f"{ms:.2f}" for ms in req_ms))
        same_hits(torch, "daemon text queries vs a direct Retriever",
                  t_hits, [[ds.keys[ids[j]] for j in row] for row in wi], ws,
                  key_rows)
        same_hits(torch, "daemon video_key queries vs a direct Retriever",
                  v_hits, [[ds.keys[ids[j]] for j in row] for row in vi], vs,
                  key_rows)

        # an add on one connection while another keeps querying
        racing = {"n": 0, "err": None}
        add_done = threading.Event()

        def querier():
            try:
                with ServeClient(socket_path=sock, timeout=300) as c2:
                    while True:
                        hits = c2.query(texts[racing["n"] % len(texts)],
                                        k=10)
                        if len(hits) != 10:
                            raise AssertionError(f"racing query: {hits}")
                        racing["n"] += 1
                        if add_done.is_set():
                            return
            except Exception as e:  # reported below
                racing["err"] = e

        q_thread = threading.Thread(target=querier, daemon=True)
        q_thread.start()
        while racing["n"] == 0 and q_thread.is_alive():
            time.sleep(0.001)
        before = cuda_lib.launch_count("gru_fwd")
        n_before = racing["n"]
        t0 = time.perf_counter()
        with patched(serve_daemon, "_handle_add", counted_add):
            added = c.add("live")
        add_s = time.perf_counter() - t0
        all_launches = cuda_lib.launch_count("gru_fwd") - before
        during = racing["n"] - n_before
        add_done.set()
        q_thread.join(timeout=300)
        if q_thread.is_alive() or racing["err"] is not None:
            raise AssertionError(f"the racing client failed: "
                                 f"{racing['err']!r}")
        log(f"  add of {added['added']} videos: {add_s:.3f} s, "
            f"{add_launches.get('n')} gru_fwd launches on the add's thread "
            f"(one encode of the split: {want_add_launches}); "
            f"{all_launches} on all threads meanwhile, with {during} racing "
            f"queries; the second client answered {racing['n']} queries, "
            f"all 10 hits; valid rows {added['valid_rows']}")
        if added["added"] != LIVE_VIDEOS or \
                added["valid_rows"] != len(ds) + LIVE_VIDEOS:
            raise AssertionError(f"add: {added}")
        if add_launches.get("n") != want_add_launches:
            raise AssertionError(f"the add launched {add_launches} gru_fwd, "
                                 f"an encode of its split "
                                 f"{want_add_launches}")
        live_hits = c.query_video("v_live000", k=5)
        if len(live_hits) != 5:
            raise AssertionError(f"an added video as a query: {live_hits}")

        victims = list(dict.fromkeys([t_hits[0][0]["key"], "v_live001",
                                      *vkeys[1:4]]))
        removed = c.remove(victims)
        after = c.query(texts[0], k=10)
        if removed != len(victims) or \
                {h["key"] for h in after} & set(victims):
            raise AssertionError(f"remove: {removed}, {after}")
        compacted = c.compact()
        stats = c.stats()
        log(f"  remove {removed}, compact {compacted}; stats: "
            + json.dumps({k: stats[k] for k in (
                "gallery_rows", "valid_rows", "prepared", "quantized",
                "requests_served", "compactions", "latency_ms_p50",
                "latency_ms_p90", "latency_ms_p99")}))
        if stats["valid_rows"] != len(ds) + LIVE_VIDEOS - len(victims) or \
                stats["invalid_fraction"] != 0.0:
            raise AssertionError(f"stats {stats}")
        c.shutdown()
    thread.join(timeout=120)
    if thread.is_alive() or rc.get("rc") != 0:
        raise AssertionError(f"the daemon's main returned {rc}")
    counts = launch_counts()
    log(f"  daemon {time.perf_counter() - t_start:.2f} s from start to "
        f"shutdown; launches {counts}")
    return dict(counts=counts, texts=texts, model=model, vocab=vocab,
                cfg=cfg)


def phase_splice(torch, np, cli: dict, dmn: dict) -> dict:
    """8c: the JAX package's streaming-scale case at full width: a daemon
    context (``build_context --quantized``) with SPLICE_ROWS spliced unit
    rows, served on a socket: the same text queries, an add, a remove
    past ``compact_threshold`` (auto-compaction), stats; the answers held
    against the exact top-k, differences pool misses or near ties."""
    import os
    import threading

    from cmhse_tpu_torch.cli import serve_daemon
    from cmhse_tpu_torch.client import ServeClient
    from cmhse_tpu_torch.data.fixtures import splice_synthetic_gallery
    from cmhse_tpu_torch.ops import cuda_lib, topk

    # the reference text embeddings, before the daemon's count starts
    q = embed_texts(torch, dmn["model"], dmn["vocab"], dmn["cfg"],
                    dmn["texts"])
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    ctx = serve_daemon.build_context(cli["run"], cli["data"], "val",
                                     quantized=True, compact_threshold=0.012,
                                     batch_window_ms=2.0)
    splice_synthetic_gallery(ctx, SPLICE_ROWS)
    r = ctx["retriever"]
    if r._prepared is None or r._prepared.int8_chunks is None:
        raise AssertionError("the spliced gallery is not held in int8")
    log(f"  context and {SPLICE_ROWS:,} spliced rows: "
        f"{time.perf_counter() - t0:.2f} s (set-up); chunks "
        f"{tuple(r._prepared.chunks.shape)}")
    sock = os.path.join(os.path.dirname(cli["run"]), "splice.sock")
    thread = threading.Thread(target=serve_daemon.serve_forever,
                              args=(ctx, sock), daemon=True)
    thread.start()
    wait_for_socket(sock, thread)

    def check(what, hits):
        key_rows = {ctx["keys"][int(gk)]: row
                    for row, gk in enumerate(r.gallery_keys)
                    if gk is not None and r._valid_host[row]}
        with torch.inference_mode():
            want_s, want_i = topk.dense_sim_topk(q, r.gallery,
                                                 r.gallery_valid, 10)
            pool = int8_pool(torch, q, r._prepared, 16)
        got_i = torch.tensor([[key_rows[h["key"]] for h in row]
                              for row in hits], device=want_i.device)
        got_s = torch.tensor([[h["score"] for h in row] for row in hits],
                             device=want_i.device)
        check_slots(what, classify_slots(torch, want_s, want_i, got_s,
                                         got_i, pool))

    with ServeClient(socket_path=sock, timeout=300) as c:
        t0 = time.perf_counter()
        base = c.query(dmn["texts"], k=10)
        log(f"  {len(base)} text queries in one request against "
            f"{SPLICE_ROWS:,} rows, int8: {(time.perf_counter() - t0) * 1e3:.2f}"
            " ms round trip")
        check("spliced, int8, vs the exact top-10 (pool of the daemon's k "
              "bucket, 16)", base)
        added = c.add("val")
        protect = {h["key"] for row in base for h in row}
        victims = [k for k in ctx["keys"][:700] if k not in protect][:600]
        rm = c.request({"op": "remove", "keys": victims})
        if rm["removed"] != 600 or "auto_compaction" not in rm:
            raise AssertionError(f"remove {rm}")
        again = c.query(dmn["texts"], k=10)
        check("after an add and a remove with auto-compaction", again)
        stats = c.stats()
        log(f"  add {added['added']}, remove {rm['removed']} with "
            f"auto-compaction {rm['auto_compaction']}; stats "
            + json.dumps({k: stats[k] for k in (
                "gallery_rows", "valid_rows", "prepared", "quantized",
                "compactions", "latency_ms_p50", "latency_ms_p99")}))
        if not (stats["prepared"] and stats["quantized"]
                and stats["compactions"] == 1):
            raise AssertionError(f"stats {stats}")
        c.shutdown()
    thread.join(timeout=120)
    if thread.is_alive():
        raise AssertionError("the spliced daemon did not stop")
    counts = launch_counts()
    log(f"  launches {counts}")
    return counts


SOAK_SECONDS = 10  # 8d


def phase_soak(torch) -> dict:
    """8d: ``scripts/torch_serve_soak.py``'s ``main`` in this process at
    its defaults on the card, for SOAK_SECONDS: its own fixture and run,
    query clients and the add -> remove churn against one daemon. The
    launch counts are set to 0 just before it and read just after; its
    summary must be ``ok``, with a compaction and K1 launches. Then the
    soak's fixture is built again (its ``build_fixture`` at the same
    arguments): K1's encode of its val split at the soak's shapes, card
    against the CPU's plain path (ENCODE_ATOL), and the daemon's final
    text and video_key answers against a direct Retriever on the CPU's
    embeddings, as 8b holds its daemon."""
    import importlib.util
    import os
    import shutil
    import tempfile

    spec = importlib.util.spec_from_file_location(
        "torch_serve_soak", ROOT / "scripts" / "torch_serve_soak.py")
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    from cmhse_tpu_torch.cli import device_for
    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      batches_from_dataset)
    from cmhse_tpu_torch.eval.encode import encode_gallery_device
    from cmhse_tpu_torch.eval.serve import (Retriever, text_query_batch,
                                            video_query_batch)
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    answers = {}
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = soak.main(["--seconds", str(SOAK_SECONDS)], answers=answers)
    counts = launch_counts()
    log(f"  soak {time.perf_counter() - t0:.2f} s with its set-up: "
        f"{out['queries']} queries ({out['qps']} /s), "
        f"{out['add_remove_cycles']} add/remove cycles, "
        f"{out['compactions']} compactions; stats p50 "
        f"{out['latency_ms_p50']} ms, p99 {out['latency_ms_p99']} ms "
        f"(last 1,024); every round trip p50 "
        f"{out['client_latency_ms_p50']} ms, p99 "
        f"{out['client_latency_ms_p99']}, max "
        f"{out['client_latency_ms_max']}; launches {counts}")
    if not out["ok"] or (out["compactions"] or 0) < 1:
        raise AssertionError(f"the soak failed: {out}")
    if total(counts, "gru_fwd") <= 0:
        raise AssertionError("the soak launched no gru_fwd")

    args = soak.build_parser().parse_args([])
    td = tempfile.mkdtemp(prefix="cmhse_soak_")
    try:
        root, run, n_valid = soak.build_fixture(
            td, args.n_val, args.feat_dim, args.embed,
            device_for(args.platform))
        vocab = Vocabulary.load(os.path.join(root, "vocab.json"))
        models = {dev: restore_for_eval(run, device=dev)
                  for dev in ("cuda", "cpu")}
        cfg = models["cpu"][1]
        ds = PrecompDataset(root, "val", vocab, feat_dim=cfg.data.feat_dim)
        enc = {}
        for dev, (model, _) in models.items():
            with torch.inference_mode():
                enc[dev] = encode_gallery_device(
                    model, batches_from_dataset(ds, cfg.data, shuffle=False),
                    return_ids=True)
        live = enc["cpu"][2].cpu()  # padded rows are no one's answer
        err = max((enc["cuda"][i].cpu()[live] - enc["cpu"][i][live])
                  .abs().max().item() for i in (0, 1))
        log(f"  the soak's fixture again: {n_valid} videos, E "
            f"{cfg.model.embed_size}, H {cfg.model.rnn_hidden}, word_dim "
            f"{cfg.model.word_dim}, Fmax {cfg.data.max_frames}, Wmax "
            f"{cfg.data.max_words}; K1 encode card vs CPU (plain) max abs "
            f"err {err:.3g} (limit {ENCODE_ATOL})")
        if not err <= ENCODE_ATOL:
            raise AssertionError(f"the soak's encode: card and CPU differ "
                                 f"by {err}")
        model = models["cpu"][0]
        direct_v, direct_t = Retriever(model), Retriever(model)
        direct_v.build_gallery(encoded=enc["cpu"], side="video")
        direct_t.build_gallery(encoded=enc["cpu"], side="text")
        ids = enc["cpu"][3]
        key_rows = {k: i for i, k in enumerate(ds.keys)}
        ws, wi = direct_v.retrieve(*text_query_batch(
            vocab, soak.TEXTS, cfg.data.max_sentences, cfg.data.max_words),
            k=10)
        vs, vi = direct_t.retrieve_video(*video_query_batch(
            ds, cfg.data, answers["video_keys"]), k=10)
        same_hits(torch, "the soak's final text queries vs a direct "
                  "Retriever (CPU)", answers["text"],
                  [[ds.keys[ids[j]] for j in row] for row in wi], ws,
                  key_rows)
        same_hits(torch, "the soak's final video_key queries vs a direct "
                  "Retriever (CPU)", answers["video"],
                  [[ds.keys[ids[j]] for j in row] for row in vi], vs,
                  key_rows)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return counts


# 2e and phase 9: every H on the card, and one NCCL rank
STREAM_H = 2048  # past both resident W_h limits in both types: streamed
PAD_H = 30  # not a multiple of 4: padded to 32
NCCL_BATCHES = 3  # 9a: DP steps against plain steps, one a batch
NCCL_GALLERY = 10_000  # 9c: BASELINE config 5's gallery
NCCL_TOPK_ROWS = 100_000  # 9d
NCCL_TOPK_QUERIES = 1024
NCCL_BUSY_MIB = 256  # 9e: the all-reduce in flight beside K1 and K2
NCCL_WATCHDOG_S = 300  # a hang in phase 9 ends the script with stacks


def phase_gru_any_h(torch, rng, lengths_np, t: int, d: int) -> dict:
    """2e: K1 (encode and save_gates) and K2 at H = STREAM_H (past every
    resident W_h limit: the streamed variants), f32 and bf16, and at
    H = PAD_H (padded), f32, at video_low's lengths, each against its plain
    version, with times, bounds and cuDNN's GRU (its training forward
    beside save_gates). Returns rows by (kernel, dtype, H), the kernel
    "gru_fwd", "gru_fwd save_gates" or "gru_bwd"."""
    from cmhse_tpu_torch.models.gru import gru_input_projection
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.ops import gru_kernel as gk

    dev = torch.device("cuda")
    rows = {}
    b = lengths_np.shape[0]
    lengths = torch.from_numpy(lengths_np).to(dev)
    live_mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    live = int(lengths_np.clip(0, t).sum())
    label = f"video_low {b}x{t} D={d}"
    for h, name in ((STREAM_H, "float32"), (STREAM_H, "bfloat16"),
                    (PAD_H, "float32")):
        dt = getattr(torch, name)
        bf16 = dt == torch.bfloat16
        tol = BF16_ATOL if bf16 else GRU_ATOL
        streamed = h > gk.fwd_max_hidden(dt)
        x, w_i, w_h, b_i, b_h = gru_inputs(torch, rng, b, t, d, h)
        gen = card_generator(torch, rng)
        shape = f"{label} H={h}" + (" (streamed)" if streamed else
                                    f" (padded to {gk.padded_hidden(h)})")
        with torch.no_grad():
            xw = gru_input_projection(x.to(dt), w_i, b_i).contiguous()
            w_hc = w_h.to(dt)
            for save in (False, True):
                variant = (("save_gates" if save else "encode")
                           + ("+streamed" if streamed else ""))
                before = cuda_lib.launch_count("gru_fwd", name, variant)
                got = gk.gru_forward(xw, w_hc, b_h, lengths, save_gates=save)
                want = gk.gru_recurrence_plain(xw, w_hc, b_h, lengths,
                                               save_gates=save)
                torch.cuda.synchronize()
                if cuda_lib.launch_count("gru_fwd", name,
                                         variant) != before + 1:
                    raise AssertionError(f"gru_fwd {shape}: not the "
                                         f"expected variant ({variant})")
                errs = [(got[0].float() - want[0].float()).abs().max().item(),
                        (got[1].float() - want[1].float()).abs().max().item()]
                if save and live:
                    errs.append((got[2][live_mask].float()
                                 - want[2][live_mask].float()).abs().max()
                                .item())
                err = max(errs)
                what = "gru_fwd save_gates" if save else "gru_fwd"
                if not err <= tol:
                    raise AssertionError(f"{what} {name} {shape}: max abs "
                                         f"err {err} > {tol}")
                ms = cuda_ms(lambda: gk.gru_forward(xw, w_hc, b_h, lengths,
                                                    save_gates=save), reps=5)
                plain = cuda_ms(lambda: gk.gru_recurrence_plain(
                    xw, w_hc, b_h, lengths, save_gates=save), reps=2,
                    warmup=1)
                library = library_gru_ms(torch, x, lengths_np, w_i, w_h, b_i,
                                         b_h, got[1],
                                         mode="train" if save else
                                         "inference",
                                         dtype=dt if bf16 else None)
                bms, by = gru_bounds(b, t, h, live, gates=save, bf16=bf16)
                rows[(what, name, h)] = dict(
                    shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=library)
                log(f"  2e {what} {name} {shape}: err {err:.3g}  kernel "
                    f"{ms:.4f} ms  plain {plain:.4f} ms  cuDNN"
                    f"{' train fwd' if save else ''} "
                    f"{'refused' if library is None else f'{library:.4f} ms'}"
                    f"  bound {bms:.4f} ms ({by})")
                del want
            outs, final, gates = got
            douts = torch.randn(b, t, h, device=dev, generator=gen).to(dt)
            dfinal = torch.randn(b, h, device=dev, generator=gen).to(dt)
            got = gk.gru_backward(gates, outs, lengths, w_hc, douts, dfinal)
            want = gk.gru_backward_plain(gates, outs, lengths, w_hc, douts,
                                         dfinal)
            torch.cuda.synchronize()
            errs, abs_err = {}, 0.0
            for part, g, w in zip(("dxw", "dhn", "db", "dh0"), got, want):
                g, w = g.float(), w.float()
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"gru_bwd {shape}: non-finite {part}")
                abs_err = max(abs_err, (g - w).abs().max().item())
                errs[part] = (((g - w).norm() / w.norm().clamp_min(1e-30))
                              if bf16 else ((g - w).abs().max()
                                            / w.abs().max().clamp_min(1e-30))
                              ).item()
            tol = BF16_GRAD_RL2 if bf16 else GRU_BWD_RTOL
            if not max(errs.values()) <= tol:
                raise AssertionError(f"gru_bwd {name} {shape}: errors {errs} "
                                     f"> {tol}")
            ms = cuda_ms(lambda: gk.gru_backward(gates, outs, lengths, w_hc,
                                                 douts, dfinal), reps=5)
            plain = cuda_ms(lambda: gk.gru_backward_plain(
                gates, outs, lengths, w_hc, douts, dfinal), reps=2, warmup=1)
        library = library_gru_ms(torch, x, lengths_np, w_i, w_h, b_i, b_h,
                                 final, mode="backward",
                                 dtype=dt if bf16 else None)
        bms, by = gru_bounds(b, t, h, live, backward=True, bf16=bf16)
        rows[("gru_bwd", name, h)] = dict(
            shape=shape, max_abs_err=abs_err, ms=ms, plain_ms=plain,
            bound_ms=bms, bound_by=by, library_ms=library, errors=errs)
        log(f"  2e gru_bwd {name} {shape}: "
            + ("rel L2 " if bf16 else "rel err ")
            + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  cuDNN bwd "
            f"{'refused' if library is None else f'{library:.4f} ms'}  "
            f"bound {bms:.4f} ms ({by})")
        del xw, outs, final, gates, got, want, douts, dfinal
    return rows


def nccl_group(torch):
    """A process group of world size 1 over NCCL, from the environment
    torchrun would set (a free local port), as ``cli.train`` starts one."""
    import os
    import socket

    from cmhse_tpu_torch.parallel import maybe_initialize_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    os.environ.update(env)
    if not maybe_initialize_distributed():
        raise AssertionError("no process group from the torchrun variables")
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        raise AssertionError(f"the card's group runs {backend}, not nccl")
    return list(env)


def nccl_setup(torch, np, seed: int, batches: int, **model):
    """cmhse_full at its published widths (``model``: ModelConfig fields
    to change), weights from the seed, Adam at TRAIN_LR, and ``batches``
    64-video batches from the seed: (cfg, make_state, host batches)."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import create_train_state, set_learning_rate

    cfg = get_preset("cmhse_full")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **model))
    if cfg.model.dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, feature_dtype="bfloat16"))
    dc = cfg.data
    ds = SyntheticHierarchicalDataset(
        num_videos=batches * dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=seed + 9)
    host = list(batches_from_dataset(ds, dc, shuffle=False))

    def make_state():
        m = CMHSE(cfg.model, dc.vocab_size,
                  generator=torch.Generator().manual_seed(seed))
        return set_learning_rate(create_train_state(cfg, m), TRAIN_LR)

    return cfg, make_state, host


def phase_nccl(torch, np, seed: int, n_videos: int) -> dict:
    """9: the multi-GPU path on one NCCL rank (world size 1) at full
    cmhse_full width: the process group from torchrun's variables, the mesh
    of ``TrainConfig.mesh_shape``, and (a) DP train_steps against plain
    ones, (b) train_steps' graph with its collectives, (c) sharded
    validation and sharded ranks, (d) sharded top-k, exact and int8, (e) K1
    and K2 beside an all-reduce in flight, (f) the DP step at rnn_hidden
    STREAM_H (f32 and bf16: the streamed K1/K2) and PAD_H. At world size 1
    every result must equal the single-device path's bit for bit. Counts
    are set to 0 just before each DP or sharded call and read just after
    it, so the single-device references and (e)'s direct kernel calls are
    not counted; each part fails if its path launched none of the kernels
    it runs. Returns the counts' sum."""
    import collections
    import faulthandler
    import os

    from cmhse_tpu_torch.eval import validate_metrics
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.ops.rankcount_kernel import rank_counts
    from cmhse_tpu_torch.ops.ranking import retrieval_ranks
    from cmhse_tpu_torch.ops.similarity import l2norm
    from cmhse_tpu_torch.ops.topk import (prepare_topk_gallery,
                                          quantized_sim_topk,
                                          streaming_sim_topk)
    from cmhse_tpu_torch.parallel import (make_mesh, place_state,
                                          prepare_sharded_topk_gallery,
                                          sharded_ranks, sharded_sim_topk,
                                          sharded_sim_topk_prepared)
    from cmhse_tpu_torch.train import train_step, train_steps

    faulthandler.dump_traceback_later(NCCL_WATCHDOG_S, exit=True)
    env = nccl_group(torch)
    counts = collections.Counter()
    t_phase = time.perf_counter()
    try:
        cfg, make_state, host = nccl_setup(torch, np, seed, NCCL_BATCHES)
        mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes)
        log(f"  nccl, world {mesh.world}, mesh {mesh.shape} on "
            f"{mesh.device} ({time.perf_counter() - t_phase:.1f} s set-up)")

        # (a) DP steps against plain steps, in turns; only the DP steps
        # run between a reset of the counts and their reading
        plain, dp = make_state(), place_state(make_state(), mesh)
        ms = {"plain": [], "dp": []}
        losses = {"plain": [], "dp": []}
        dp_counts = collections.Counter()
        for b in host:
            for name in ("plain", "dp"):
                cuda_lib.reset_launches()
                t0 = time.perf_counter()
                if name == "plain":
                    plain, m = train_step(plain, b, cfg.loss)
                else:
                    dp, m = train_step(dp, b, cfg.loss, mesh=mesh)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
                if name == "dp":
                    dp_counts.update(launch_counts())
                losses[name].append({k: float(v) for k, v in m.items()})
        counts.update(dp_counts)
        need_launches("9a DP steps", dp_counts,
                      ("gru_fwd", "gru_bwd", "simhinge"))
        cmp = compare_states(torch, dp.state_dict(), plain.state_dict())
        log(f"  9a {NCCL_BATCHES} DP train_steps against plain ones: median "
            f"{float(np.median(ms['dp'])):.3f} ms DP, "
            f"{float(np.median(ms['plain'])):.3f} ms plain (first "
            f"{ms['dp'][0]:.1f} / {ms['plain'][0]:.1f}); losses "
            f"{[m['loss'] for m in losses['dp']]}; parameters and Adam "
            f"moments bitwise equal {cmp['bitwise']}")
        if losses["dp"] != losses["plain"] or not cmp["bitwise"]:
            raise AssertionError(f"the DP step differs from train_step: "
                                 f"worst {cmp['worst']}")
        del plain, dp

        # (b) K = 2 steps a dispatch: captured with the collectives
        stacked = stack_batches(np, host[:2])
        graph, eager = place_state(make_state(), mesh), make_state()
        eager = place_state(eager, mesh)
        cuda_lib.reset_launches()
        for _ in range(2):
            graph, _ = train_steps(graph, stacked, cfg.loss, mesh=mesh)
            for b in host[:2]:
                eager, _ = eager_step(eager, b, cfg.loss, mesh=mesh)
        torch.cuda.synchronize()
        got = launch_counts()
        counts.update(got)
        need_launches("9b DP steps", got, ("gru_fwd", "gru_bwd", "simhinge"))
        cmp = compare_states(torch, graph.state_dict(), eager.state_dict())
        if graph.graph_refused is not None:
            log(f"  9b the card refused the capture under the mesh: "
                f"{graph.graph_refused}; one step a dispatch")
        else:
            log(f"  9b train_steps (K=2) under the mesh: graph with its "
                f"collectives replayed {graph.graph_replays} time(s); "
                f"against 4 eager DP steps bitwise equal {cmp['bitwise']}")
            if graph.graph_replays != 1:
                raise AssertionError("train_steps did not replay its graph")
        if not cmp["bitwise"] or cmp["steps"] != (4, 4):
            raise AssertionError(f"the graph's DP steps differ from eager "
                                 f"ones: {cmp['worst']}")
        del graph, eager, stacked

        # (c) sharded validation (phase 4's weights and videos), then
        # sharded ranks at BASELINE config 5's gallery size
        from cmhse_tpu_torch.models import CMHSE

        batches, _, _ = serving_data(torch, np, seed, n_videos)
        model = CMHSE(cfg.model, cfg.data.vocab_size,
                      generator=torch.Generator().manual_seed(seed))
        want, want_r = validate_metrics(model, batches, streaming=True,
                                        return_ranks=True)
        for mode in ("query", "gallery"):
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            got, got_r = validate_metrics(model, batches, streaming=True,
                                          return_ranks=True, mesh=mesh,
                                          mode=mode)
            torch.cuda.synchronize()
            launched = launch_counts()
            counts.update(launched)
            need_launches(f"9c validate_metrics ({mode})", launched,
                          ("gru_fwd", "rankcount"))
            log(f"  9c validate_metrics(mesh, mode={mode}, streaming) on "
                f"{n_videos} videos: {time.perf_counter() - t0:.3f} s, rsum "
                f"{got['rsum']:.4f}")
            if got != want or any(not np.array_equal(got_r[k], want_r[k])
                                  for k in want_r):
                raise AssertionError(f"sharded validation ({mode}) differs "
                                     f"from the single device's")
        gen = card_generator(torch, np.random.RandomState(seed + 11))
        v = l2norm(torch.randn(NCCL_GALLERY, 1024, device="cuda",
                               generator=gen))
        p = l2norm(v + 0.5 * torch.randn(NCCL_GALLERY, 1024, device="cuda",
                                         generator=gen))
        pos = torch.sum(v * p, dim=1)
        with torch.inference_mode():
            single = {True: rank_counts(v, p, pos, pos_idx=torch.arange(
                          NCCL_GALLERY, dtype=torch.int32, device="cuda")),
                      False: retrieval_ranks(v @ p.T)}
            for mode in ("query", "gallery"):
                for stream in (True, False):
                    cuda_lib.reset_launches()
                    got = sharded_ranks(v, p, mesh, mode=mode,
                                        streaming=stream)
                    launched = launch_counts()
                    counts.update(launched)
                    if stream:
                        need_launches(f"9c sharded_ranks ({mode})", launched,
                                      ("rankcount",))
                    if not torch.equal(got, single[stream]):
                        raise AssertionError(f"sharded_ranks {mode} "
                                             f"streaming={stream} differs")
        log(f"  9c sharded_ranks on {NCCL_GALLERY:,} rows, both modes, "
            "streaming and dense: equal to the single device's")
        del v, p, pos, single, model, batches

        # (d) sharded top-k, exact and int8 prepared
        g = l2norm(torch.randn(NCCL_TOPK_ROWS, 1024, device="cuda",
                               generator=gen))
        q = l2norm(torch.randn(NCCL_TOPK_QUERIES, 1024, device="cuda",
                               generator=gen))
        with torch.inference_mode():
            _, want_i = streaming_sim_topk(q, g, 10)
            _, want8 = quantized_sim_topk(q, prepare_topk_gallery(
                g, quantize=True), 10)
            cuda_lib.reset_launches()
            _, got_i = sharded_sim_topk(q, g, 10, mesh, streaming=True)
            exact = torch.equal(got_i, want_i)
            prep, rows = prepare_sharded_topk_gallery(g, mesh, quantize=True)
            _, got8 = sharded_sim_topk_prepared(q, prep, 10, mesh, rows,
                                                quantized=True)
        counts.update(launch_counts())
        log(f"  9d top-10 over {NCCL_TOPK_ROWS:,} rows, Q="
            f"{NCCL_TOPK_QUERIES}: sharded = streaming {exact}, sharded "
            f"int8 = int8 {torch.equal(got8, want8)}")
        if not exact or not torch.equal(got8, want8):
            raise AssertionError("the sharded top-k differs")
        del g, q, prep

        # (e) K1 and K2 while an all-reduce is in flight on NCCL's stream:
        # direct wrapper calls, not the path's, so not counted
        phase_nccl_busy(torch, np, rng_seed=seed, mesh=mesh)

        # (f) the DP step at every H: streamed (f32, bf16) and padded
        for h, dtype in ((STREAM_H, "float32"), (STREAM_H, "bfloat16"),
                         (PAD_H, "float32")):
            cfg_h, make_h, host_h = nccl_setup(torch, np, seed, 1,
                                               rnn_hidden=h, dtype=dtype)
            state = place_state(make_h(), mesh)
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            state, m = train_step(state, host_h[0], cfg_h.loss, mesh=mesh)
            torch.cuda.synchronize()
            got = launch_counts()
            counts.update(got)
            log(f"  9f DP step, cmhse_full at rnn_hidden {h} {dtype}: "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call), "
                f"loss {float(m['loss']):.6f}; launches {got}")
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"rnn_hidden {h}: non-finite loss")
            tag = "+streamed" if h == STREAM_H else ""
            need_launches(f"9f rnn_hidden {h} {dtype}", got,
                          ("gru_fwd", "gru_bwd", "simhinge"))
            if (got.get(f"gru_fwd {dtype} save_gates{tag}") != 4
                    or got.get(f"gru_bwd {dtype} zero_h0{tag}") != 4):
                raise AssertionError(f"rnn_hidden {h} {dtype}: launches "
                                     f"{got}")
            del state
    finally:
        torch.distributed.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()
        for var in env:
            os.environ.pop(var, None)
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{dict(counts)}")
    return dict(counts)


def need_launches(what: str, counts: dict, kernels) -> None:
    """Fail unless ``counts`` holds a launch of each of ``kernels``."""
    missing = [k for k in kernels if total(counts, k + " ") <= 0]
    if missing:
        raise AssertionError(f"{what} launched no {missing}: {counts}")


def phase_nccl_busy(torch, np, rng_seed: int, mesh) -> None:
    """9e: one K1 encode and one K2 backward at video_low's shape (512 x
    64, H = 1024) enqueued while an ``async_op`` all-reduce of
    NCCL_BUSY_MIB runs on the group's stream, against the same calls on a
    quiet card: equal bit for bit (the faulthandler watchdog of phase 9
    turns a hang into a failure)."""
    import torch.distributed as dist

    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.ops import gru_kernel as gk

    rng = np.random.RandomState(rng_seed + 13)
    lengths_np = rng.randint(0, 65, 512).astype(np.int32)
    x, w_i, w_h, b_i, b_h = gru_inputs(torch, rng, 512, 64, 1024, 1024)
    lengths = torch.from_numpy(lengths_np).cuda()
    xw = (x @ w_i + b_i).contiguous()
    gen = card_generator(torch, rng)
    douts = torch.randn(512, 64, 1024, device="cuda", generator=gen)

    def calls():
        outs, final = gk.gru_forward(xw, w_h, b_h, lengths)
        o, _, gates = gk.gru_forward(xw, w_h, b_h, lengths, save_gates=True)
        return (outs, final) + gk.gru_backward(gates, o, lengths, w_h, douts)

    with torch.no_grad():
        quiet = calls()
        torch.cuda.synchronize()
        buf = torch.ones(NCCL_BUSY_MIB * 2**18, device="cuda")
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        works = [dist.all_reduce(buf, group=mesh.group, async_op=True)
                 for _ in range(3)]
        busy = calls()
        for w in works:
            w.wait()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        need_launches("9e", launch_counts(), ("gru_fwd", "gru_bwd"))
    same = all(torch.equal(a, b) for a, b in zip(quiet, busy))
    log(f"  9e K1 x2 and K2 beside 3 all-reduces of {NCCL_BUSY_MIB} MiB in "
        f"flight: finished in {elapsed * 1e3:.1f} ms, equal to the quiet "
        f"run {same}; all-reduced value {buf[0].item():.0f}")
    if not same:
        raise AssertionError("K1/K2 beside an all-reduce differ from a "
                             "quiet run")


# phase 10: the Retriever's mesh; phase 11: the bench entry
SHARDED_SHARDS = 4  # shards of one local mesh, all on cuda:0
SHARDED_ROWS = 100_000  # unit rows, plus SHARDED_PAD invalid tail rows
SHARDED_PAD = 24
SHARDED_QUERIES = 1024
SHARDED_APPEND = 4096
BENCH_TIMEOUT_S = 300


def sharded_pool(torch, q, r, k: int):
    """The int8 candidate pools of a sharded Retriever, as global rows:
    ``int8_pool`` of each shard's form, offset by the shard's first row."""
    rows = r._prepared_shard_rows
    return torch.cat([int8_pool(torch, q, p, k) + shard * rows for
                      (shard, _), p in zip(r.mesh.local_shards(),
                                           r._prepared)], dim=1)


def phase_sharded(torch, np, rng, cli: dict, dmn: dict) -> dict:
    """10: the Retriever's mesh at full width (D = 1024) on a local mesh
    of SHARDED_SHARDS shards, all on cuda:0 (the shard and merge code is
    that of one shard a card): exact and int8 over SHARDED_ROWS spliced
    unit rows (+ SHARDED_PAD invalid), against one device's exact top-k
    after a build, an add (the shards rebuilt), a 1% remove and a
    compaction: every differing (query, rank) slot a near tie (exact) or
    a pool miss or near tie (int8), capture >= CAPTURE_FLOOR; build, add
    and query times and the merge's share. Then
    ``serve_daemon.build_context(sharded=True)`` on phase 7's run (a local
    mesh of every visible card): a text and a video_key request against a
    direct Retriever on the same mesh, the launch counts set to 0 just
    before the context and read after the requests. Returns them."""
    from cmhse_tpu_torch.cli import serve_daemon, sharded_mesh
    from cmhse_tpu_torch.data import PrecompDataset, batches_from_dataset
    from cmhse_tpu_torch.eval.encode import encode_gallery_device
    from cmhse_tpu_torch.eval.serve import (Retriever, text_query_batch,
                                            video_query_batch)
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.ops.similarity import l2norm
    from cmhse_tpu_torch.ops.topk import (quantized_sim_topk,
                                          streaming_sim_topk)
    from cmhse_tpu_torch.parallel import (eval_sharded, make_mesh,
                                          sharded_sim_topk_prepared)

    dev = torch.device("cuda", 0)
    mesh = make_mesh(devices=[dev] * SHARDED_SHARDS)
    gen = card_generator(torch, rng)
    n, d, k = SHARDED_ROWS, 1024, 10
    rows = n + SHARDED_PAD
    g = l2norm(torch.randn(rows, d, device=dev, generator=gen))
    valid = torch.arange(rows, device=dev) < n
    q = l2norm(torch.randn(SHARDED_QUERIES, d, device=dev, generator=gen))
    encoded = (g, g, valid, np.arange(rows))
    single = {"exact": Retriever(None), "int8": Retriever(None,
                                                          quantize=True)}
    sharded = {"exact": Retriever(None, mesh=mesh),
               "int8": Retriever(None, mesh=mesh, quantize=True)}
    for r in single.values():
        r.build_gallery(encoded=encoded)
    for name, r in sharded.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.build_gallery(encoded=encoded)
        torch.cuda.synchronize()
        log(f"  {name}: build_gallery over {SHARDED_SHARDS} shards "
            f"{time.perf_counter() - t0:.3f} s; {r._prepared_shard_rows:,} "
            f"rows a shard, chunks a shard "
            f"{tuple(r._prepared[0].chunks.shape)}")

    def check(stage: str) -> None:
        with torch.inference_mode():
            want = [torch.as_tensor(x, device=dev)
                    for x in single["exact"]._search(q, k)]
            for name, r in sharded.items():
                got = [torch.as_tensor(x, device=dev)
                       for x in r._search(q, k)]
                pool = (None if name == "exact"
                        else sharded_pool(torch, q, r, k))
                check_slots(f"10 {stage}: {name} over {SHARDED_SHARDS} "
                            f"shards vs one device's exact top-{k}",
                            classify_slots(torch, *want, *got, pool))

    check(f"{n:,} rows")
    with torch.inference_mode():
        se, s8 = sharded["exact"], sharded["int8"]
        srows = se._prepared_shard_rows
        ms = {
            "one device, exact": cuda_ms(lambda: streaming_sim_topk(
                q, single["exact"]._prepared, k), reps=5),
            "sharded, exact": cuda_ms(lambda: sharded_sim_topk_prepared(
                q, se._prepared, k, mesh, srows), reps=5),
            "one device, int8": cuda_ms(lambda: quantized_sim_topk(
                q, single["int8"]._prepared, k), reps=5),
            "sharded, int8": cuda_ms(lambda: sharded_sim_topk_prepared(
                q, s8._prepared, k, mesh, srows, quantized=True), reps=5),
        }
        parts = [(sc, ix + shard * srows) for (shard, _), (sc, ix) in zip(
            mesh.local_shards(), (streaming_sim_topk(q, p, k)
                                  for p in se._prepared))]
        merge_ms = cuda_ms(lambda: eval_sharded._merge_shard_candidates(
            parts, mesh, k))
    log(f"  top-{k}, Q={SHARDED_QUERIES}, {n:,} rows (ms): "
        + ", ".join(f"{name} {t:.3f}" for name, t in ms.items())
        + f"; the merge of {SHARDED_SHARDS} x {k} candidates {merge_ms:.4f}"
        f" ms, {100 * merge_ms / ms['sharded, exact']:.2f}% of the sharded "
        "exact call")
    del parts
    with torch.inference_mode():
        for name, fn in (
                ("sharded exact", lambda: sharded_sim_topk_prepared(
                    q, se._prepared, k, mesh, srows)),
                ("sharded int8", lambda: sharded_sim_topk_prepared(
                    q, s8._prepared, k, mesh, srows, quantized=True))):
            wall, busy, kernels = profile_kernels(torch, fn)
            log(f"  where one {name} call's device time goes "
                f"(torch.profiler): wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms")
            for kname, kms, calls in kernels:
                log(f"    {kms:.3f} ms ({100 * kms / busy:.1f}%) in {calls} "
                    f"call(s): {kname[:100]}")

    new = l2norm(torch.randn(SHARDED_APPEND, d, device=dev, generator=gen))
    added = (new, new, torch.ones(SHARDED_APPEND, dtype=torch.bool,
                                  device=dev),
             np.arange(rows, rows + SHARDED_APPEND))
    for name, r in list(single.items()) + list(sharded.items()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.add_to_gallery(encoded=added)
        torch.cuda.synchronize()
        if r.mesh is not None:
            log(f"  {name}: add {SHARDED_APPEND:,} rows, the shards "
                f"rebuilt: {time.perf_counter() - t0:.3f} s")
    check(f"+{SHARDED_APPEND:,} rows")
    drop = rng.choice(n, n // 100, replace=False).tolist()
    for r in list(single.values()) + list(sharded.values()):
        chunks = (None if r.mesh is None
                  else [p.chunks for p in r._prepared])
        if r.remove_from_gallery(drop) != len(drop):
            raise AssertionError("10: remove")
        if chunks is not None and any(
                p.chunks is not c for p, c in zip(r._prepared, chunks)):
            raise AssertionError("10: a remove rebuilt a shard")
    check(f"-{len(drop):,} rows (1%)")
    for r in list(single.values()) + list(sharded.values()):
        r.compact()
    check(f"compacted to {se.n_valid:,} rows")
    del single, sharded, se, s8, g, valid, q, encoded, new, added
    torch.cuda.empty_cache()

    # the daemon's context, on the mesh --sharded makes here
    run, data = cli["run"], cli["data"]
    model, cfg, vocab = dmn["model"], dmn["cfg"], dmn["vocab"]
    text, vkey = dmn["texts"][0], cli["val_keys"][0]
    local = sharded_mesh("gpu")
    ds = PrecompDataset(data, "val", vocab, feat_dim=cfg.data.feat_dim)
    enc = encode_gallery_device(
        model, batches_from_dataset(ds, cfg.data, shuffle=False),
        return_ids=True)
    direct_v, direct_t = (Retriever(model, mesh=local),
                          Retriever(model, mesh=local))
    direct_v.build_gallery(encoded=enc, side="video")
    direct_t.build_gallery(encoded=enc, side="text")
    ws, wi = direct_v.retrieve(*text_query_batch(
        vocab, [text], cfg.data.max_sentences, cfg.data.max_words), k=10)
    vs, vi = direct_t.retrieve_video(*video_query_batch(ds, cfg.data,
                                                        [vkey]), k=10)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    ctx = serve_daemon.build_context(run, data, "val", sharded=True)
    got_t = serve_daemon._handle_request({"query": text, "k": 10}, ctx)
    got_v = serve_daemon._handle_request({"video_key": vkey, "k": 10}, ctx)
    counts = launch_counts()
    log(f"  build_context(sharded=True): a local mesh of "
        f"{ctx['retriever'].mesh.data_size} shard(s) over the visible "
        f"cards; context and two requests {time.perf_counter() - t0:.2f} s;"
        f" launches {counts}")
    key_rows = {key: i for i, key in enumerate(ds.keys)}
    ids = enc[3]
    for what, got, want_s, want_i in (("text", got_t, ws, wi),
                                      ("video_key", got_v, vs, vi)):
        if "error" in got:
            raise AssertionError(f"10: the sharded daemon's {what} "
                                 f"request: {got}")
        same_hits(torch, f"10 sharded daemon {what} request vs a direct "
                  "Retriever on the same mesh", [got["results"]],
                  [[ds.keys[ids[j]] for j in row] for row in want_i],
                  want_s, key_rows)
    need_launches("10 the sharded daemon", counts, ("gru_fwd",))
    return counts


BENCH_METRICS = ("sim_matrix_qps_10k_gallery", "train_pairs_per_sec",
                 "model_gflops_per_pair", "achieved_tflops_per_sec", "mfu")
BENCH_GROUPS = {
    "rank_qps_100k": ("stream_f32", "stream_bf16mult", "dense_bf16mult",
                      "dense_f32"),
    "topk_qps_100k": ("stream", "stream_prepared", "dense"),
    "topk_standalone_qps_100k": ("stream_prepared",),
    "topk_standalone_ms_100k": ("stream_prepared",),
}


def phase_bench(torch) -> dict:
    """11: ``python -m cmhse_tpu_torch.cli.bench`` in a subprocess (a
    process of its own, counts from 0): its one JSON line must parse, with
    the value and every metric finite; its kernel launches (the line's
    ``launches``) must hold K1-K4. Returns them."""
    import math

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "cmhse_tpu_torch.cli.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"cli.bench: rc {out.returncode}, stdout "
                             f"{out.stdout[-2000:]!r}, stderr "
                             f"{out.stderr[-4000:]}")
    log(f"  cli.bench: {wall:.1f} s in its own process; its line:")
    log("  " + lines[0])
    res = json.loads(lines[0])
    ex = res["extras"]
    values = [("value", res["value"]), ("vs_baseline", res["vs_baseline"])]
    values += [(key, ex[key]) for key in BENCH_METRICS]
    for group, names in BENCH_GROUPS.items():
        values += [(f"{group}.{name}", (ex[group] or {}).get(name))
                   for name in names]
    bad = [key for key, v in values
           if not isinstance(v, (int, float)) or not math.isfinite(v)]
    if bad or ex["platform"] != "gpu":
        raise AssertionError(f"cli.bench: not finite {bad}, platform "
                             f"{ex['platform']}")
    launches = ex["launches"]
    need_launches("11 cli.bench", launches,
                  ("gru_fwd", "gru_bwd", "simhinge", "rankcount"))
    return launches


# phase 11b: the JAX package's other training presets at their published
# widths (vocab 10,000, word_dim 300, feat_dim 500, H = E = 1024)
PRESET_PARITY_BATCH = 8  # the card-vs-CPU steps, as 5c
PRESET_EPOCHS = 2
# didemo: 8-video length groups of this many correlated videos; the
# shortest group fits the 12-frame bucket, the longest takes 48
DIDEMO_PARITY_VIDEOS = 512
# didemo's cli.train run. At 512 synthetic videos every batch of 64 takes
# the top bucket (the shortest length group's longest clip has 26 frames
# from seed 0); from 640 on the shortest group fits the 24-frame bucket.
DIDEMO_CLI_VIDEOS = 768
DIDEMO_EVAL_VIDEOS = 256  # the reference-layout val split cli.evaluate ranks
DIDEMO_RESUME_VIDEOS = 256  # 4 steps an epoch at batch 64
DIDEMO_SNAPSHOT = 3  # snapshot_step of the resume check
DIDEMO_KILL_AFTER = 6  # killed in epoch 1, two length groups done
FLAT_TRAIN_VIDEOS = 100  # flat_anet_subset's own (BASELINE config 1)
FLAT_VAL_VIDEOS = 100
HIER_STEPS = 8
PRESET_CLI_TIMEOUT_S = 600
# (GRUs, ranking levels) a step: K1 save_gates and K2 once a GRU, K3 once a
# level; none of these presets has decoders, so no seeded (with_h0) launch.
# The products over a GRU's live row-steps: the projection and dX (but for
# the frames' GRU, whose input needs no gradient) in the row form, dW_i and
# dW_h in the reduction form.
PRESET_SHAPE = {"didemo": (4, 2), "hier_anet": (4, 2),
                "flat_anet_subset": (2, 1)}


def preset_step_launches(name: str) -> dict:
    """The kernel launches one train step of preset ``name`` makes."""
    grus, levels = PRESET_SHAPE[name]
    return {"gru_bwd float32 zero_h0": grus,
            "gru_fwd float32 save_gates": grus,
            "live_gemm float32 reduce": 2 * grus,
            "live_gemm float32 rows": 2 * grus - 1,
            "simhinge float32 pair": levels}


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bucket_of(batch) -> str:
    """A batch's bucket: frames a clip x words a sentence."""
    return f"{batch.frames.shape[2]}x{batch.words.shape[2]}"


class StepRecorder:
    """A stand-in for a train step function (``real``) that records each
    step's bucket, wall ms (from a synchronize to a synchronize) and kernel
    launches, then returns the real step's result."""

    def __init__(self, torch, real, dev) -> None:
        self.torch, self.real, self.dev = torch, real, dev
        self.steps: list[dict] = []

    def __call__(self, state, batch, loss_cfg, **kw):
        before = launch_counts()
        sync(self.torch, self.dev)
        t0 = time.perf_counter()
        out = self.real(state, batch, loss_cfg, **kw)
        sync(self.torch, self.dev)
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        self.steps.append(dict(
            bucket=bucket_of(batch), ms=ms,
            launches={k: n - before.get(k, 0) for k, n in after.items()
                      if n != before.get(k, 0)}))
        return out


def check_steps(what: str, steps: list, want: dict, dev) -> dict:
    """Log the steps' buckets with their counts and median ms, and fail
    unless (on the card) the first step of each bucket launched ``want``
    and every later one nothing (a replay of its graph). Returns {bucket:
    median ms}."""
    import numpy as np

    by = {}
    for s in steps:
        by.setdefault(s["bucket"], []).append(s["ms"])
    medians = {b: float(np.median(v)) for b, v in by.items()}
    log(f"  {what}: {len(steps)} steps (the first {steps[0]['ms']:.3f} ms); "
        "frames x words buckets, steps and median step ms: " + ", ".join(
            f"{b} {len(by[b])} steps {medians[b]:.3f} ms"
            for b in sorted(by, key=lambda b: tuple(map(int, b.split("x"))))))
    if dev.type == "cuda":
        seen = set()
        wrong = []
        for s in steps:
            first = s["bucket"] not in seen
            seen.add(s["bucket"])
            if s["launches"] != (want if first else {}):
                wrong.append(s)
        if wrong:
            raise AssertionError(f"{what}: launches a step {wrong[0]}, "
                                 f"expected {want} in a bucket's first "
                                 "step and none in a replay")
        log(f"  {what}: launches {want} in each bucket's first step, none "
            "in the replays")
    return medians


def preset_config(name: str, **data):
    """Preset ``name`` at its published widths, ``data`` overriding its
    DataConfig (the batch size)."""
    import dataclasses

    from cmhse_tpu_torch.config import get_preset

    cfg = get_preset(name)
    return cfg.replace(data=dataclasses.replace(cfg.data, **data))


def preset_examples(cfg, n: int, seed: int) -> list:
    """``n`` correlated synthetic videos at ``cfg``'s caps, drawn once
    (set-up), as phase 6's."""
    from cmhse_tpu_torch.data import CorrelatedSyntheticDataset

    d = cfg.data
    ds = CorrelatedSyntheticDataset(
        num_videos=n, feat_dim=d.feat_dim, vocab_size=d.vocab_size,
        max_clips=d.max_clips, max_frames=d.max_frames,
        max_words=d.max_words, seed=seed)
    return [ds[i] for i in range(n)]


def preset_fit_config(cfg, ckpt_dir: str, seed: int, **train):
    """``cfg`` trained PRESET_EPOCHS epochs into ``ckpt_dir``, logging each
    step, lr decay each epoch, validation at each epoch's end only."""
    import dataclasses

    over = dict(num_epochs=PRESET_EPOCHS, lr_update=1, val_step=0,
                snapshot_step=0, log_step=1, seed=seed,
                checkpoint_dir=ckpt_dir)
    over.update(train)
    return cfg.replace(train=dataclasses.replace(cfg.train, **over))


def cli_train_child(out_path: str, argv: list) -> None:
    """Phase 11b's ``python -m cmhse_tpu_torch.cli.train`` run, in its own
    process: the module run as ``-m`` runs it (runpy, ``__main__``), with
    ``train.loop.train_step`` wrapped by a StepRecorder. Writes to
    ``out_path`` as JSON: the exit code, the steps and the process's kernel
    launches."""
    import runpy

    import torch

    import cmhse_tpu_torch.train.loop as loop_mod
    from cmhse_tpu_torch.device import resolve_device

    cpu = "--platform" in argv and argv[argv.index("--platform") + 1] == "cpu"
    dev = resolve_device("cpu" if cpu else None)
    rec = StepRecorder(torch, loop_mod.train_step, dev)
    sys.argv = ["cmhse_tpu_torch.cli.train", *argv]
    rc = None
    with patched(loop_mod, "train_step", rec):
        try:
            runpy.run_module("cmhse_tpu_torch.cli.train", run_name="__main__",
                             alter_sys=True)
        except SystemExit as e:
            rc = e.code
    with open(out_path, "w") as f:
        json.dump(dict(rc=rc, steps=rec.steps, launches=launch_counts()), f)


def preset_kernel_rows(torch, rng, didemo_batch, flat_batch) -> dict:
    """K1 (encode, save_gates) and K2 against their plain versions, with
    cuDNN's times, at flat_anet_subset's video_low (32 x 128, D = 500) and
    text_low (32 x 96, D = 300) and at didemo's largest bucket's video_low
    (384 x 48, D = 500), with the lengths of one batch of each; K3 at 384
    rows (didemo's low level at batch 64)."""
    b = flat_batch
    shapes = [
        (f"flat video_low {b.frames.shape[0]}x{b.frames.shape[2]} D=500",
         b.frame_len[:, 0].copy(), b.frames.shape[2], 500),
        (f"flat text_low {b.words.shape[0]}x{b.words.shape[2]} D=300",
         b.word_len[:, 0].copy(), b.words.shape[2], 300),
        (f"didemo video_low {didemo_batch.frame_len.size}x"
         f"{didemo_batch.frames.shape[2]} D=500",
         didemo_batch.frame_len.reshape(-1).copy(),
         didemo_batch.frames.shape[2], 500),
    ]
    encode = phase_gru(torch, rng, shapes)
    fwd, bwd = phase_gru_train(torch, rng,
                               [(*s, False) for s in shapes])
    n_low = didemo_batch.frame_len.size
    return dict(encode=encode, save_gates=fwd, bwd=bwd,
                simhinge=phase_simhinge(torch, rng, (n_low,)))


def phase_presets(torch, np, seed: int, root: str, dev) -> dict:
    """11b: didemo, flat_anet_subset and hier_anet at their published
    widths on correlated synthetic data, random weights from ``seed``,
    on ``dev``. Returns the launches of the runs that drive each preset's
    path (each counted from 0 and read after it) and the kernel rows."""
    import collections
    import dataclasses
    import importlib.util
    import os

    import cmhse_tpu_torch.train.loop as loop_mod
    from cmhse_tpu_torch.cli import build_vocab, evaluate
    from cmhse_tpu_torch.data import Prefetcher, batches_from_dataset
    from cmhse_tpu_torch.data.fixtures import write_reference_dataset
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.train import (create_train_state,
                                       set_learning_rate, train_step)
    from cmhse_tpu_torch.train.checkpoint import CheckpointManager

    counts = collections.Counter()
    rng = np.random.RandomState(seed + 11)
    on_card = dev.type == "cuda"
    platform = [] if on_card else ["--platform", "cpu"]

    # ---- didemo: bucketed, length-grouped batches, one step a dispatch ----
    didemo = preset_config("didemo", batch_size=PRESET_PARITY_BATCH)
    dc = didemo.data
    log(f"  didemo: Cmax {dc.max_clips} Fmax {dc.max_frames} Smax "
        f"{dc.max_sentences} Wmax {dc.max_words}, buckets frames "
        f"{dc.frame_buckets} words {dc.word_buckets}, fixed_shape "
        f"{dc.fixed_shape}, group_by_length {dc.group_by_length}; model "
        f"{didemo.model}; loss {didemo.loss}")
    examples = preset_examples(didemo, DIDEMO_PARITY_VIDEOS, seed + 3)
    grouped = list(batches_from_dataset(
        examples, dc, shuffle=True, seed=seed, fixed_shape=False,
        group_by_length=True))

    def size(b):
        return b.frames.shape[2] * b.words.shape[2]

    small, large = min(grouped, key=size), max(grouped, key=size)
    if size(small) == size(large):
        raise AssertionError("didemo's batches of 8 took one bucket")
    for b in (small, large):
        zero = int((b.frame_len == 0).sum())
        step_parity(torch, didemo, b, seed,
                    f"didemo batch 8, bucket {bucket_of(b)} ({zero} of "
                    f"{b.frame_len.size} clip rows empty)", dev)

    # the pinned ring grows when a larger bucket follows a smaller one:
    # the first pass over an epoch's batches pays for the allocations
    pre = Prefetcher(dev)
    pass_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in pre(grouped):
            pass
        sync(torch, dev)
        pass_ms.append((time.perf_counter() - t0) * 1e3)
    for host, (_, got) in zip(grouped, pre(grouped)):
        want = host.to(dev)
        for f in dataclasses.fields(host):
            if not torch.equal(torch.as_tensor(getattr(got, f.name)),
                               getattr(want, f.name)):
                raise AssertionError(f"prefetched {f.name} differs")
    log(f"  prefetch of {len(grouped)} bucketed batches of 8 (host ms, "
        f"through the pinned ring): first pass {pass_ms[0]:.3f} (buffers "
        f"grown), second {pass_ms[1]:.3f}; every batch equal to Batch.to's")

    run = os.path.join(root, "didemo_cli")
    mc = didemo.model  # the preset's own widths, spelled out
    argv = ["--preset", "didemo", "--synthetic", "--correlated",
            "--synthetic_videos", str(DIDEMO_CLI_VIDEOS), "--num_epochs",
            str(PRESET_EPOCHS), "--vocab_size", str(dc.vocab_size),
            "--word_dim", str(mc.word_dim), "--feat_dim", str(mc.feat_dim),
            "--rnn_hidden", str(mc.rnn_hidden), "--embed_size",
            str(mc.embed_size), "--log_step", "1", "--seed", str(seed),
            "--logger_name", run] + platform
    out_path = os.path.join(root, "didemo_cli.json")
    log("  python -m cmhse_tpu_torch.cli.train " + " ".join(argv)
        + " (its own process; each step timed)")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         f"cli_train_child({out_path!r}, {argv!r})"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=PRESET_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out_path):
        raise AssertionError(f"cli.train --preset didemo: rc "
                             f"{proc.returncode}\n{proc.stderr[-4000:]}")
    with open(out_path) as f:
        child = json.load(f)
    if child["rc"] not in (0, None):
        raise AssertionError(f"cli.train --preset didemo exited {child['rc']}")
    counts.update(child["launches"])
    log_path = os.path.join(run, "log.jsonl")
    losses = [e["loss"] for e in jsonl(log_path, "train_step")]
    epochs = jsonl(log_path, "epoch_end")
    medians = check_steps("didemo cli.train", child["steps"],
                          preset_step_launches("didemo"), dev)
    log(f"  didemo cli.train: {wall:.2f} s in its own process; epoch "
        "seconds " + ", ".join(f"{e['seconds']:.3f}" for e in epochs)
        + f"; validations (rsum) " + ", ".join(
            f"{e['rsum']:.2f}" for e in jsonl(log_path, "validate"))
        + f"; launches in the process {child['launches']}")
    log("  losses: " + json.dumps(losses))
    if len(medians) < 2:
        raise AssertionError(f"didemo's cli.train saw one bucket: {medians}")
    if len(losses) != len(child["steps"]) or not all(np.isfinite(losses)) \
            or not min(losses[1:]) < losses[0]:
        raise AssertionError(f"didemo's losses {losses}")
    if not os.path.exists(os.path.join(run, "best")):
        raise AssertionError("didemo's cli.train wrote no best checkpoint")

    data = os.path.join(root, "didemo_data")
    layout = "h5" if importlib.util.find_spec("h5py") else "npy"
    write_reference_dataset(
        data, n_train=8, n_val=DIDEMO_EVAL_VIDEOS, feat_dim=dc.feat_dim,
        seed=seed, features=layout, clips=(1, dc.max_clips + 1),
        rows=(4, dc.max_frames + 1))
    if build_vocab.main(["--data_path", data, "--threshold", "1",
                         *platform]) != 0:
        raise AssertionError("build_vocab")
    dump = os.path.join(root, "didemo_ranks.jsonl")
    eval_argv = [os.path.join(run, "best"), "--data_path", data,
                 "--streaming", "--dump_ranks", dump] + platform
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    if evaluate.main(eval_argv) != 0:
        raise AssertionError("cli.evaluate of didemo's best")
    sync(torch, dev)
    eval_counts = launch_counts()
    counts.update(eval_counts)
    log(f"  cli.evaluate {' '.join(eval_argv)}: "
        f"{time.perf_counter() - t0:.2f} s (in this process), "
        f"{DIDEMO_EVAL_VIDEOS} reference-layout val videos of 1-"
        f"{dc.max_clips} clips of 4-{dc.max_frames} rows; launches "
        f"{eval_counts}")
    if on_card and total(eval_counts, "rankcount float32") != 2:
        raise AssertionError(f"cli.evaluate --streaming: {eval_counts}")
    dump_against_dense(torch, np, os.path.join(run, "best"), data,
                       dump_rows(dump), dev)

    # a bucketed run killed mid-epoch and resumed from its snapshot
    resume = preset_config("didemo")
    train = preset_examples(resume, DIDEMO_RESUME_VIDEOS, seed + 4)
    cfg_a = preset_fit_config(resume, os.path.join(root, "didemo_a"), seed,
                              snapshot_step=DIDEMO_SNAPSHOT)
    rec = StepRecorder(torch, loop_mod.train_step, dev)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    with patched(loop_mod, "train_step", rec):
        state_a, _ = loop_mod.fit(cfg_a, train, None, device=dev)
    fit_s = time.perf_counter() - t0
    counts.update(launch_counts())
    check_steps("didemo fit (the uninterrupted run)", rec.steps,
                preset_step_launches("didemo"), dev)
    calls = {"n": 0}
    real_step = loop_mod.train_step

    def killer(state, batch, loss_cfg, **kw):
        if calls["n"] >= DIDEMO_KILL_AFTER:
            raise Killed()
        calls["n"] += 1
        return real_step(state, batch, loss_cfg, **kw)

    cfg_b = preset_fit_config(resume, os.path.join(root, "didemo_b"), seed,
                              snapshot_step=DIDEMO_SNAPSHOT)
    with patched(loop_mod, "train_step", killer):
        try:
            loop_mod.fit(cfg_b, train, None, device=dev)
            raise AssertionError("the didemo run was not killed")
        except Killed:
            pass
    mgr = CheckpointManager(cfg_b.train.checkpoint_dir)
    snap = torch.load(os.path.join(mgr.ckpt_dir, str(mgr.latest_step())),
                      weights_only=True)
    where = (snap["step"], snap["epoch"], snap["groups_done"])
    per_epoch = -(-DIDEMO_RESUME_VIDEOS // resume.data.batch_size)
    if where != (DIDEMO_KILL_AFTER, DIDEMO_KILL_AFTER // per_epoch,
                 DIDEMO_KILL_AFTER % per_epoch):
        raise AssertionError(f"didemo's snapshot (step, epoch, groups) "
                             f"{where}")
    cfg_r = preset_fit_config(resume, cfg_b.train.checkpoint_dir, seed,
                              snapshot_step=DIDEMO_SNAPSHOT,
                              resume=cfg_b.train.checkpoint_dir)
    state_b, _ = loop_mod.fit(cfg_r, train, None, device=dev)
    cmp = compare_states(torch, state_a.state_dict(), state_b.state_dict())
    log(f"  didemo bucketed fit, {DIDEMO_RESUME_VIDEOS} videos at batch "
        f"{resume.data.batch_size}: {fit_s:.2f} s; killed after step "
        f"{DIDEMO_KILL_AFTER}, resumed from its snapshot (step, epoch, "
        f"groups) {where}: steps {cmp['steps']}, bitwise equal "
        f"{cmp['bitwise']}, worst {cmp['worst'][0]} {cmp['worst'][1]:.3g}")
    if not cmp["bitwise"] or cmp["steps"][0] != cmp["steps"][1]:
        raise AssertionError("didemo's resumed run differs from the "
                             "uninterrupted one")
    largest = next(batches_from_dataset(train, resume.data, shuffle=False))
    del state_a, state_b

    # ---- flat_anet_subset: one GRU a modality, T = 128 / 96 ----
    flat = preset_config("flat_anet_subset")
    fd = flat.data
    log(f"  flat_anet_subset: batch {fd.batch_size}, Fmax {fd.max_frames} "
        f"Wmax {fd.max_words}, model {flat.model}, loss {flat.loss}")
    flat8 = preset_config("flat_anet_subset",
                          batch_size=PRESET_PARITY_BATCH)
    step_parity(torch, flat8, next(batches_from_dataset(
        preset_examples(flat8, PRESET_PARITY_BATCH, seed + 5), flat8.data,
        shuffle=False)), seed, "flat_anet_subset batch 8", dev)
    train = preset_examples(flat, FLAT_TRAIN_VIDEOS, seed + 6)
    val = preset_examples(flat, FLAT_VAL_VIDEOS, seed + 7)
    cfg_f = preset_fit_config(flat, os.path.join(root, "flat"), seed)
    rec = StepRecorder(torch, loop_mod.train_step, dev)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    with patched(loop_mod, "train_step", rec):
        _, best = loop_mod.fit(cfg_f, train, val, device=dev)
    fit_s = time.perf_counter() - t0
    counts.update(launch_counts())
    check_steps("flat_anet_subset fit", rec.steps,
                preset_step_launches("flat_anet_subset"), dev)
    log_path = os.path.join(cfg_f.train.checkpoint_dir, "log.jsonl")
    losses = [e["loss"] for e in jsonl(log_path, "train_step")]
    log(f"  flat_anet_subset fit: {fit_s:.2f} s, epoch seconds "
        + ", ".join(f"{e['seconds']:.3f}"
                    for e in jsonl(log_path, "epoch_end"))
        + f"; best rsum {best:.2f}; losses {json.dumps(losses)}")
    if not all(np.isfinite(losses)) or not np.isfinite(best) or \
            not os.path.exists(os.path.join(cfg_f.train.checkpoint_dir,
                                            "best")):
        raise AssertionError("flat_anet_subset's fit")
    flat_batch = next(batches_from_dataset(train, fd, shuffle=False))

    # ---- hier_anet: hierarchical, last-state readouts, no decoders ----
    hier = preset_config("hier_anet")
    hier8 = preset_config("hier_anet", batch_size=PRESET_PARITY_BATCH)
    step_parity(torch, hier8, next(batches_from_dataset(
        preset_examples(hier8, PRESET_PARITY_BATCH, seed + 8), hier8.data,
        shuffle=False)), seed, "hier_anet batch 8", dev)
    batch = next(batches_from_dataset(
        preset_examples(hier, hier.data.batch_size, seed + 9), hier.data,
        shuffle=False))
    model = CMHSE(hier.model, hier.data.vocab_size, device=dev,
                  generator=torch.Generator().manual_seed(seed))
    state = set_learning_rate(create_train_state(hier, model), TRAIN_LR)
    rec = StepRecorder(torch, train_step, dev)
    cuda_lib.reset_launches()
    hier_losses = []
    for _ in range(HIER_STEPS):
        state, m = rec(state, batch, hier.loss)
        hier_losses.append(float(m["loss"]))
    counts.update(launch_counts())
    check_steps(f"hier_anet, {HIER_STEPS} train_steps on one batch of "
                f"{hier.data.batch_size} at lr {TRAIN_LR}", rec.steps,
                preset_step_launches("hier_anet"), dev)
    log(f"  hier_anet losses: {json.dumps(hier_losses)}")
    if not all(np.isfinite(hier_losses)):
        raise AssertionError(f"hier_anet's losses {hier_losses}")
    del state, model

    rows = (preset_kernel_rows(torch, rng, largest, flat_batch)
            if on_card else {})
    log(f"  phase 11b launches (the preset runs): {dict(counts)}")
    return dict(counts=dict(counts), rows=rows)


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
    phase(f"phase 2e: gru_fwd and gru_bwd at every H: {STREAM_H} (the "
          f"streamed variants, f32 and bf16) and {PAD_H} (padded) vs plain")
    for source in ("gru_fwd_streamed.cu", "gru_bwd_streamed.cu"):
        for line in kernel_resources(source):
            log(f"  ptxas {source}: {line}")
    any_h = phase_gru_any_h(torch, rng, b0.frame_len.reshape(-1),
                            dc.max_frames, 500)
    phase("phase 2f: live_gemm (the products over the GRU's live row-steps) "
          "vs plain at video_low, text_low and video_high, the main path's "
          "lengths and full density")
    for line in kernel_resources("live_gemm.cu"):
        log(f"  ptxas live_gemm.cu: {line}")
    lg_rows = phase_live_gemm(torch, rng, enc_shapes[:3])
    phase("phase 2g: the routed experts' grouped products (live_gemm.cu's "
          "moe_* kernels) vs plain and a per-expert torch.matmul loop at "
          "DeepSeek-V2-Lite's widths")
    phase_moe_grouped(torch, rng)
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
    phase("phase 4c: serving path in bf16 (dtype and feature_dtype "
          "bfloat16), same weights and batches")
    bf16_serve = phase_serving_bf16(torch, np, main_out)
    bf16_counts = bf16_serve["counts"]
    phase_encode_pipeline(torch, np, bf16_serve["model"],
                          bf16_serve["batches"])
    del main_out, bf16_serve
    phase(f"phase 5: training path at full cmhse_full width ({TRAIN_STEPS} "
          "train_steps, then validate_metrics)")
    train_out = phase_train(torch, np, args.seed)
    tcounts = train_out["counts"]
    del train_out
    phase("phase 5c: one train step at batch 8, card vs CPU")
    phase_train_parity(torch, np, args.seed)
    phase(f"phase 5d: training path in bf16 ({TRAIN_STEPS} train_steps, "
          "then validate_metrics)")
    bf16_train = phase_train(torch, np, args.seed, bf16=True)
    bcounts = bf16_train["counts"]
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
    phase("phase 6e: phase 5's batch, numpy-drawn weights, lr 1e-3 "
          "(scripts/lr_rise_check.py's card run)")
    phase_lr_check(torch, np, args.seed)
    phase("phase 7a: the native packer vs pad_batch (64 of phase 6's videos)")
    phase_packer(torch, np, train_ds, fit_out["epoch_s"])
    del train_ds, val_ds
    import collections
    import shutil
    import tempfile

    cli_root = tempfile.mkdtemp(prefix="cmhse_cli_")
    try:
        phase("phase 7: the command-line chain at full cmhse_full width")
        cli_out = phase_cli(torch, np, args.seed, cli_root)
        ccounts = cli_out["counts"]
        phase(f"phase 8a: int8 two-stage top-k vs exact, {INT8_ROWS:,} rows, "
              f"Q={INT8_QUERIES} (Retriever)")
        phase_int8(torch, np, rng)
        phase("phase 8b: serve_daemon.main at full width on phase 7's best "
              "checkpoint (--socket --warm --batch_window_ms 2)")
        dmn = phase_daemon(torch, np, args.seed, cli_out)
        dcounts = collections.Counter(dmn.pop("counts"))
        phase(f"phase 8c: a daemon context with {SPLICE_ROWS:,} spliced rows, "
              "--quantized")
        dcounts.update(phase_splice(torch, np, cli_out, dmn))
        phase(f"phase 8d: scripts/torch_serve_soak.py at its defaults for "
              f"{SOAK_SECONDS} s (query clients, add -> remove churn)")
        soak_counts = phase_soak(torch)
        phase("phase 9: one NCCL rank (world size 1): DP steps, their graph, "
              "sharded validation and top-k, K1/K2 beside an all-reduce, "
              "every H")
        ncounts = phase_nccl(torch, np, args.seed, args.videos)
        phase(f"phase 10: the Retriever's mesh, {SHARDED_SHARDS} shards on "
              f"cuda:0, {SHARDED_ROWS:,} rows; the daemon's --sharded "
              "context on phase 7's run")
        scounts = phase_sharded(torch, np, rng, cli_out, dmn)
        del dmn
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)
    phase("phase 11: python -m cmhse_tpu_torch.cli.bench")
    bcounts_bench = phase_bench(torch)
    phase("phase 11b: the JAX package's other training presets at their "
          "published widths: didemo, flat_anet_subset, hier_anet")
    presets_root = tempfile.mkdtemp(prefix="cmhse_presets_")
    try:
        presets = phase_presets(torch, np, args.seed, presets_root,
                                torch.device("cuda"))
    finally:
        shutil.rmtree(presets_root, ignore_errors=True)
    pcounts, prows = presets["counts"], presets["rows"]

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
    def resident(prefix):  # phase 9's launches of the resident variants
        return sum(n for k, n in ncounts.items()
                   if k.startswith(prefix) and not k.endswith("+streamed"))

    def streamed(row_key, name, kernel, dtype, only=None):
        """An entry of a streamed variant: its launches in 9f, of every
        variant of the kernel or only of ``only``."""
        return entry(name, f"{kernel}_streamed.cu",
                     k1 if kernel == "gru_fwd" else k2,
                     [any_h[row_key]], "nccl (9f)",
                     sum(n for k, n in ncounts.items()
                         if k.startswith(f"{kernel} {dtype}")
                         and k.endswith("+streamed")
                         and only in (None, k.split()[-1])),
                     variant=f"streamed W_h (H > {kernel}'s resident limit)"
                     + (f", {only}" if only else ""))

    entries = [
        entry("gru_fwd", "gru_fwd.cu", k1,
              gru_rows + fwd_rows + [any_h[("gru_fwd", "float32", PAD_H)],
                                     any_h[("gru_fwd save_gates", "float32",
                                            PAD_H)]]
              + prows["encode"] + prows["save_gates"],
              "serve+train+fit+cli+daemon+soak+nccl+sharded+bench+presets",
              total(counts, "gru_fwd float32")
              + total(tcounts, "gru_fwd float32")
              + total(fcounts, "gru_fwd float32")
              + total(ccounts, "gru_fwd float32")
              + total(dcounts, "gru_fwd float32")
              + total(soak_counts, "gru_fwd float32")
              + resident("gru_fwd float32")
              + total(scounts, "gru_fwd float32")
              + total(bcounts_bench, "gru_fwd float32")
              + total(pcounts, "gru_fwd float32"),
              launches_by_path={"serve": total(counts, "gru_fwd"),
                                "train": total(tcounts, "gru_fwd"),
                                "fit": total(fcounts, "gru_fwd"),
                                "cli": total(ccounts, "gru_fwd"),
                                "daemon": total(dcounts, "gru_fwd"),
                                "soak": total(soak_counts, "gru_fwd"),
                                "nccl": resident("gru_fwd"),
                                "sharded": total(scounts, "gru_fwd"),
                                "bench": total(bcounts_bench, "gru_fwd"),
                                "presets": total(pcounts, "gru_fwd")},
              launches_train_by_variant={
                  k: n for k, n in tcounts.items() if k.startswith("gru_fwd")},
              launches_fit_by_variant={k: n for k, n in fcounts.items()
                                       if k.startswith("gru_fwd")},
              launches_cli_by_variant={k: n for k, n in ccounts.items()
                                       if k.startswith("gru_fwd")},
              launches_presets_by_variant={k: n for k, n in pcounts.items()
                                           if k.startswith("gru_fwd")}),
        entry("gru_bwd", "gru_bwd.cu", k2,
              bwd_rows + [any_h[("gru_bwd", "float32", PAD_H)]]
              + prows["bwd"],
              "train+fit+cli+nccl+bench+presets",
              total(tcounts, "gru_bwd float32")
              + total(fcounts, "gru_bwd float32")
              + total(ccounts, "gru_bwd float32")
              + resident("gru_bwd float32")
              + total(bcounts_bench, "gru_bwd float32")
              + total(pcounts, "gru_bwd float32"),
              launches_by_path={"train": total(tcounts, "gru_bwd"),
                                "fit": total(fcounts, "gru_bwd"),
                                "cli": total(ccounts, "gru_bwd"),
                                "nccl": resident("gru_bwd"),
                                "bench": total(bcounts_bench, "gru_bwd"),
                                "presets": total(pcounts, "gru_bwd")}),
        entry("live_gemm", "live_gemm.cu",
              "none (the products over the row-steps the JAX package leaves "
              "to XLA)", lg_rows,
              "serve+train+fit+cli+daemon+nccl+bench+presets",
              sum(total(c, "live_gemm") for c in (
                  counts, tcounts, fcounts, ccounts, dcounts, ncounts,
                  bcounts_bench, pcounts)),
              launches_by_path={"serve": total(counts, "live_gemm"),
                                "train": total(tcounts, "live_gemm"),
                                "fit": total(fcounts, "live_gemm"),
                                "cli": total(ccounts, "live_gemm"),
                                "daemon": total(dcounts, "live_gemm"),
                                "nccl": total(ncounts, "live_gemm"),
                                "bench": total(bcounts_bench, "live_gemm"),
                                "presets": total(pcounts, "live_gemm")},
              launches_train_by_variant={
                  k: n for k, n in tcounts.items()
                  if k.startswith("live_gemm")}),
        entry("simhinge", "simhinge.cu", "cmhse_tpu/ops/pallas_sim.py:58",
              sh_rows + prows["simhinge"], "train+fit+cli+nccl+bench+presets",
              total(tcounts, "simhinge") + total(bcounts, "simhinge")
              + total(fcounts, "simhinge") + total(ccounts, "simhinge")
              + total(ncounts, "simhinge")
              + total(bcounts_bench, "simhinge")
              + total(pcounts, "simhinge"),
              launches_by_path={"train": total(tcounts, "simhinge"),
                                "train bf16": total(bcounts, "simhinge"),
                                "fit": total(fcounts, "simhinge"),
                                "cli": total(ccounts, "simhinge"),
                                "nccl": total(ncounts, "simhinge"),
                                "bench": total(bcounts_bench, "simhinge"),
                                "presets": total(pcounts, "simhinge")},
              ms_from="CUDA-graph replay of one call (graph_ms)",
              call_ms=sh_rows[0]["call_ms"]),
        entry("rankcount", "rankcount.cu", k4, rc_rows,
              "serve+train+cli+nccl+bench+presets",
              total(counts, "rankcount float32")
              + total(tcounts, "rankcount float32")
              + total(ccounts, "rankcount float32")
              + total(ncounts, "rankcount float32")
              + total(bcounts_bench, "rankcount float32")
              + total(pcounts, "rankcount float32"),
              launches_by_path={"serve": total(counts, "rankcount"),
                                "train": total(tcounts, "rankcount"),
                                "cli": total(ccounts, "rankcount"),
                                "nccl": total(ncounts, "rankcount"),
                                "bench": total(bcounts_bench, "rankcount"),
                                "presets": total(pcounts, "rankcount")}),
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
        streamed(("gru_fwd", "float32", STREAM_H), "gru_fwd streamed",
                 "gru_fwd", "float32"),
        streamed(("gru_fwd", "bfloat16", STREAM_H), "gru_fwd bf16 streamed",
                 "gru_fwd", "bfloat16"),
        streamed(("gru_fwd save_gates", "float32", STREAM_H),
                 "gru_fwd streamed save_gates", "gru_fwd", "float32",
                 only="save_gates+streamed"),
        streamed(("gru_fwd save_gates", "bfloat16", STREAM_H),
                 "gru_fwd bf16 streamed save_gates", "gru_fwd", "bfloat16",
                 only="save_gates+streamed"),
        streamed(("gru_bwd", "float32", STREAM_H), "gru_bwd streamed",
                 "gru_bwd", "float32"),
        streamed(("gru_bwd", "bfloat16", STREAM_H), "gru_bwd bf16 streamed",
                 "gru_bwd", "bfloat16"),
    ]
    for e in entries:
        if e["launches"] <= 0:
            raise AssertionError(f"kernel {e['name']} was not launched on "
                                 f"its path ({e['path']})")
        if "cli" in e.get("launches_by_path", {}) and \
                e["launches_by_path"]["cli"] <= 0:
            raise AssertionError(f"the command-line chain launched no "
                                 f"{e['name']}")
        if "daemon" in e.get("launches_by_path", {}) and \
                e["launches_by_path"]["daemon"] <= 0:
            raise AssertionError(f"the serving daemon launched no "
                                 f"{e['name']}")
        if "nccl" in e.get("launches_by_path", {}) and \
                e["launches_by_path"]["nccl"] <= 0:
            raise AssertionError(f"phase 9 (NCCL) launched no {e['name']}")
        for path, where in (("soak", "phase 8d (the daemon soak)"),
                            ("sharded", "phase 10 (the sharded daemon)"),
                            ("bench", "phase 11 (cli.bench)"),
                            ("presets", "phase 11b (the presets)")):
            if e.get("launches_by_path", {}).get(path, 1) <= 0:
                raise AssertionError(f"{where} launched no {e['name']}")
    phase("done")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
