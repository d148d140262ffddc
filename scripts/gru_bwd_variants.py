#!/usr/bin/env python3
"""Time design variants of the gru_bwd kernel (``csrc/gru_bwd.cu``) in turns
on one CUDA card, against the source as committed::

    python3 scripts/gru_bwd_variants.py

Each variant is the committed source with a few text substitutions; each
is built into a directory of its own under ``cmhse_tpu_torch/_build/`` and
loaded beside the others. Every variant runs K2 at video_low 512x64 and the
64x8 decoder (seeded), H = 1024, f32 and bf16, on the lengths of
``chip_smoke.py``'s first batch, in turns (the list forwards, then
backwards); each time is the mean of 10 calls (CUDA events), each error
K2's largest against its plain version. The "clock split" variant also
reports block 0's ``clock64()`` cycles by phase of the time loop: phase 1
(gate gradients, every row), the load of the step's live-row count
(``counts[t]``), the grid barrier and the product. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_SLABS = "  const int n_slabs = (3 * H + kK - 1) / kK;\n"
GRID_SYNC = ("    cg::this_grid().sync();  // dxw[:, t] and dhn[:, t] are "
             "complete\n")
FINISH = "  // the staging buffers are free for the bias sums' partials\n"
ROTATE = (N_SLABS
          + "  const int s0 = (int)((long long)blockIdx.x * n_slabs / "
          "gridDim.x);\n"
          "  auto rot = [&](int s) { return (s + s0) % n_slabs; };\n")

# variant name -> [(old text, new text, occurrences)]
VARIANTS = {
    "as committed": [],
    # each block starts its walk over the depth at its own slab
    "own start slab": [
        (N_SLABS, ROTATE, 2),
        ("rows_s, rows,\n                s, t, T, H, tid);",
         "rows_s, rows,\n                rot(s), t, T, H, tid);", 1),
        ("      const int k = s * kK + 4 * kq;",
         "      const int k = rot(s) * kK + 4 * kq;", 1),
        ("rows_s, rows,\n                   s, t, T, H, tid);",
         "rows_s, rows,\n                   rot(s), t, T, H, tid);", 1),
        ("b_base, s * kK);", "b_base, rot(s) * kK);", 1),
        ("rows_s, rows, 0, t, T, H, tid);",
         "rows_s, rows, rot(0), t, T, H, tid);", 1),
        ("rows_s, rows, s + 1, t, T, H, tid);",
         "rows_s, rows, rot(s + 1), t, T, H, tid);", 1),
        ("b_base,\n                          s * kK);",
         "b_base,\n                          rot(s) * kK);", 1),
    ],
    "four stages": [("constexpr int kStages = 3;",
                     "constexpr int kStages = 4;", 1)],
    "f32 64-depth slabs": [
        ("  static constexpr int kSlabBytes = 128;  // 32 depths\n"
         "  static constexpr int kRowBytes = 144;",
         "  static constexpr int kSlabBytes = 256;  // 64 depths\n"
         "  static constexpr int kRowBytes = 272;", 1)],
    "clock split": [
        ("namespace {\n\nusing gru::commit_staged;",
         "namespace {\n__device__ unsigned long long g_prof[4];\n"
         "using gru::commit_staged;", 1),
        ("  for (int t = T - 1; t >= 0; --t) {\n",
         "  long long pc[4] = {0, 0, 0, 0};\n"
         "  for (int t = T - 1; t >= 0; --t) {\n"
         "    long long c_a = clock64();\n", 1),
        ("    const int n_t = counts[t];",
         "    long long c_b = clock64(); pc[0] += c_b - c_a;\n"
         "    const int n_t = counts[t];", 1),
        ("    if (n_t == 0) continue;",
         "    long long c_c = clock64(); pc[1] += c_c - c_b;\n"
         "    if (n_t == 0) continue;", 1),
        (GRID_SYNC, GRID_SYNC
         + "    long long c_d = clock64(); pc[2] += c_d - c_c;\n", 1),
        ("    __syncthreads();  // the carry is complete for the next step's "
         "phase 1\n",
         "    __syncthreads();  // the carry is complete for the next step's "
         "phase 1\n    pc[3] += clock64() - c_d;\n", 1),
        (FINISH, "  if (blockIdx.x == 0 && tid == 0)\n"
         "    for (int i = 0; i < 4; ++i) g_prof[i] = pc[i];\n" + FINISH, 1),
        ("}  // namespace\n",
         "}  // namespace\nextern \"C\" int cmhse_gru_bwd_prof("
         "unsigned long long* out) {\n  return (int)cudaMemcpyFromSymbol("
         "out, g_prof, sizeof(g_prof));\n}\n", 1),
    ],
}


def build(name: str, subs) -> ctypes.CDLL:
    from cmhse_tpu_torch.ops import cuda_lib

    tag = name.replace(" ", "_")
    d = cuda_lib.BUILD_ROOT / "variants" / tag / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT / "cmhse_tpu_torch" / "csrc", d)
    text = (d / "gru_bwd.cu").read_text()
    for old, new, count in subs:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old[:40]!r} occurs "
                               f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    (d / "gru_bwd.cu").write_text(text)
    saved = cuda_lib.CSRC, cuda_lib.BUILD_ROOT
    cuda_lib.CSRC, cuda_lib.BUILD_ROOT = d, d.parent / "_build"
    cuda_lib.library.cache_clear()
    try:
        lib = cuda_lib.library()
    finally:
        cuda_lib.CSRC, cuda_lib.BUILD_ROOT = saved
        cuda_lib.library.cache_clear()
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.ops import gru_kernel as gk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    plain_library = cuda_lib.library

    def use(name):
        cuda_lib.library = lambda: libs[name]

    torch.backends.cuda.matmul.allow_tf32 = False
    dc = get_preset("cmhse_full").data
    ds = SyntheticHierarchicalDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=0)
    b0 = next(batches_from_dataset(ds, dc, shuffle=False))
    dev = torch.device("cuda")
    cases = []
    for label, lens, t, seeded in (("video_low", b0.frame_len.reshape(-1),
                                    dc.max_frames, False),
                                   ("decoder", b0.clip_len, dc.max_clips,
                                    True)):
        b, h = lens.shape[0], 1024
        g = torch.Generator(device=dev).manual_seed(0)
        lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            use("as committed")
            xw = torch.randn(b, t, 3 * h, device=dev, generator=g).to(dt)
            w_h = ((torch.rand(h, 3 * h, device=dev, generator=g) * 2 - 1)
                   / 32).to(dt)
            b_h = (torch.rand(3 * h, device=dev, generator=g) * 2 - 1) / 32
            h0 = ((torch.rand(b, h, device=dev, generator=g) * 2 - 1).to(dt)
                  if seeded else None)
            outs, _, gates = gk.gru_forward(xw, w_h, b_h, lengths, h0,
                                            save_gates=True)
            douts = torch.randn(b, t, h, device=dev, generator=g).to(dt)
            dfinal = torch.randn(b, h, device=dev, generator=g).to(dt)
            args = (gates, outs, lengths, w_h, douts, dfinal, h0)
            cases.append((f"{label} {str(dt)[6:]}", args,
                          gk.gru_backward_plain(*args)))
    turns = list(VARIANTS) + list(VARIANTS)[::-1]
    for label, args, want in cases:
        for name in turns:
            use(name)
            got = gk.gru_backward(*args)
            torch.cuda.synchronize()
            err = max(float((a.float() - w.float()).abs().max()
                            / w.float().abs().max())
                      for a, w in zip(got, want))
            ms = chip_smoke.cuda_ms(lambda: gk.gru_backward(*args))
            print(f"{label:16s} {name:20s} {ms:.4f} ms  err {err:.3g}",
                  flush=True)
        use("clock split")
        gk.gru_backward(*args)
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * 4)()
        cuda_lib.check(libs["clock split"].cmhse_gru_bwd_prof(cycles),
                       "clock readout")
        print(f"{label:16s} block 0 cycles: phase 1 {cycles[0]}, counts[t] "
              f"{cycles[1]}, grid barrier {cycles[2]}, product {cycles[3]}",
              flush=True)
    cuda_lib.library = plain_library
    return 0


if __name__ == "__main__":
    sys.exit(main())
