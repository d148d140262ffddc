#!/usr/bin/env python3
"""Time design variants of the streamed gru_fwd kernel
(``csrc/gru_fwd_streamed.cu``, K1 past the resident W_h limit) in turns on
one CUDA card, against the source as committed::

    python3 scripts/gru_fwd_streamed_variants.py [--hidden 2048]

Each variant is the committed source with a few text substitutions,
compiled alone (one ``nvcc`` a variant, all started together) into a
library of its own under ``cmhse_tpu_torch/_build/variants/``; the
package's wrapper then calls that library's ``cmhse_gru_fwd_streamed``.
Every variant runs K1 (encode) at video_low 512x64 on the lengths of
``chip_smoke.py``'s first batch, at H = ``--hidden``, f32 and bf16, in
turns (the list forwards, then backwards); each time is the mean of 5
calls (CUDA events), each error K1's largest against the committed
source's output. The "clock split" variant also reports block 0's
``clock64()`` cycles by part of the time loop: the products, the rest of
the chunk loop (the gate pass), the frozen rows' writes and the grid
barrier. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SOURCE = "gru_fwd_streamed.cu"

# the frozen rows as first written: every dead row's state copied from
# outs[:, t - 1] into outs[:, t], a step at a time
DEATHS = '''\
    const int dying = (t > 0 ? counts[t - 1] : B) - n_t;
    for (int i = tid; i < dying * n_units; i += kThreads) {
      const int b = order[n_t + i / n_units], u = u0 + i % n_units;
      const size_t bu = (size_t)b * H + u;
      const size_t b0 = (size_t)b * T;
      const E v = t > 0 ? outs[(b0 + t - 1) * H + u]
                        : kWithH0 ? h_init[bu] : from_f<E>(0.0f);
      for (int s = t; s < T; ++s) outs[(b0 + s) * H + u] = v;
      final_h[bu] = v;
    }
    if (n_t == 0) break;  // every row is written to the end
'''
COPY_EACH_STEP = '''\
    for (int i = tid; i < (B - n_t) * n_units; i += kThreads) {
      const int b = order[n_t + i / n_units], u = u0 + i % n_units;
      const size_t bu = (size_t)b * H + u;
      const size_t bt = (size_t)b * T + t;
      const E v = t > 0 ? outs[(bt - 1) * H + u]
                        : kWithH0 ? h_init[bu] : from_f<E>(0.0f);
      outs[bt * H + u] = v;
      if (t == T - 1) final_h[bu] = v;
    }
'''
STEP = "  for (int t = 0; t < T; ++t) {\n    const int n_t = counts[t];\n"
CHUNKS = "    const bool product = t > 0 || kWithH0;\n"
F32_PRODUCT = "          if (product)\n            product_f32_rows("
F32_PRODUCT_END = "                             acc, sl, rg, rstride, jw, tid);\n"
BF16_PRODUCT = ("          if (product)\n            product_bf16(c, sl, "
                "a_base < sl.rows, a_base, n_base, tid);\n")
DEATHS_START = "    const int dying = "
BARRIER = "    if (t + 1 < T) {\n      if (counts[t + 1] > 0)\n"
BARRIER_END = ("        __syncthreads();  // no product reads it: only this "
               "block's writes\n    }\n  }\n")

# variant name -> [(old text, new text, occurrences)]
VARIANTS = {
    "as committed": [],
    "frozen rows copied each step": [(DEATHS, COPY_EACH_STEP, 1)],
    "W in 4-byte pieces": [
        ("  sl.wide = U % kPer16 == 0 && H % kPer16 == 0;",
         "  sl.wide = false;", 1)],
    "f32 16-depth slabs": [
        ("  static constexpr int kDepth = 32;      // depths a slab\n"
         "  static constexpr int kRowBytes = 144;  // a staged state row\n",
         "  static constexpr int kDepth = 16;\n"
         "  static constexpr int kRowBytes = 80;\n", 1)],
    "bf16 4 stages": [
        ("  static constexpr int kStages = 3;\n",
         "  static constexpr int kStages = 4;\n", 1)],
    "clock split": [
        ("namespace {\n\nusing gru::commit_staged;",
         "namespace {\n__device__ unsigned long long g_prof[4];\n"
         "using gru::commit_staged;", 1),
        (STEP, "  long long pc[4] = {0, 0, 0, 0};\n" + STEP
         + "    long long c_a = clock64();\n", 1),
        (CHUNKS, CHUNKS + "    const long long c_c = clock64();\n", 1),
        (F32_PRODUCT, "          const long long c_p = clock64();\n"
         + F32_PRODUCT, 1),
        (F32_PRODUCT_END, F32_PRODUCT_END
         + "          pc[0] += clock64() - c_p;\n", 1),
        (BF16_PRODUCT, "          const long long c_p = clock64();\n"
         + BF16_PRODUCT + "          pc[0] += clock64() - c_p;\n", 1),
        (DEATHS_START, "    pc[1] += clock64() - c_c;\n    c_a = clock64();\n"
         + DEATHS_START, 1),
        (BARRIER, "    pc[2] += clock64() - c_a;\n    c_a = clock64();\n"
         + BARRIER, 1),
        (BARRIER_END, BARRIER_END.removesuffix("  }\n")
         + "    pc[3] += clock64() - c_a;\n  }\n"
         "  if (blockIdx.x == 0 && tid == 0)\n"
         "    for (int i = 0; i < 4; ++i) g_prof[i] = pc[i];\n", 1),
        ("}  // namespace\n",
         "}  // namespace\nextern \"C\" int cmhse_gru_fwd_streamed_prof("
         "unsigned long long* out) {\n  return (int)cudaMemcpyFromSymbol("
         "out, g_prof, sizeof(g_prof));\n}\n", 1),
    ],
}


def build(name: str, subs) -> subprocess.Popen:
    """Start nvcc on the variant's source; the library lands beside it."""
    from cmhse_tpu_torch.ops import cuda_lib

    d = cuda_lib.BUILD_ROOT / "variants" / name.replace(" ", "_")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(cuda_lib.CSRC, d)
    text = (d / SOURCE).read_text()
    for old, new, count in subs:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old[:40]!r} occurs "
                               f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    (d / SOURCE).write_text(text)
    return subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", str(d / SOURCE),
         "-o", str(d / "variant.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


class Variant:
    """The package's library with one variant's cmhse_gru_fwd_streamed."""

    def __init__(self, base, path: Path):
        from cmhse_tpu_torch.ops import cuda_lib

        self.base, self.lib = base, ctypes.CDLL(str(path))
        fn = self.lib.cmhse_gru_fwd_streamed
        fn.argtypes = list(cuda_lib._SIGNATURES["cmhse_gru_fwd_streamed"])
        fn.restype = ctypes.c_int
        self.cmhse_gru_fwd_streamed = fn

    def __getattr__(self, name):
        return getattr(self.base, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=2048)
    args = ap.parse_args()
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
    base = cuda_lib.library()
    procs = {n: build(n, subs) for n, subs in VARIANTS.items()}
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{out}")
        libs[name] = Variant(base, cuda_lib.BUILD_ROOT / "variants"
                             / name.replace(" ", "_") / "variant.so")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in out.splitlines() if "Used " in line})
        print(f"{name:32s} built; registers {regs}", flush=True)
    plain_library = cuda_lib.library

    def use(name):
        cuda_lib.library = lambda: libs[name]

    dc = get_preset("cmhse_full").data
    ds = SyntheticHierarchicalDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=0)
    b0 = next(batches_from_dataset(ds, dc, shuffle=False))
    dev = torch.device("cuda")
    lens, t, h = b0.frame_len.reshape(-1), dc.max_frames, args.hidden
    b = lens.shape[0]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    turns = list(VARIANTS) + list(VARIANTS)[::-1]
    try:
        for dt in (torch.float32, torch.bfloat16):
            xw = torch.randn(b, t, 3 * h, device=dev, generator=g).to(dt)
            w_h = ((torch.rand(h, 3 * h, device=dev, generator=g) * 2 - 1)
                   / h ** 0.5).to(dt)
            b_h = (torch.rand(3 * h, device=dev, generator=g) * 2 - 1) \
                / h ** 0.5
            if h <= gk.fwd_max_hidden(dt):
                raise SystemExit(f"H = {h} takes the resident variant")
            use("as committed")
            want = gk.gru_forward(xw, w_h, b_h, lengths)
            label = f"H={h} {str(dt)[6:]}"
            for name in turns:
                use(name)
                got = gk.gru_forward(xw, w_h, b_h, lengths)
                torch.cuda.synchronize()
                err = max(float((a.float() - w.float()).abs().max())
                          for a, w in zip(got, want))
                ms = chip_smoke.cuda_ms(
                    lambda: gk.gru_forward(xw, w_h, b_h, lengths), reps=5)
                print(f"{label:14s} {name:32s} {ms:.4f} ms  err {err:.3g}",
                      flush=True)
            use("clock split")
            gk.gru_forward(xw, w_h, b_h, lengths)
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * 4)()
            cuda_lib.check(
                libs["clock split"].lib.cmhse_gru_fwd_streamed_prof(cycles),
                "clock readout")
            print(f"{label:14s} block 0 cycles: products {cycles[0]}, gate "
                  f"pass {cycles[1] - cycles[0]}, frozen rows {cycles[2]}, "
                  f"grid barrier {cycles[3]}", flush=True)
            del xw, w_h, want, got
    finally:
        cuda_lib.library = plain_library
    return 0


if __name__ == "__main__":
    sys.exit(main())
