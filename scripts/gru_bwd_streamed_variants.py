#!/usr/bin/env python3
"""Time design variants of the streamed gru_bwd kernel
(``csrc/gru_bwd_streamed.cu``, K2 past the resident W_h limit) in turns on
one CUDA card, against the source as committed::

    python3 scripts/gru_bwd_streamed_variants.py [--hidden 2048] \\
        [--against TREE]

Each variant is the committed source with a few text substitutions,
compiled alone (one ``nvcc`` a variant, all started together) into a
library of its own under ``cmhse_tpu_torch/_build/variants/``; the
package's wrapper then calls that library's ``cmhse_gru_bwd_streamed``.
Every variant runs K2 (zero h0, with ``douts`` and ``dfinal``) at video_low
512x64 on the lengths of ``chip_smoke.py``'s first batch, at H =
``--hidden``, f32 and bf16, in turns (the list forwards, then backwards);
each time is the mean of 5 calls (CUDA events), each error K2's largest
against the committed source's output, relative to its largest entry. The
"clock split" variant also reports block 0's ``clock64()`` cycles by part
of the time loop: phase 1 (the gate gradients), the grid barrier, the
products and the rest of phase 2 (chunk set-up, carry updates). Prints the
card's name and power limit first.

``--against TREE`` (a checkout, e.g. an unpacked ``git archive`` of the
parent commit) also runs the resident K2 (H = 1,024, video_low, f32 and
bf16, with and without h0) through this tree's wrapper and through
TREE's, each in a fresh interpreter on the same inputs, and reports
whether dxw, dhn, db and dh0 have the same bits (exit code 1 if not).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SOURCE = "gru_bwd_streamed.cu"

STEP = "  for (int t = T - 1; t >= 0; --t) {\n"
LIVE = "    const int n_t = counts[t];"
GRID_SYNC = ("    cg::this_grid().sync();  // dxw[:, t] and dhn[:, t] are "
             "complete\n")
F32_PRODUCT = "          product_f32_rows("
F32_PRODUCT_END = "\n                           sl, rg, rstride, jw, tid);\n"
BF16_PRODUCT = ("          product_bf16(c, sl, a_base < sl.rows, a_base, "
                "n_base, tid);\n")
STEP_END = ("    __syncthreads();  // the carry is complete for the next "
            "step's phase 1\n")
FINISH = "  // the ring is free for the bias sums' partials\n"
COMMON = "gru_common.cuh"  # the variant's copy of it; the package's is kept
BATCH = "constexpr int kBwdBatch = 8;"

# variant name -> [(old text, new text, occurrences[, file: SOURCE if not
# named])]
VARIANTS = {
    "as committed": [],
    "W_h in 4-byte pieces": [
        ("  sl.wide = !kLowp || H % 8 == 0;", "  sl.wide = false;", 1),
        ("constexpr int kNarrowBytes = 8;", "constexpr int kNarrowBytes = 4;",
         1)],
    # the parent's f32 tile: 2 rows x 2 units a thread (chunks of 64 rows)
    "f32 2x2 tile": [
        ("  static constexpr int kThreadRows = 8;  // a thread: 8 rows x 2 "
         "units\n",
         "  static constexpr int kThreadRows = 2;\n", 1),
        ("  static constexpr int kSlotRows = 512;  // chunk rows x slots\n",
         "  static constexpr int kSlotRows = 128;\n", 1)],
    "f32 3 stages, bf16 4": [
        ("  static constexpr int kStages = 4;\n",
         "  static constexpr int kStages = 3;  // f32\n", 1),
        ("  static constexpr int kStages = 3;\n",
         "  static constexpr int kStages = 4;\n", 1)],
    # phase 1's rows in flight a thread (the same sums in the same order)
    "phase 1 batch 16": [(BATCH, BATCH.replace("8", "16"), 1, COMMON)],
    "phase 1 batch 4": [(BATCH, BATCH.replace("8", "4"), 1, COMMON)],
    "clock split": [
        ("namespace {\n\nusing gru::commit_staged;",
         "namespace {\n__device__ unsigned long long g_prof[4];\n"
         "using gru::commit_staged;", 1),
        (STEP, "  long long pc[4] = {0, 0, 0, 0};\n" + STEP
         + "    const long long c_a = clock64();\n", 1),
        (LIVE, "    const long long c_b = clock64();\n"
         "    pc[0] += c_b - c_a;\n" + LIVE, 1),
        (GRID_SYNC, GRID_SYNC + "    const long long c_c = clock64();\n"
         "    pc[1] += c_c - c_b;\n", 1),
        (F32_PRODUCT, "          const long long c_p = clock64();\n"
         + F32_PRODUCT, 1),
        (F32_PRODUCT_END, F32_PRODUCT_END
         + "          pc[2] += clock64() - c_p;\n", 1),
        (BF16_PRODUCT, "          const long long c_p = clock64();\n"
         + BF16_PRODUCT + "          pc[2] += clock64() - c_p;\n", 1),
        (STEP_END, STEP_END + "    pc[3] += clock64() - c_c;\n", 1),
        (FINISH, "  if (blockIdx.x == 0 && tid == 0)\n"
         "    for (int i = 0; i < 4; ++i) g_prof[i] = pc[i];\n" + FINISH, 1),
        ("}  // namespace\n",
         "}  // namespace\nextern \"C\" int cmhse_gru_bwd_streamed_prof("
         "unsigned long long* out) {\n  return (int)cudaMemcpyFromSymbol("
         "out, g_prof, sizeof(g_prof));\n}\n", 1),
    ],
}

# run in a tree's root by --against: the resident K2 at H = 1,024 on the
# lengths in argv[1] and inputs made from a seed (its gates from the tree's
# own K1), its outputs saved to argv[2]
BITS = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
from cmhse_tpu_torch.ops import gru_kernel as gk
lens, t, h = np.load(sys.argv[1]), 64, 1024
dev = torch.device("cuda")
lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
b = lens.shape[0]
out = {}
for name in ("float32", "bfloat16"):
    dt = getattr(torch, name)
    g = torch.Generator(device=dev).manual_seed(0)
    xw = torch.randn(b, t, 3 * h, device=dev, generator=g).to(dt)
    w_h = ((torch.rand(h, 3 * h, device=dev, generator=g) * 2 - 1)
           / 32).to(dt)
    b_h = (torch.rand(3 * h, device=dev, generator=g) * 2 - 1) / 32
    h0 = (torch.rand(b, h, device=dev, generator=g) * 2 - 1).to(dt)
    douts = torch.randn(b, t, h, device=dev, generator=g).to(dt)
    dfinal = torch.randn(b, h, device=dev, generator=g).to(dt)
    for seeded in (None, h0):
        o, _, gates = gk.gru_forward(xw, w_h, b_h, lengths, seeded,
                                     save_gates=True)
        got = gk.gru_backward(gates, o, lengths, w_h, douts, dfinal, seeded)
        key = name + (" with_h0" if seeded is not None else " zero_h0")
        out[key] = [x.cpu() for x in got]
torch.save(out, sys.argv[2])
'''


def build(name: str, subs) -> subprocess.Popen:
    """Start nvcc on the variant's source; the library lands beside it."""
    from cmhse_tpu_torch.ops import cuda_lib

    d = cuda_lib.BUILD_ROOT / "variants" / name.replace(" ", "_")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(cuda_lib.CSRC, d)
    for old, new, count, *file in subs:
        path = d / (file[0] if file else SOURCE)
        text = path.read_text()
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old[:40]!r} occurs "
                               f"{text.count(old)} times, not {count}")
        path.write_text(text.replace(old, new))
    return subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", str(d / SOURCE),
         "-o", str(d / "variant.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


class Variant:
    """The package's library with one variant's cmhse_gru_bwd_streamed."""

    def __init__(self, base, path: Path):
        from cmhse_tpu_torch.ops import cuda_lib

        self.base, self.lib = base, ctypes.CDLL(str(path))
        fn = self.lib.cmhse_gru_bwd_streamed
        fn.argtypes = list(cuda_lib._SIGNATURES["cmhse_gru_bwd_streamed"])
        fn.restype = ctypes.c_int
        self.cmhse_gru_bwd_streamed = fn

    def __getattr__(self, name):
        return getattr(self.base, name)


def video_low_lengths():
    """video_low's lengths in ``chip_smoke.py``'s first batch, and T."""
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)

    dc = get_preset("cmhse_full").data
    ds = SyntheticHierarchicalDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=0)
    b0 = next(batches_from_dataset(ds, dc, shuffle=False))
    return b0.frame_len.reshape(-1), dc.max_frames


def same_bits(tree: str, lens) -> bool:
    """The resident K2's outputs here and in ``tree``, bit for bit, on
    video_low's lengths ``lens`` (T = 64)."""
    import numpy as np
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "lens.npy"), lens)
        files = []
        for i, root in enumerate((str(ROOT), tree)):
            path = os.path.join(tmp, f"{i}.pt")
            p = subprocess.run([sys.executable, "-c", BITS,
                                os.path.join(tmp, "lens.npy"), path],
                               cwd=root, capture_output=True, text=True)
            if p.returncode:
                raise RuntimeError(f"{root}: rc {p.returncode}\n"
                                   f"{p.stderr[-3000:]}")
            files.append(torch.load(path))
    ok = True
    for key, mine in files[0].items():
        theirs = files[1][key]
        equal = [bool(torch.equal(a, b)) for a, b in zip(mine, theirs)]
        print(f"resident K2 {key}: dxw, dhn, db, dh0 bit-equal to {tree}'s: "
              f"{equal}", flush=True)
        ok = ok and all(equal)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--against", help="a tree whose resident K2 must give "
                    "the same bits")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
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
        spills = sorted({line.strip() for line in out.splitlines()
                         if "spill" in line and " 0 bytes spill" not in line})
        print(f"{name:24s} built; registers {regs}; spills {spills}",
              flush=True)
    plain_library = cuda_lib.library

    def use(name):
        cuda_lib.library = lambda: libs[name]

    lens, t = video_low_lengths()
    dev = torch.device("cuda")
    h = args.hidden
    b = lens.shape[0]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    turns = list(VARIANTS) + list(VARIANTS)[::-1]
    ok = True
    try:
        for dt in (torch.float32, torch.bfloat16):
            if h <= gk.bwd_max_hidden(dt):
                raise SystemExit(f"H = {h} takes the resident variant")
            xw = torch.randn(b, t, 3 * h, device=dev, generator=g).to(dt)
            w_h = ((torch.rand(h, 3 * h, device=dev, generator=g) * 2 - 1)
                   / h ** 0.5).to(dt)
            b_h = (torch.rand(3 * h, device=dev, generator=g) * 2 - 1) \
                / h ** 0.5
            outs, _, gates = gk.gru_forward(xw, w_h, b_h, lengths,
                                            save_gates=True)
            douts = torch.randn(b, t, h, device=dev, generator=g).to(dt)
            dfinal = torch.randn(b, h, device=dev, generator=g).to(dt)
            call = (gates, outs, lengths, w_h, douts, dfinal)
            use("as committed")
            want = gk.gru_backward(*call)
            label = f"H={h} {str(dt)[6:]}"
            for name in turns:
                use(name)
                got = gk.gru_backward(*call)
                torch.cuda.synchronize()
                err = max(float((a.float() - w.float()).abs().max()
                                / w.float().abs().max().clamp_min(1e-30))
                          for a, w in zip(got, want))
                ms = chip_smoke.cuda_ms(lambda: gk.gru_backward(*call),
                                        reps=5)
                print(f"{label:14s} {name:24s} {ms:.4f} ms  err {err:.3g}",
                      flush=True)
            use("clock split")
            gk.gru_backward(*call)
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * 4)()
            cuda_lib.check(
                libs["clock split"].lib.cmhse_gru_bwd_streamed_prof(cycles),
                "clock readout")
            total = sum(cycles) - cycles[2]  # products lie inside phase 2
            print(f"{label:14s} block 0 cycles: phase 1 {cycles[0]}, grid "
                  f"barrier {cycles[1]}, products {cycles[2]}, rest of "
                  f"phase 2 {cycles[3] - cycles[2]} (of {total})", flush=True)
            del xw, w_h, outs, gates, douts, dfinal, want, got
    finally:
        cuda_lib.library = plain_library
    if args.against:
        ok = same_bits(args.against, lens)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
