#!/usr/bin/env python3
"""Time design variants of the rankcount kernel (``csrc/rankcount.cu``) in
turns on one CUDA card, against the source as committed::

    python3 scripts/rankcount_variants.py

Each variant is the committed source with a few text substitutions,
compiled alone (``nvcc``, the package's flags) into a library of its own
under ``cmhse_tpu_torch/_build/rankcount_variants/`` and called through the
package's own wrapper (``violation_counts``), so the lowp rows include
nothing but the kernel (bf16 operands, read in place). Every variant
counts Q=1024 queries against N=100,000 gallery rows, D=1024, on
exact-arithmetic rows (``chip_smoke.exact_rows``), in both branches; its
counts must equal the plain version's. Times are CUDA-event means of 10
calls, taken in turns (the list forwards, then backwards), and the mean of
the two turns is printed beside each. ptxas's registers, stack and spills
come first, then the card's name, power limit and clock.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

F32_LOOP = '''      for (int j = 0; j < TN; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + (nr + 4 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
'''
# the same product with each accumulator's four depths in a row (a chain of
# four dependent FMAs), as the f32 branch was first written
F32_CHAINED = '''      for (int j = 0; j < TN; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + (nr + 4 * j) * LD + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
'''

VARIANTS = {
    "as committed": [],
    "f32 128-row gallery tiles": [
        ("const bool wide = (long long)q_tiles * ((N + BN_WIDE - 1) / BN_WIDE)"
         " >= sms;", "const bool wide = false;")],
    "f32 16-deep slabs, 4 stages": [
        ("constexpr int BK = 32;         // depth of one stage",
         "constexpr int BK = 16;         // depth of one stage"),
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "f32 chained depths": [(F32_LOOP, F32_CHAINED)],
    "lowp 3 stages": [("constexpr int STAGES = 4;",
                       "constexpr int STAGES = 3;")],
}


def build_all() -> dict:
    """Compile every variant of rankcount.cu at once; bind each library's
    launcher. The package's own library is built too, for error strings."""
    from cmhse_tpu_torch.ops import cuda_lib

    main_lib = cuda_lib.library()
    src = (cuda_lib.CSRC / "rankcount.cu").read_text()
    nvcc = cuda_lib._nvcc()
    out = cuda_lib.BUILD_ROOT / "rankcount_variants"
    texts = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old[:40]!r} occurs "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        d = out / name.replace(" ", "_").replace(",", "")
        d.mkdir(parents=True, exist_ok=True)
        (d / "rankcount.cu").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", str(d / "rankcount.cu"),
             "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        for line in log.splitlines():
            if "spill" in line or "Used" in line:
                print(f"{name:28s} {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.cmhse_rankcount.argtypes = list(
            cuda_lib._SIGNATURES["cmhse_rankcount"])
        lib.cmhse_rankcount.restype = ctypes.c_int
        lib.cmhse_error_string = main_lib.cmhse_error_string
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke
    from cmhse_tpu_torch.ops import cuda_lib
    from cmhse_tpu_torch.ops import rankcount_kernel as rk

    libs = build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    plain_library = cuda_lib.library
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    q, n, d = 1024, 100_000, 1024
    queries = chip_smoke.exact_rows(rng, q, d)
    gallery = chip_smoke.exact_rows(rng, n, d)
    pos_idx = torch.from_numpy(rng.randint(0, n, q).astype("int32")).to(dev)
    valid = torch.from_numpy(rng.rand(n) > 0.03).to(dev)
    pos = (queries * gallery[pos_idx.long()]).sum(1)
    cases = {
        "f32": ((queries, gallery), "float32"),
        "lowp (bf16 operands)": ((queries.to(torch.bfloat16),
                                  gallery.to(torch.bfloat16)), "bfloat16"),
    }
    try:
        for label, ((a, b), precision) in cases.items():
            want = rk.violation_counts_plain(a, b, pos, valid, pos_idx,
                                             precision=precision)
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                cuda_lib.library = lambda lib=libs[name]: lib
                got = rk.violation_counts(a, b, pos, valid, pos_idx,
                                          precision=precision)
                n_diff = int((got != want).sum())
                if n_diff:
                    raise AssertionError(f"{name}, {label}: {n_diff} counts "
                                         "differ from the plain version")
                times[name].append(chip_smoke.cuda_ms(
                    lambda: rk.violation_counts(a, b, pos, valid, pos_idx,
                                                precision=precision)))
            for name, t in times.items():
                print(f"{label:22s} {name:28s} {sum(t) / len(t):.4f} ms  "
                      f"(turns {t[0]:.4f}, {t[1]:.4f}); counts equal",
                      flush=True)
    finally:
        cuda_lib.library = plain_library
    return 0


if __name__ == "__main__":
    sys.exit(main())
