#!/usr/bin/env python3
"""Time design variants of the live row-step products (``csrc/live_gemm.cu``)
in turns on one CUDA card, against the source as committed::

    python3 scripts/live_gemm_variants.py

Each variant is the committed source with a few text substitutions,
compiled alone (``nvcc``, the package's flags) into a library of its own
under ``cmhse_tpu_torch/_build/live_gemm_variants/`` and called through the
package's own wrappers (``live_gemm.rows_product`` / ``rows_reduce``). The
cases are ``chip_smoke.live_gemm_cases`` at video_low (512 x 64, D = 500,
H = 1,024) and text_low (512 x 32, D = 300): the projection, dX, dW_i and
dW_h, at the main path's lengths and at full density; each variant's
results must equal the committed source's within ``chip_smoke``'s limit.
Times are CUDA-event means of 10 calls, taken in turns (the list forwards,
then backwards), and the mean of the two turns is printed beside each, with
torch.matmul over every row-step last. ptxas's registers, stack and spills
come first, then the card's name, power limit and clock.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BK32 = ("constexpr int BK = 16;       // depth of a stage",
        "constexpr int BK = 32;       // depth of a stage")
VARIANTS = {
    "as committed": [],
    "reduce one block an SM": [("""__global__ void __launch_bounds__(NT, 2)
    live_reduce_kernel""", """__global__ void __launch_bounds__(NT, 1)
    live_reduce_kernel""")],
    "rows two blocks an SM": [("""__global__ void __launch_bounds__(NT, 1)
    live_rows_kernel""", """__global__ void __launch_bounds__(NT, 2)
    live_rows_kernel""")],
    "BK 32": [BK32],
}


def build_all() -> dict:
    """Compile every variant of live_gemm.cu at once; bind each library's
    launchers. The package's own library is built too, for error
    strings."""
    from cmhse_tpu_torch.ops import cuda_lib

    main_lib = cuda_lib.library()
    src = (cuda_lib.CSRC / "live_gemm.cu").read_text()
    nvcc = cuda_lib._nvcc()
    out = cuda_lib.BUILD_ROOT / "live_gemm_variants"
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new, *count in subs:
            want = count[0] if count else 1
            if text.count(old) != want:
                raise RuntimeError(f"{name}: {old[:40]!r} occurs "
                                   f"{text.count(old)} times, not {want}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "live_gemm.cu").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", str(d / "live_gemm.cu"),
             "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        for line in log.splitlines():
            if "spill" in line or "Used" in line:
                print(f"{name:24s} {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("cmhse_live_rows", "cmhse_live_rows_splits",
                   "cmhse_live_reduce", "cmhse_live_reduce_splits"):
            getattr(lib, fn).argtypes = list(cuda_lib._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
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
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    dc = get_preset("cmhse_full").data
    ds = SyntheticHierarchicalDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=0)
    b0 = next(batches_from_dataset(ds, dc, shuffle=False))
    plain_library = cuda_lib.library
    try:
        for label, lengths, t, d in (
                ("video_low", b0.frame_len.reshape(-1), dc.max_frames, 500),
                ("text_low", b0.word_len.reshape(-1), dc.max_words, 300)):
            for density, lens in (("", lengths),
                                  (" full", np.full(512, t, np.int32))):
                cases, dead = chip_smoke.live_gemm_cases(
                    torch, np.random.RandomState(0), 512, t, d, 1024, lens)
                for form, (kernel, _, library, flops, _) in cases.items():
                    times = {name: [] for name in libs}
                    want = None
                    for name in list(libs) + list(libs)[::-1]:
                        cuda_lib.library = lambda lib=libs[name]: lib
                        got = kernel()
                        got = got if isinstance(got, tuple) else (got,)
                        if form == "forward":  # dead rows left unwritten
                            got = (got[0][~dead],)
                        if want is None:
                            want = got
                        for g, w in zip(got, want):
                            if g is None:
                                continue
                            err = ((g - w).abs().max()
                                   / w.abs().max().clamp_min(1e-30)).item()
                            if not err <= chip_smoke.LIVE_GEMM_RTOL:
                                raise AssertionError(f"{name} {form}: error "
                                                     f"{err}")
                        times[name].append(chip_smoke.cuda_ms(kernel))
                    cuda_lib.library = plain_library
                    lib_ms = chip_smoke.cuda_ms(library)
                    for name, tt in times.items():
                        ms = sum(tt) / len(tt)
                        print(f"{label}{density:5s} {form:8s} {name:24s} "
                              f"{ms:.4f} ms {flops / ms / 1e9:5.1f} TFLOP/s "
                              f"(turns {tt[0]:.4f}, {tt[1]:.4f})", flush=True)
                    print(f"{label}{density:5s} {form:8s} "
                          f"{'torch.matmul, every row':24s} {lib_ms:.4f} ms",
                          flush=True)
                del cases
    finally:
        cuda_lib.library = plain_library
    return 0


if __name__ == "__main__":
    sys.exit(main())
