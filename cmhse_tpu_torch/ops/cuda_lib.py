"""Build and bind the package's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled for ``sm_90a`` at first use, one ``nvcc`` per
source started together, then linked into one ``libcmhse_kernels.so`` under
``cmhse_tpu_torch/_build/<hash of sources and flags>/`` and bound with
``ctypes`` (plain ``extern "C"`` launchers that return ``cudaGetLastError()``;
every pointer and the stream pass as ``c_void_p``). Nothing here runs at
import time: a machine without ``nvcc`` imports this module fine and fails
only when a kernel is asked for.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("gru_fwd.cu", "gru_fwd_streamed.cu", "gru_bwd.cu",
           "gru_bwd_streamed.cu", "simhinge.cu", "rankcount.cu")
HEADERS = ("gru_common.cuh",)  # included by sources; part of the build hash
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libcmhse_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xw, w_h, b_h, lengths, h0, outs, final, gates, carry, B, T, H, bf16,
    # stream
    "cmhse_gru_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "cmhse_gru_fwd_max_hidden": (_I,),
    # xw, w_h, b_h, order, counts, h0, outs, final, gates, carry, B, T, H,
    # bf16, stream
    "cmhse_gru_fwd_streamed": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _P),
    # gates, outs, h0, douts, dfinal, lengths, order, w_h, dxw, dhn, db, dh0,
    # carry, B, T, H, bf16, stream
    "cmhse_gru_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                      _I, _I, _I, _P),
    "cmhse_gru_bwd_max_hidden": (_I,),
    # gates, outs, h0, douts, dfinal, lengths, order, counts, w_h, dxw, dhn,
    # db, dh0, carry, B, T, H, bf16, stream
    "cmhse_gru_bwd_streamed": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _I, _I, _I, _I, _P),
    # a, b, mask, row_diag, col_diag, keys, row_max, row_arg, col_max,
    # col_arg, M, N, D, margin, stream
    "cmhse_simhinge_pair": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, ctypes.c_float, _P),
    # q, g, pos, posidx, gvalid, counts, Q, N, D, lowp, stream
    "cmhse_rankcount": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "cmhse_rankcount_smem_bytes": (_I,),
}
# functions of _SIGNATURES that return a size_t (the rest return an int)
_SIZE_RESULTS: tuple[str, ...] = ()

# Kernel launches by (kernel, dtype, variant), for proof that a run went
# through the kernels: each wrapper adds one to its own key where it
# launches, and nowhere else. The serving daemon launches from several
# threads, so an addition holds a lock; each thread also keeps its own
# tally (an add encodes on its client's thread while queries launch on
# others).
launches: collections.Counter[tuple[str, str, str]] = collections.Counter()
_launches_lock = threading.Lock()
_thread = threading.local()


def count_launch(kernel: str, dtype: str, variant: str) -> None:
    key = (kernel, dtype, variant)
    with _launches_lock:
        launches[key] += 1
    mine = getattr(_thread, "launches", None)
    if mine is None:
        mine = _thread.launches = collections.Counter()
    mine[key] += 1


def reset_launches() -> None:
    launches.clear()


def launch_count(kernel: str, dtype: str | None = None,
                 variant: str | None = None) -> int:
    """Launches of ``kernel`` so far, over every dtype and variant unless
    one is named."""
    return sum(n for (k, d, v), n in launches.items()
               if k == kernel and dtype in (None, d) and variant in (None, v))


def thread_launch_count(kernel: str) -> int:
    """Launches of ``kernel`` made on the calling thread since it started;
    :func:`reset_launches` leaves this tally alone, so read it as a
    difference."""
    mine = getattr(_thread, "launches", None) or {}
    return sum(n for (k, _, _), n in mine.items() if k == kernel)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of cmhse_tpu_torch are built from csrc/ at first use")


def _build_dir(nvcc: str) -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if this exact build does not exist yet; return
    the library's path. The compiler's output (``ptxas`` registers, shared
    memory, spills) is kept in ``build.log`` beside the library."""
    nvcc = _nvcc()
    out_dir = _build_dir(nvcc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in procs), "-o",
             str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or none
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = (ctypes.c_size_t if name in _SIZE_RESULTS
                      else ctypes.c_int)
    lib.cmhse_error_string.argtypes = [ctypes.c_int]
    lib.cmhse_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().cmhse_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def build_log() -> str:
    """The compiler output of the current build (empty before a build)."""
    path = build().parent / "build.log"
    return path.read_text() if path.exists() else ""
