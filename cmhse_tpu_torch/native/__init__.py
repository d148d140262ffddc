"""The native batch packer (``packer.cpp``), built with ``g++`` at first use
and bound with ``ctypes``.

:func:`pack_batch_native` computes what
:func:`cmhse_tpu_torch.data.bucketing.pad_batch` computes, field for field
and bit for bit (bf16 frames included); the loader packs with it, and the
numpy ``pad_batch`` stays as its plain version. The library lands in
``cmhse_tpu_torch/_build/packer-<hash of source and flags>/libpacker.so``,
written under a temporary name and moved into place with ``os.replace``,
so processes that build at once each load a whole library. A failed build
raises with the compiler's output: there is no numpy fallback. Nothing here
runs at import time.

With the recorder on (:mod:`cmhse_tpu_torch.utils.timing`): the spans
``native.load`` (the first :func:`library` call) with ``native.build``
inside it when this process compiles, the ``builds`` counter, and a
``native.pack`` span and the ``native.bytes`` counter a packed batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.utils import timing

SOURCE = Path(__file__).resolve().parent / "packer.cpp"
BUILD_ROOT = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIB_NAME = "libpacker.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# ptrs, counts, offsets, batch, cmax, fmax, feat, frames, frame_len, clip_len
_FRAMES_ARGS = [_P, _P, _P, _I64, _I64, _I64, _I64, _P, _P, _P]
# ptrs, counts, offsets, batch, smax, wmax, words, word_len, sent_len
_TOKENS_ARGS = [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P]


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native packer of "
                           "cmhse_tpu_torch is built from native/packer.cpp "
                           "at first use")
    return cxx


def build() -> Path:
    """Compile ``packer.cpp`` if this exact build does not exist yet;
    return the library's path."""
    cxx = _compiler()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    out_dir = BUILD_ROOT / f"packer-{h.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    timing.count("builds")
    with timing.span("native.build"), \
            tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        out = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o",
                              str(tmp_lib)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"building the native packer failed "
                               f"(rc {out.returncode}):\n{out.stdout}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or none
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The bound packer library, built on first call."""
    with timing.span("native.load"):
        lib = ctypes.CDLL(str(build()))
        for name, args in (("pack_frames", _FRAMES_ARGS),
                           ("pack_frames_bf16", _FRAMES_ARGS),
                           ("pack_tokens", _TOKENS_ARGS)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
    return lib


def _csr(rows_per_example: list, n_rows: int, dtype, width: int | None):
    """Contiguous arrays of every row, their pointer table, their lengths
    and the per-example offsets [n_rows + 1]; the arrays are returned so
    that they outlive the native call."""
    arrays, off = [], np.zeros(n_rows + 1, np.int64)
    for i, rows in enumerate(rows_per_example):
        arrays.extend(np.ascontiguousarray(r, dtype=dtype) for r in rows)
        off[i + 1] = len(arrays)
    off[len(rows_per_example) + 1:] = off[len(rows_per_example)]
    for a in arrays:
        if width is not None and (a.ndim != 2 or a.shape[1] != width):
            raise ValueError(f"clip shape {a.shape} != (*, {width})")
        if width is None and a.ndim != 1:
            raise ValueError(f"sentence shape {a.shape} is not 1-D")
    ptrs = np.asarray([a.ctypes.data for a in arrays] or [0], np.uintp)
    lengths = np.asarray([a.shape[0] for a in arrays] or [0], np.int64)
    return arrays, ptrs, lengths, off


def pack_batch_native(examples: list, spec) -> Batch:
    """Native counterpart of :func:`~cmhse_tpu_torch.data.bucketing.pad_batch`
    (same arguments, same :class:`Batch`): f32 frames as a numpy array,
    bf16 frames as a CPU ``torch.bfloat16`` tensor rounded in the copy
    loop."""
    lib = library()
    with timing.span("native.pack"):
        batch = _pack(lib, examples, spec)
    if timing.active():
        timing.count("native.bytes", sum(getattr(batch, f.name).nbytes
                                         for f in dataclasses.fields(Batch)))
    return batch


def _pack(lib, examples: list, spec) -> Batch:
    b = spec.batch_size
    if len(examples) > b:
        raise ValueError(f"batch of {len(examples)} > spec batch_size {b}")
    clips, clip_ptrs, nframes, clip_off = _csr(
        [ex.clips for ex in examples], b, np.float32, spec.feat_dim)
    sents, sent_ptrs, nwords, sent_off = _csr(
        [ex.sentences for ex in examples], b, np.int32, None)

    # zero-filled outputs: the packer writes only the valid rows
    bf16 = spec.feature_dtype == "bfloat16"
    frames = np.zeros((b, spec.max_clips, spec.max_frames, spec.feat_dim),
                      np.int16 if bf16 else np.float32)
    frame_len = np.zeros((b, spec.max_clips), np.int32)
    clip_len = np.empty((b,), np.int32)
    words = np.zeros((b, spec.max_sentences, spec.max_words), np.int32)
    word_len = np.zeros((b, spec.max_sentences), np.int32)
    sent_len = np.empty((b,), np.int32)

    pack = lib.pack_frames_bf16 if bf16 else lib.pack_frames
    pack(clip_ptrs.ctypes.data, nframes.ctypes.data, clip_off.ctypes.data,
         b, spec.max_clips, spec.max_frames, spec.feat_dim,
         frames.ctypes.data, frame_len.ctypes.data, clip_len.ctypes.data)
    lib.pack_tokens(sent_ptrs.ctypes.data, nwords.ctypes.data,
                    sent_off.ctypes.data, b, spec.max_sentences,
                    spec.max_words, words.ctypes.data, word_len.ctypes.data,
                    sent_len.ctypes.data)
    del clips, sents  # the native calls are done with the rows

    video_ids = np.full((b,), -1, np.int32)
    video_ids[:len(examples)] = [ex.video_id for ex in examples]
    valid = np.zeros((b,), bool)
    valid[:len(examples)] = True
    if bf16:
        frames = torch.from_numpy(frames).view(torch.bfloat16)
    return Batch(frames=frames, frame_len=frame_len, clip_len=clip_len,
                 words=words, word_len=word_len, sent_len=sent_len,
                 video_ids=video_ids, valid=valid)
