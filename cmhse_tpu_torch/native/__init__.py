"""The native batch packer (``packer.cpp``), built with ``g++`` at first use
and bound with ``ctypes``.

:func:`pack_batch_native` computes what
:func:`cmhse_tpu_torch.data.bucketing.pad_batch` computes, field for field
and bit for bit (bf16 frames included); the loader packs with it, and the
numpy ``pad_batch`` stays as its plain version. Into fresh zero-filled
arrays it writes the live rows only; with ``pinned=True`` (the loader where
CUDA is available) it packs ``frames`` into page-locked memory and writes
every byte, padding included (:func:`pack_into`, which takes any buffers). The library lands in
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
                           ("pack_tokens", _TOKENS_ARGS),
                           ("pack_frames_padded", _FRAMES_ARGS),
                           ("pack_frames_padded_bf16", _FRAMES_ARGS),
                           ("pack_tokens_padded", _TOKENS_ARGS)):
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


def pack_batch_native(examples: list, spec, *, pinned: bool = False
                      ) -> Batch:
    """Native counterpart of :func:`~cmhse_tpu_torch.data.bucketing.pad_batch`
    (same arguments, same :class:`Batch`): f32 frames as a numpy array,
    bf16 frames as a CPU ``torch.bfloat16`` tensor rounded in the copy
    loop, the live rows written into zero-filled arrays.

    ``pinned=True`` (the loader in a process that sees a CUDA device):
    ``frames`` is packed, padding and all, straight into page-locked memory
    from PyTorch's caching host allocator and handed over as that CPU
    tensor, f32 or bf16; the other fields stay numpy arrays. It must stay
    that tensor: a ``non_blocking`` copy out of it records its event on the
    allocator's block, which is not handed out again before the copy has
    ended, and a numpy view of it would lose that guard. The
    :class:`~cmhse_tpu_torch.data.prefetch.Prefetcher` copies such a field
    to the device directly, with no staging copy."""
    lib = library()
    with timing.span("native.pack"):
        if pinned:
            batch = pack_into(examples, spec, _pinned(spec))
        else:
            batch = _pack(lib, examples, spec, _zeros(spec), padded=False)
    if timing.active():
        timing.count("native.bytes", sum(getattr(batch, f.name).nbytes
                                         for f in dataclasses.fields(Batch)))
    return batch


def pack_into(examples: list, spec, out: Batch) -> Batch:
    """Pack ``examples`` into ``out``'s buffers, whatever they hold (an
    earlier batch, say), and return a :class:`Batch` of them: the packer's
    padded entry points write every byte of every field. ``out.frames`` is
    a contiguous CPU tensor of ``spec``'s shape, f32 or bf16 as ``spec``
    says; the other fields are numpy arrays of ``pad_batch``'s shapes and
    dtypes."""
    b, c, f, d = _frames_shape(spec)
    dtype = torch.bfloat16 if _bf16(spec) else torch.float32
    fr = out.frames
    if not (isinstance(fr, torch.Tensor) and fr.device.type == "cpu"
            and fr.dtype == dtype and tuple(fr.shape) == (b, c, f, d)
            and fr.is_contiguous()):
        raise ValueError(f"frames must be a contiguous CPU {dtype} tensor "
                         f"of shape {(b, c, f, d)}")
    for name, (shape, dt) in _layout(spec).items():
        a = getattr(out, name)
        if not (isinstance(a, np.ndarray) and a.shape == shape
                and a.dtype == dt and a.flags.c_contiguous
                and a.flags.writeable):
            raise ValueError(f"{name} must be a writeable contiguous numpy "
                             f"{np.dtype(dt)} array of shape {shape}")
    return _pack(library(), examples, spec, vars(out).copy(), padded=True)


def _bf16(spec) -> bool:
    return spec.feature_dtype == "bfloat16"


def _frames_shape(spec) -> tuple:
    return (spec.batch_size, spec.max_clips, spec.max_frames, spec.feat_dim)


def _layout(spec) -> dict:
    """Shape and dtype of each field but ``frames``, as ``pad_batch``'s."""
    b, c, s = spec.batch_size, spec.max_clips, spec.max_sentences
    return {"frame_len": ((b, c), np.int32), "clip_len": ((b,), np.int32),
            "words": ((b, s, spec.max_words), np.int32),
            "word_len": ((b, s), np.int32), "sent_len": ((b,), np.int32),
            "video_ids": ((b,), np.int32), "valid": ((b,), np.bool_)}


def _zeros(spec) -> dict:
    """Fresh zero-filled outputs, bf16 frames as their int16 bits: large
    ones are pages the OS hands over zero, which the live-rows entry points
    leave untouched where the batch is padding."""
    out = {k: np.zeros(shape, dt) for k, (shape, dt) in _layout(spec).items()}
    out["frames"] = np.zeros(_frames_shape(spec),
                             np.int16 if _bf16(spec) else np.float32)
    return out


def _pinned(spec) -> Batch:
    """Outputs of any contents, ``frames`` a page-locked tensor."""
    return Batch(frames=torch.empty(
        _frames_shape(spec), pin_memory=True,
        dtype=torch.bfloat16 if _bf16(spec) else torch.float32),
        **{k: np.empty(shape, dt) for k, (shape, dt) in _layout(spec).items()})


def _pack(lib, examples: list, spec, out: dict, padded: bool) -> Batch:
    """The packer's calls on ``out``'s buffers: the padded entry points
    (every byte written) or the live-rows ones (zero-filled buffers)."""
    b = spec.batch_size
    if len(examples) > b:
        raise ValueError(f"batch of {len(examples)} > spec batch_size {b}")
    clips, clip_ptrs, nframes, clip_off = _csr(
        [ex.clips for ex in examples], b, np.float32, spec.feat_dim)
    sents, sent_ptrs, nwords, sent_off = _csr(
        [ex.sentences for ex in examples], b, np.int32, None)

    bf16 = _bf16(spec)
    if padded:
        pack_frames = (lib.pack_frames_padded_bf16 if bf16
                       else lib.pack_frames_padded)
        pack_tokens = lib.pack_tokens_padded
    else:
        pack_frames = lib.pack_frames_bf16 if bf16 else lib.pack_frames
        pack_tokens = lib.pack_tokens
    frames = out["frames"]
    pack_frames(clip_ptrs.ctypes.data, nframes.ctypes.data,
                clip_off.ctypes.data, b, spec.max_clips, spec.max_frames,
                spec.feat_dim,
                frames.data_ptr() if isinstance(frames, torch.Tensor)
                else frames.ctypes.data,
                out["frame_len"].ctypes.data, out["clip_len"].ctypes.data)
    pack_tokens(sent_ptrs.ctypes.data, nwords.ctypes.data,
                sent_off.ctypes.data, b, spec.max_sentences, spec.max_words,
                out["words"].ctypes.data, out["word_len"].ctypes.data,
                out["sent_len"].ctypes.data)
    del clips, sents  # the native calls are done with the rows

    n = len(examples)
    out["video_ids"][:n] = [ex.video_id for ex in examples]
    out["video_ids"][n:] = -1
    out["valid"][:n] = True
    out["valid"][n:] = False
    if isinstance(frames, np.ndarray) and bf16:
        out["frames"] = torch.from_numpy(frames).view(torch.bfloat16)
    return Batch(**out)
