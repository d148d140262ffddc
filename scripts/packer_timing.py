#!/usr/bin/env python3
"""Host time of making one padded batch, three ways, timed in turns on one
host: ``pad_batch`` (numpy, the plain version), the port's native packer
(``cmhse_tpu_torch/native``: zero-filled buffers from ``np.zeros``, only
the valid rows written) and the JAX package's packer design
(``cmhse_tpu/native/packer.cpp``, compiled here from its source with the
port's flags and called the same way, on ``np.empty`` buffers that it
zeroes with ``memset`` first). f32 and bf16 frames; the batch is 64 videos
of ``CorrelatedSyntheticDataset`` at ``cmhse_full``'s widths, the data
phase 6 of ``chip_smoke.py`` trains on. Imports nothing of JAX::

    python3 scripts/packer_timing.py [--reps 20] [--rounds 3] [--seed 0]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import platform
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cmhse_tpu_torch import native  # noqa: E402
from cmhse_tpu_torch.config import get_preset  # noqa: E402
from cmhse_tpu_torch.data import (BucketSpec, CorrelatedSyntheticDataset,  # noqa: E402
                                  pad_batch)


def jax_design(tmp: str):
    """The JAX package's packer.cpp, built with the port's flags; a
    ``pack(examples, spec)`` that calls it as the port's binding calls its
    own, on uninitialized buffers (that source zeroes them itself)."""
    lib_path = Path(tmp) / "libpacker_jax.so"
    subprocess.run(["g++", *native.CXX_FLAGS,
                    str(ROOT / "cmhse_tpu" / "native" / "packer.cpp"), "-o",
                    str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, args in (("pack_frames", native._FRAMES_ARGS),
                       ("pack_frames_bf16", native._FRAMES_ARGS),
                       ("pack_tokens", native._TOKENS_ARGS)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = None

    def pack(examples, spec):
        b = spec.batch_size
        clips, cp, nf, co = native._csr([e.clips for e in examples], b,
                                        np.float32, spec.feat_dim)
        sents, sp, nw, so = native._csr([e.sentences for e in examples], b,
                                        np.int32, None)
        bf16 = spec.feature_dtype == "bfloat16"
        frames = np.empty((b, spec.max_clips, spec.max_frames,
                           spec.feat_dim), np.int16 if bf16 else np.float32)
        frame_len = np.empty((b, spec.max_clips), np.int32)
        clip_len = np.empty((b,), np.int32)
        words = np.empty((b, spec.max_sentences, spec.max_words), np.int32)
        word_len = np.empty((b, spec.max_sentences), np.int32)
        sent_len = np.empty((b,), np.int32)
        fn = lib.pack_frames_bf16 if bf16 else lib.pack_frames
        fn(cp.ctypes.data, nf.ctypes.data, co.ctypes.data, b,
           spec.max_clips, spec.max_frames, spec.feat_dim,
           frames.ctypes.data, frame_len.ctypes.data, clip_len.ctypes.data)
        lib.pack_tokens(sp.ctypes.data, nw.ctypes.data, so.ctypes.data, b,
                        spec.max_sentences, spec.max_words, words.ctypes.data,
                        word_len.ctypes.data, sent_len.ctypes.data)
        if bf16:
            frames = torch.from_numpy(frames).view(torch.bfloat16)
        return frames, frame_len, words, word_len

    return pack


def median_ms(fn, examples, spec, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(examples, spec)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dc = get_preset("cmhse_full").data
    ds = CorrelatedSyntheticDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=args.seed)
    examples = [ds[i] for i in range(len(ds))]
    rows = sum(min(len(c), dc.max_frames) for e in examples
               for c in e.clips[:dc.max_clips])
    cpu = next((ln.split(":", 1)[1].strip()
                for ln in Path("/proc/cpuinfo").read_text().splitlines()
                if ln.startswith("model name")), platform.processor())
    print(f"host: {cpu}, {platform.python_version()}, torch "
          f"{torch.__version__}; batch {dc.batch_size} videos, {rows} frame "
          f"rows of {dc.max_clips * dc.max_frames * dc.batch_size} slots "
          f"({1 - rows / (dc.max_clips * dc.max_frames * dc.batch_size):.1%} "
          f"padding), feat {dc.feat_dim}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ways = {"pad_batch": pad_batch, "port packer":
                native.pack_batch_native, "JAX packer design": jax_design(tmp)}
        out = {}
        for dtype in ("float32", "bfloat16"):
            spec = BucketSpec(dc.batch_size, dc.max_clips, dc.max_frames,
                              dc.max_sentences, dc.max_words, dc.feat_dim,
                              dtype)
            for fn in ways.values():
                fn(examples, spec)  # warm: builds, first-touch of the heap
            runs = {name: [] for name in ways}
            for r in range(args.rounds):
                order = list(ways) if r % 2 == 0 else list(ways)[::-1]
                for name in order:
                    runs[name].append(median_ms(ways[name], examples, spec,
                                                args.reps))
            out[dtype] = runs
            print(f"{dtype}: host ms a batch, median of {args.reps}, "
                  f"{args.rounds} rounds in turns: " + "; ".join(
                      f"{k} " + ", ".join(f"{x:.3f}" for x in v)
                      for k, v in runs.items()), flush=True)
    print(json.dumps({"packer_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
