"""Timing helpers, counterpart of ``cmhse_tpu/utils/timing.py``: a wall-clock
timer, a steady-state calls/s that fences the card's work, and an optional
``torch.profiler`` trace around a region."""

from __future__ import annotations

import contextlib
import os
import time

import torch


class Timer:
    """Wall-clock timer (``with Timer() as t: ...; t.elapsed``). The caller
    fences device work inside the block where it matters."""

    def __init__(self) -> None:
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def throughput(fn, args, iters: int = 20, warmup: int = 3) -> float:
    """Steady-state calls/s of ``fn(*args)``. When an argument is a CUDA
    tensor, each timed window ends in ``torch.cuda.synchronize()``, so the
    count covers finished work and not the enqueue."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def fence():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args)
    fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    fence()
    return iters / (time.perf_counter() - t0)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """``with profiler_trace('/tmp/trace'):`` records the region with
    ``torch.profiler`` (CPU, and CUDA where a card is present) and writes a
    Chrome trace, ``trace.json``, into ``logdir``; nothing when ``logdir``
    is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
