"""Timing helpers, counterpart of ``cmhse_tpu/utils/timing.py``: a wall-clock
timer, a steady-state calls/s that fences the card's work, an optional
``torch.profiler`` trace around a region, and the port's span recorder.

The recorder. ``with span("native.pack"):`` times a region of the host and
``count("native.bytes", n)`` adds to a counter. Both record only while the
recorder is on: inside a :func:`recording` region, whose :class:`Recording`
takes every thread's records, or while a ``torch.profiler`` session
records, when they go to :data:`profiled`, so that any device trace has
the program's spans beside it (as ``torch.profiler.record_function``
annotates only under a profiler). Off is the default: a span site then
costs one check and returns a shared no-op context, and nothing is
allocated, stamped or appended.

A span records its name, its start and end (``time.time_ns()``, the clock
``benchmark/harness/trace.py`` joins to the profiler's), its parent (the
span open around it on the same thread), its thread and a ``key``: the
sequence number of the batch it worked on (:func:`next_key`). A span given
no key takes its parent's, or else the thread's current batch key, so the
loader's, the pinned copy's and the train step's spans of one batch share
it. Records stay in memory until read.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
import time
import types
from typing import NamedTuple

import torch

try:
    # a module global torch keeps for fast checks of a running profiler
    from torch.autograd import profiler as _torch_profiler
    _torch_profiler._is_profiler_enabled
except (ImportError, AttributeError):  # pragma: no cover - older torch
    _torch_profiler = types.SimpleNamespace(_is_profiler_enabled=False)


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


class SpanRecord(NamedTuple):
    """One finished span: ``parent`` is the ``id`` of the span open around
    it on the same thread (None at the top); ``thread`` the native thread
    id."""

    name: str
    start_ns: int
    end_ns: int
    key: int | None
    thread: int
    id: int
    parent: int | None


class Recording:
    """What the recorder took while on: ``spans`` in the order they ended,
    ``counters`` by name."""

    def __init__(self) -> None:
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}

    def of(self, name: str) -> list[SpanRecord]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        self.spans.clear()
        self.counters.clear()


# the records made under a torch.profiler session outside any recording()
profiled = Recording()
_open: tuple[Recording, ...] = ()  # recording() regions, innermost last
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_keys = itertools.count()
_NULL = contextlib.nullcontext()


def _target() -> Recording | None:
    """Where a record made now goes; None while the recorder is off."""
    rec = _open
    if rec:
        return rec[-1]
    return profiled if _torch_profiler._is_profiler_enabled else None


def active() -> bool:
    """Whether the recorder is on (a recording or a profiler session)."""
    return bool(_open) or _torch_profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` turns the recorder on for the region;
    ``rec`` (a :class:`Recording`) takes what every thread records
    meanwhile. An inner recording takes its region's records from the
    outer one."""
    global _open
    rec = Recording()
    with _lock:
        _open = _open + (rec,)
    try:
        yield rec
    finally:
        with _lock:
            _open = tuple(r for r in _open if r is not rec)


class _Span:
    __slots__ = ("name", "key", "target", "start_ns", "id", "parent")

    def __init__(self, name: str, key: int | None, target: Recording):
        self.name, self.key, self.target = name, key, target

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        if stack:
            outer = stack[-1]
            if self.key is None:
                self.key = outer.key
            self.parent = outer.id
        else:
            if self.key is None:
                self.key = getattr(_local, "key", None)
            self.parent = None
        self.id = next(_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        # tuple.__new__: a record without NamedTuple's Python-level __new__
        self.target.spans.append(tuple.__new__(SpanRecord, (
            self.name, self.start_ns, end, self.key, _local.thread, self.id,
            self.parent)))
        return False


def span(name: str, key: int | None = None):
    """``with span("loader.rows"):`` records the region while the recorder
    is on (see the module docstring); else a shared no-op context."""
    if not _open and not _torch_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, key, _target())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if not _open and not _torch_profiler._is_profiler_enabled:
        return
    target = _target()
    if target is None:  # turned off since the check
        return
    with _lock:  # another thread may add to the same counter
        target.counters[name] = target.counters.get(name, 0) + n


def next_key() -> int | None:
    """The next batch number of the process, made the calling thread's
    current key; None while the recorder is off."""
    if not _open and not _torch_profiler._is_profiler_enabled:
        return None
    _local.key = key = next(_keys)
    return key


def current_key() -> int | None:
    """The calling thread's current batch key (None while off)."""
    if not _open and not _torch_profiler._is_profiler_enabled:
        return None
    return getattr(_local, "key", None)


def set_key(key: int | None) -> None:
    """Make ``key`` the calling thread's current batch key (a consumer
    taking over a batch made ahead of it)."""
    if _open or _torch_profiler._is_profiler_enabled:
        _local.key = key


_CLOCK_MARK = "cmhse_tpu_torch.clock"


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """``with profiler_trace('/tmp/trace'):`` records the region with
    ``torch.profiler`` (CPU, and CUDA where a card is present) and writes a
    Chrome trace, ``trace.json``, into ``logdir``, with the recorder on:
    the port's spans and counters go to ``spans.json`` beside it, in the
    Chrome trace's own timebase (its ``baseTimeNanoseconds``, the
    profiler's clock, each span on its thread's row), so that its
    ``traceEvents`` join ``trace.json``'s in one viewer. Nothing when
    ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        # a marker the profiler stamps on its clock, between two host
        # stamps on ours: the two clocks' offset
        t0 = time.time_ns()
        with record_function(_CLOCK_MARK):
            pass
        t1 = time.time_ns()
        with recording() as rec:
            yield
    trace = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(trace)
    marks = [e for e in prof.profiler.kineto_results.events()
             if e.name() == _CLOCK_MARK]
    offset = (marks[0].start_ns() + marks[0].duration_ns() // 2
              - (t0 + t1) // 2) if marks else 0
    _write_chrome_spans(rec, os.path.join(logdir, "spans.json"), offset,
                        _trace_base_ns(trace))


def _trace_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` in a Chrome trace's header (0 where the
    installed PyTorch writes none: its ``ts`` are then absolute)."""
    with open(path, "rb") as f:
        head = f.read(4096).decode("utf-8", "replace")
    m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0


def _write_chrome_spans(rec: Recording, path: str, offset_ns: int,
                        base_ns: int) -> None:
    """``rec`` as a Chrome trace: a complete event a span (``ts`` in us of
    ``time_ns + offset_ns - base_ns``; ``args`` its key, id and parent)
    and the counters under ``"counters"``."""
    pid = os.getpid()
    events = [{"ph": "X", "cat": "cmhse_tpu_torch", "name": s.name,
               "pid": pid, "tid": s.thread,
               "ts": (s.start_ns + offset_ns - base_ns) / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"key": s.key, "id": s.id, "parent": s.parent}}
              for s in rec.spans]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns,
                   "counters": dict(rec.counters)}, f)
