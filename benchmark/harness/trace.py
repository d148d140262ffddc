"""Spans and the device trace of a ``--trace 1`` run.

Spans are the benchmark's own: host intervals (``time.time_ns``) around
calls into the program, kept in memory by :class:`Spans`, from any
thread. The device trace is ``torch.profiler`` with its CUDA activities only
(kernels, copies, and the CUDA runtime calls that launched them) over the
measured window: recording every CPU operation would slow the host
several-fold and inflate the device's idle share. An idle stretch of the
device goes to the innermost span the host was in meanwhile. The window
runs from one
``cudaDeviceSynchronize`` to the last; the first, made at a known
``time.time_ns``, joins the two clocks.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import threading
import time

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "cudaDeviceSynchronize"


class Spans:
    """Named host intervals from any thread: ``with spans("name"):``."""

    def __init__(self) -> None:
        self.items: list[tuple[str, int, int]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((name, t0, t1))

    def of(self, name: str) -> list[tuple[int, int]]:
        return sorted((a, b) for n, a, b in self.items if n == name)


class DeviceTrace:
    """``torch.profiler`` over the window; :meth:`analyse` reduces it."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.prof = None
        self.marker_ns = None
        self._ctx = None

    def __enter__(self):
        prof = self.torch.profiler
        self.prof = prof.profile(activities=[prof.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.marker_ns = time.time_ns()
        self.torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        return False

    def analyse(self, spans: Spans) -> "TraceReading":
        return TraceReading(self.prof.profiler.kineto_results.events(),
                            self.marker_ns, spans)


def _call(e, name: str, default=None):
    fn = getattr(e, name, None)
    return default if fn is None else fn()


def _kind(e) -> str:
    """The event's activity type, from ``activity_type()`` where the
    installed PyTorch has it, else from its device and name."""
    kind = _call(e, "activity_type")
    if kind is not None:
        return kind
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if _call(e, "is_user_annotation", False):
            return "gpu_user_annotation"
        low = name.lower()
        if "memcpy" in low:
            return "gpu_memcpy"
        if "memset" in low:
            return "gpu_memset"
        return "kernel"
    if _call(e, "is_user_annotation", False):
        return "user_annotation"
    if name.startswith("cuda") or name.startswith("cu") and \
            name[2:3].isupper():
        return "cuda_runtime"
    return "cpu_op"


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceReading:
    """What the metric readers read: device operations by name, the busy
    share of the window, idle gaps."""

    def __init__(self, events, marker_ns: int, spans: Spans) -> None:
        device, marks, activities = [], [], collections.Counter()
        for e in events:
            kind = _kind(e)
            activities[kind] += 1
            if kind in DEVICE_ACTIVITIES:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name()))
            if e.name() == MARKER and kind in ("cuda_runtime",
                                               "cuda_driver"):
                marks.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        if not marks:
            raise RuntimeError(f"the profiler recorded no {MARKER}: "
                               f"{dict(activities)}")
        marks.sort()
        window = (marks[0][0], marks[-1][1])
        self.activities = dict(activities)
        self.offset = window[0] - marker_ns  # trace clock - host clock
        self.window = window
        self.window_s = (window[1] - window[0]) / 1e9
        self.device = [d for d in device if d[1] > window[0]
                       and d[0] < window[1]]
        self.spans = spans
        clipped = [(max(a, window[0]), min(b, window[1]))
                   for a, b, *_ in self.device]
        self.busy = _merge(clipped)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, name, *_ in self.device
                   if rx.search(name)) / 1e9

    def top_operations(self, n: int = 10) -> list:
        by = collections.Counter()
        for a, b, name, *_ in self.device:
            by[_short(name)] += (b - a) / 1e9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time of the device inside the window, by what the host was
        doing meanwhile: each stretch of a gap goes to the innermost span
        that covers it, the rest to "outside any span"."""
        spans = sorted((a + self.offset, b + self.offset, name)
                       for name, a, b in self.spans.items)
        starts = [a for a, _, _ in spans]
        longest = max((b - a for a, b, _ in spans), default=0)
        edges = [self.window[0]] + [x for iv in self.busy for x in iv] + \
            [self.window[1]]
        by = collections.Counter()
        for k in range(0, len(edges), 2):
            a, b = edges[k], edges[k + 1]
            if b <= a:
                continue
            lo = bisect.bisect_left(starts, a - longest)
            hi = bisect.bisect_right(starts, b)
            cover = [s for s in spans[lo:hi] if s[0] < b and s[1] > a]
            cuts = sorted({a, b} | {x for s in cover for x in s[:2]
                                    if a < x < b})
            for x, y in zip(cuts, cuts[1:]):
                inner = [s for s in cover if s[0] <= x and s[1] >= y]
                label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                         else "outside any span")
                by[label] += (y - x) / 1e9
        return [[k, v] for k, v in by.most_common(n)]


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]
