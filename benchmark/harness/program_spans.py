"""The program's own spans and counters (``cmhse_tpu_torch.utils.timing``).

The program's recorder is on while a ``torch.profiler`` session records,
so a ``--trace 1`` run's window leaves the program's records in
``timing.profiled``, stamped on ``time.time_ns`` as the harness's own
:class:`~harness.trace.Spans` are. A program without that recorder (an
older tree) gives nothing, and its readers read nothing.
"""

from __future__ import annotations


def window():
    """The program's records of the traced window, or None."""
    try:
        from cmhse_tpu_torch.utils import timing
    except ImportError:
        return None
    rec = getattr(timing, "profiled", None)
    return rec if rec is not None and rec.spans else None


def mean_ms(rec, name: str) -> float | None:
    """Mean milliseconds of ``name``'s spans (one a batch for the batch
    pipeline's)."""
    spans = [s for s in rec.spans if s.name == name]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6


def mean_self_ms(rec, name: str) -> float | None:
    """Mean self milliseconds of ``name``'s spans: each one's duration less
    its child spans' (children on one thread do not overlap)."""
    spans = [s for s in rec.spans if s.name == name]
    if not spans:
        return None
    ids = {s.id for s in spans}
    inner = sum(s.end_ns - s.start_ns for s in rec.spans if s.parent in ids)
    total = sum(s.end_ns - s.start_ns for s in spans)
    return (total - inner) / len(spans) / 1e6


def triples(rec, lo_ns: int | None = None, hi_ns: int | None = None) -> list:
    """The program's spans as :class:`~harness.trace.Spans` items,
    ``(name, start_ns, end_ns)``, those that start in ``[lo_ns, hi_ns)``
    where given; appended to a run's ``Spans``, ``TraceReading.idle_gaps``
    puts each idle stretch under the innermost span, program or
    harness."""
    return [(s.name, s.start_ns, s.end_ns) for s in rec.spans
            if (lo_ns is None or s.start_ns >= lo_ns)
            and (hi_ns is None or s.start_ns < hi_ns)]
