#!/usr/bin/env python3
"""Host nanoseconds of one site of the port's span recorder
(``cmhse_tpu_torch.utils.timing``): ``with span(...)``, ``count(...)`` and
``next_key()`` with the recorder off and on (inside ``recording()``),
each less an empty loop's cost, the best of ``--rounds`` rounds of
``--n`` calls. One JSON line::

    python3 scripts/span_cost.py [--n 200000] [--rounds 5]
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cmhse_tpu_torch.utils import timing  # noqa: E402


def _span(n):
    span = timing.span
    for _ in range(n):
        with span("native.pack"):
            pass


def _count(n):
    count = timing.count
    for _ in range(n):
        count("native.bytes", 8)


def _key(n):
    next_key = timing.next_key
    for _ in range(n):
        next_key()


def _empty(n):
    for _ in range(n):
        pass


def _best_ns(fn, n: int, rounds: int) -> float:
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    base = _best_ns(_empty, args.n, args.rounds)
    out = {"host": platform.processor() or platform.machine(),
           "python": sys.version.split()[0], "empty_loop_ns": base}
    sites = {"span": _span, "count": _count, "next_key": _key}
    for name, fn in sites.items():
        out[f"{name}_off_ns"] = _best_ns(fn, args.n, args.rounds) - base
    for name, fn in sites.items():
        with timing.recording() as rec:
            out[f"{name}_on_ns"] = _best_ns(fn, args.n, args.rounds) - base
        rec.clear()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
