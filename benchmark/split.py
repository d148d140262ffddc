"""Where a training cell's time goes, by the program's own spans: one run
of the cell, with the program's recorder on from the process's start.

    python benchmark/split.py --workload <cell> --seed <n> --seconds <s> \
        [--alternate K]

The cell's ``--trace 1`` run, and from its records the mean a batch of
each span of the batch pipeline and the step (``loader.rows``,
``native.pack``, ``prefetch.pin`` and its ``prefetch.slot_wait``,
``prefetch.copy``, ``step.*``) and of the harness's ``batch_wait``, the
device's idle time by the innermost span, program spans included, and a
split of ``setup_s``: the program's ``model.init``, ``state.init``,
``cuda_lib.load``, ``native.load`` and the harness's phases
(``setup.weights``, ``setup.split``, ``setup.checked_steps``,
``setup.warm``, the imports before them), each a span of the program's
recorder around the runner's function, in this process only.

``--alternate K``: after one set-up, 2K windows of ``--seconds`` each on
the same state and loop as the cell's window, the recorder off and on in
turns (off, on, on, off, ...), no profiler: the recorder's cost without
the host's drift between processes. One JSON line, last.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402
from harness import common, program_spans  # noqa: E402

run.T_PROCESS = T_PROCESS
PIPELINE = ("loader.rows", "native.pack", "prefetch.pin",
            "prefetch.slot_wait", "prefetch.copy")
STEP = ("step.forward", "step.loss", "step.backward", "step.update",
        "step.replay")
SETUP = ("model.init", "state.init", "cuda_lib.load", "cuda_lib.build",
         "native.load", "native.build")


def _spanned(timing, name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with timing.span(name):
            return fn(*args, **kwargs)
    return wrapper


def _wrap_setup(timing, cell: str) -> None:
    """Spans of the program's recorder around the runner's set-up
    phases, in this process only."""
    c = common.load_json("cells", cell)
    train_cell = common.load_module("runners", c["kind"])
    gen = common.generator(common.load_json("traffic", c["traffic"]))
    train_cell.make_weights = _spanned(timing, "setup.weights",
                                       train_cell.make_weights)
    train_cell._warm_buckets = _spanned(timing, "setup.warm",
                                        train_cell._warm_buckets)
    train_cell.prepare = _spanned(timing, "setup.prepare",
                                  train_cell.prepare)
    gen.split = _spanned(timing, "setup.split", gen.split)


def _sum_s(rec, name: str, lo=None, hi=None) -> float:
    return sum(s.end_ns - s.start_ns for s in rec.spans if s.name == name
               and (lo is None or s.start_ns >= lo)
               and (hi is None or s.start_ns < hi)) / 1e9


def setup_split(rec, window_start_ns: int) -> dict:
    """Seconds of each set-up phase, from the process's start to the
    window's; ``setup.checked_steps`` is ``setup.prepare`` less its
    other phases (the first and late steps, the kernels' load inside
    them left apart)."""
    before = [s for s in rec.spans if s.start_ns < window_start_ns]
    out = {n: _sum_s(rec, n, hi=window_start_ns)
           for n in SETUP + ("setup.weights", "setup.split", "setup.warm",
                             "setup.prepare")}
    prep = [s for s in before if s.name == "setup.prepare"]
    out["setup.imports"] = ((prep[0].start_ns if prep else window_start_ns)
                            / 1e9 - T_PROCESS)
    out["setup.checked_steps"] = out["setup.prepare"] - sum(
        out[n] for n in ("setup.weights", "setup.split", "setup.warm",
                         "model.init", "state.init", "cuda_lib.load",
                         "native.load"))
    out["setup_s"] = window_start_ns / 1e9 - T_PROCESS
    return out


def window_split(rec, spans, trace) -> dict:
    """Means a batch in the window, coverage of ``batch_wait`` and the
    idle time by innermost span, program spans included."""
    lo = trace.window[0] - trace.offset
    hi = trace.window[1] - trace.offset
    inside = type(rec)()
    inside.spans = [s for s in rec.spans if lo <= s.start_ns < hi]
    means = {n: program_spans.mean_ms(inside, n) for n in PIPELINE + STEP}
    means["prefetch.pin.self"] = program_spans.mean_self_ms(
        inside, "prefetch.pin")
    waits = [b - a for a, b in spans.of("batch_wait")
             if lo <= a < hi]
    means["batch_wait"] = sum(waits) / len(waits) / 1e6 if waits else None
    steps = [b - a for a, b in spans.of("train_step") if lo <= a < hi]
    means["train_step"] = sum(steps) / len(steps) / 1e6 if steps else None
    made = sum(means[n] or 0.0 for n in ("loader.rows", "native.pack",
                                         "prefetch.pin", "prefetch.copy"))
    before = trace.idle_gaps(20)
    spans.items += program_spans.triples(rec, lo, hi)
    return {"means_ms": means,
            "counts": {n: len(inside.of(n)) for n in PIPELINE + STEP},
            "batches_made_over_wait": (made / means["batch_wait"]
                                       if means["batch_wait"] else None),
            "idle_s_harness_spans": before,
            "idle_s_with_program_spans": trace.idle_gaps(20),
            "busy_s": trace.busy_s, "window_s": trace.window_s,
            "offset_us": trace.offset / 1e3}


def alternate(timing, cell: str, seed: int, seconds: float, pairs: int,
              device) -> dict:
    """videos/s of windows with the recorder off and on in turns, after
    one set-up (the runner's ``prepare``), and the loop thread's CPU ms a
    step (the recorder's own work runs on it)."""
    import torch

    c = common.load_json("cells", cell)
    train_cell = common.load_module("runners", c["kind"])
    T = train_cell.prepare(c, common.load_json("configs", c["config"]),
                           common.load_json("traffic", c["traffic"]), seed,
                           device)
    rates = {"off": [], "on": []}
    cpu = {"off": [], "on": []}
    for mode in (["off", "on", "on", "off"] * pairs)[:2 * pairs]:
        on = timing.recording() if mode == "on" else contextlib.nullcontext()
        with on:
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            videos = steps = 0
            while time.perf_counter() - t0 < seconds:
                videos += next(T["steps"])[0]
                steps += 1
            torch.cuda.synchronize()
            rates[mode].append(videos / (time.perf_counter() - t0))
            cpu[mode].append((time.thread_time() - c0) / steps * 1e3)
    train_cell.release(T)
    out = {"rates": rates, "thread_cpu_ms_a_step": cpu}
    for mode, vals in rates.items():
        q = statistics.quantiles(vals, n=4)
        med = statistics.median(vals)
        out[mode] = {"median": med, "spread": (q[2] - q[0]) / med,
                     "thread_cpu_ms_a_step": statistics.median(cpu[mode])}
    ratios = [b / a for a, b in zip(rates["off"], rates["on"])]
    out["on_over_off_median"] = statistics.median(ratios)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--alternate", type=int, default=0)
    args = p.parse_args(argv)
    common.prepare_environment()
    import torch

    from cmhse_tpu_torch.utils import timing

    common.card_or_exit(torch, 1)
    torch.set_num_threads(common.HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"workload": args.workload, "seed": args.seed,
           "card": common.power_limit()}
    if args.alternate:
        out["alternate"] = alternate(timing, args.workload, args.seed,
                                     args.seconds, args.alternate,
                                     torch.device("cuda"))
        print(json.dumps(out), flush=True)
        return 0
    _wrap_setup(timing, args.workload)
    with timing.recording() as rec:
        res = run.run_cell(args.workload, args.seed, args.seconds, True,
                           torch.device("cuda"))
    parts = res.pop("_parts")
    res.pop("_checks")
    out["correct"] = res["correct"]
    out["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
    out["steps"] = parts["attempted"]
    out["counters"] = dict(rec.counters)
    trace = parts["trace"]
    out["setup"] = setup_split(rec, trace.window[0] - trace.offset)
    out["window"] = window_split(rec, parts["spans"], trace)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
