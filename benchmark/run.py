"""The benchmark of ``cmhse_tpu_torch`` on NVIDIA cards: one run of one
cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. The cell is
``benchmark/cells/<cell>.json``; it names its configuration
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<mix>.json``, whose ``kind`` names its generator,
``benchmark/generators/<kind>.py``) and its runner (its ``kind``,
``benchmark/runners/<kind>.py``). With ``--trace 0`` the result
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (``benchmark/metrics/<name>.py``), read from the
benchmark's spans and a ``torch.profiler`` trace of the window.

The last line of standard output is the result, a JSON object; the
numbers that decide ``correct`` are printed beside their limits as the
last lines of standard error and under ``checks``, last in the result.
Without a CUDA card the run exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common, judge  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


class Measurements:
    """What a metric reader reads: the run's parts as attributes."""

    def __init__(self, parts: dict) -> None:
        self.__dict__.update(parts)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             hooks: dict | None = None, sizes: dict | None = None,
             root: Path = common.ROOT) -> dict:
    """Run one cell and return its result object (not printed). Its files
are found by name under ``root / "benchmark"``."""
    base = root / "benchmark"
    spec = common.benchmark_spec(root)
    cell = common.load_json("cells", name, base)
    config = common.load_json("configs", cell["config"], base)
    mix = common.load_json("traffic", cell["traffic"], base)
    parts = common.runner(cell["kind"], base)(
        cell, config, mix, seed, seconds, trace, device, T_PROCESS,
        hooks=hooks, sizes=sizes)
    e2e, layer = common.cell_metrics(spec, name)
    checks = judge.checks(parts["numbers"], cell["limits"])
    correct = all(c["ok"] for c in checks) and parts["failed"] == 0
    metrics = {}
    if not trace:
        for m in e2e:
            metrics[m["name"]] = {"value": float(parts[m["name"]]),
                                  "unit": m["unit"]}
    else:
        reading = Measurements(parts)
        for m in layer:
            value = common.metric_reader(m["name"], base)(reading)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(parts["attempted"]),
              "failed": int(parts["failed"]), "metrics": metrics}
    result["_parts"] = parts
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    result["_checks"] = checks
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.prepare_environment()
    spec = common.benchmark_spec()
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        sys.stderr.write(f"no workload named {args.workload!r} in "
                         "BENCHMARK.json\n")
        return 2
    import torch

    common.card_or_exit(torch, entry["chips"])
    torch.set_num_threads(common.HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = common.power_limit()
    sys.stderr.write(f"card: {card}\n")
    device = torch.device("cuda")
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device)
    parts = res.pop("_parts")
    checks = res.pop("_checks")
    found = common.forbidden_loaded()
    if found:
        sys.stderr.write(f"modules that must not load were loaded: "
                         f"{', '.join(found)}\n")
        return 3
    res["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": int(entry["chips"]),
                     "memory_peak_bytes": int(parts["memory_peak_bytes"])}
    if args.trace:
        t = parts["trace"]
        res["device"]["busy_s"] = t.busy_s
        res["device"]["window_s"] = t.window_s
        res["breakdown"] = {"device_ops": t.top_operations(10),
                            "idle_gaps": t.idle_gaps(10)}
        sys.stderr.write(f"trace activities: {t.activities}\n")
    sys.stderr.write("info: " + json.dumps(parts.get("info", {})) + "\n")
    sys.stderr.write("numbers: " + json.dumps(
        {k: v for k, v in parts["numbers"].items()}, default=str) + "\n")
    checks_last = res.pop("checks")
    res["checks"] = checks_last
    sys.stdout.flush()
    sys.stderr.write(common.checks_text(checks) + "\n")
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
