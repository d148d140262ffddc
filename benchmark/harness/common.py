"""What every cell shares: finding its files by name, the card check, the
environment a run keeps to, and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import zlib
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cmhse_tpu")
# host threads of the math libraries (torch's intra-op pool among them),
# the same on every machine: the card's host is shared, and a parallel
# copy over every core waits for the slowest of them
HOST_THREADS = 2


def load_json(kind: str, name: str, base: Path = BENCH_DIR) -> dict:
    """``benchmark/<kind>/<name>.json``: a config, a cell or a traffic
    mix, found by its name."""
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path = BENCH_DIR):
    """``benchmark/<kind>/<name>.py`` (a runner, a generator or a metric
    reader), found by its name and loaded once a process."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    key = f"bench_{kind}_{name}_{zlib.crc32(str(path).encode()):08x}" \
        .replace(".", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def metric_reader(name: str, base: Path = BENCH_DIR):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    return load_module("metrics", name, base).read


def runner(kind: str, base: Path = BENCH_DIR):
    """The ``run`` function of ``benchmark/runners/<kind>.py``: a cell's
    ``"kind"`` names its runner."""
    return load_module("runners", kind, base).run


def generator(mix: dict, base: Path = BENCH_DIR):
    """The module of ``benchmark/generators/<kind>.py``: a traffic mix's
    ``"kind"`` names its generator."""
    return load_module("generators", mix["kind"], base)


def benchmark_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries the cell reports: those whose
    ``workloads`` name it, or that have none; a per-layer metric without
    ``workloads`` goes with every cell that reports what it moves."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def prepare_environment() -> None:
    """Caches inside the checkout at fixed paths, a fixed number of host
    threads, and no JAX from any library. Called before torch is
    imported."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if str(BENCH_DIR) not in sys.path:
        sys.path.insert(0, str(BENCH_DIR))


def forbidden_loaded() -> list:
    """Top-level names in ``sys.modules`` that a run must not hold, each
    compared whole (``cmhse_tpu_torch`` is not ``cmhse_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card_or_exit(torch, chips: int) -> None:
    """Exit non-zero, printing no result, without enough cards."""
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA card: this benchmark runs only on one\n")
        sys.exit(2)
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible\n")
        sys.exit(2)


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def checks_text(checks: list) -> str:
    """Each compared number beside its limit, one per line."""
    return "\n".join(f"{c['name']}: {c['value']!r} limit {c['limit']!r} "
                     f"({'ok' if c['ok'] else 'FAILED'})" for c in checks)
