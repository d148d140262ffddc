"""What a run may load: no JAX, no JAX package (compared by whole
top-level names: ``cmhse_tpu_torch`` is not ``cmhse_tpu``), and a
reference that loads nothing of the program. Without a card a run exits
non-zero and prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN_FOR_REFERENCE = {"jax", "jaxlib", "flax", "cmhse_tpu",
                           "cmhse_tpu_torch", "harness"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not (_imports(path) & FORBIDDEN_FOR_REFERENCE)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.cmhse, reference.data; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not (loaded & FORBIDDEN_FOR_REFERENCE)


def test_forbidden_names_compared_whole():
    from harness import common

    mods = dict(sys.modules)
    try:
        sys.modules["cmhse_tpu_torch_fake"] = sys
        assert "cmhse_tpu" not in common.forbidden_loaded() or \
            "cmhse_tpu" in {m.split(".")[0] for m in mods}
    finally:
        sys.modules.pop("cmhse_tpu_torch_fake", None)


@pytest.mark.parametrize("cell", ["cmhse_full.train", "didemo.train"])
def test_toy_cell_loads_no_jax(cell):
    """The harness's CPU path at toy sizes, in a fresh process: after the
    run no forbidden top-level name is in ``sys.modules``."""
    code = f"""
import json, sys
sys.path.insert(0, {str(BENCH)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})
import run
from harness import common
from conftest import toy_sizes
common.prepare_environment()
import torch
res = run.run_cell({cell!r}, 2**31 + 7, 1.0, False, torch.device("cpu"),
                   sizes=toy_sizes(common.load_json("cells", {cell!r})))
print(json.dumps({{"correct": res["correct"],
                  "forbidden": common.forbidden_loaded()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "forbidden": []}


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cmhse_full.train", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cmhse_full.train", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
