"""The port stands alone: importing every module of ``cmhse_tpu_torch`` in a
fresh interpreter loads no ``jax*``, ``flax``, ``optax``, ``orbax`` or
``cmhse_tpu`` module, and builds no kernel and no native packer."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import cmhse_tpu_torch
for m in pkgutil.walk_packages(cmhse_tpu_torch.__path__, "cmhse_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "cmhse_tpu"))
print("modules", len([m for m in sys.modules if m.startswith("cmhse_tpu_torch")]))
print("bad", bad)
from cmhse_tpu_torch.ops import cuda_lib
print("built", cuda_lib.library.cache_info().currsize)
from cmhse_tpu_torch import native
print("packer", native.library.cache_info().currsize)
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["modules"]) >= 15
    assert lines["bad"] == "[]"
    assert lines["built"] == "0"
    assert lines["packer"] == "0"


LOOP_MODULES = [
    "cmhse_tpu_torch.train.loop", "cmhse_tpu_torch.train.checkpoint",
    "cmhse_tpu_torch.utils.logging", "cmhse_tpu_torch.data.vocab",
    "cmhse_tpu_torch.data.word_vectors", "cmhse_tpu_torch.data.datasets",
    "cmhse_tpu_torch.data.prefetch",
]

# the command-line chain and what it stands on
CHAIN_MODULES = [
    "cmhse_tpu_torch.native", "cmhse_tpu_torch.data.fixtures",
    "cmhse_tpu_torch.utils.timing", "cmhse_tpu_torch.interop",
    "cmhse_tpu_torch.cli.build_vocab", "cmhse_tpu_torch.cli.train",
    "cmhse_tpu_torch.cli.evaluate", "cmhse_tpu_torch.cli.import_torch",
    "cmhse_tpu_torch.cli.export_torch", "cmhse_tpu_torch.cli.retrieve",
]

ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "cmhse_tpu", "h5py")))
"""


@pytest.mark.parametrize("module", LOOP_MODULES + CHAIN_MODULES)
def test_training_loop_modules_import_alone_without_jax(module):
    """Each module of the training loop and of the command-line chain,
    imported first and alone, loads nothing of JAX or the JAX package (nor
    h5py, which only an h5 dataset file needs)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", ALONE, module], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
