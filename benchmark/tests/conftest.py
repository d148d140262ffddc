"""The benchmark's own tests: ``python -m pytest benchmark/tests``. Tests
marked ``card`` need a CUDA card and skip without one (decided inside the
test, never at import)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small shapes for the CPU: the configurations' structure, toy widths
TOY = {"model": {"embed_size": 16, "rnn_hidden": 16, "word_dim": 12,
                 "feat_dim": 10},
       "data": {"feat_dim": 10, "vocab_size": 60, "batch_size": 8},
       "mix": {"videos": 40}}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def toy_sizes(cell: dict) -> dict:
    """TOY, a copy a run may change."""
    return {k: dict(v) for k, v in TOY.items()}
