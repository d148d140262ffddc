"""The port's meters and event log against the JAX package's: the same
console strings, the same JSONL records, and the disabled logger's total
no-op."""

import json

import numpy as np
import pytest
import torch

from cmhse_tpu.utils.logging import AverageMeter as JaxAverageMeter
from cmhse_tpu.utils.logging import LogCollector as JaxLogCollector
from cmhse_tpu_torch.utils.logging import (AverageMeter, JsonlLogger,
                                           LogCollector)

torch.set_num_threads(2)


@pytest.mark.parametrize("updates", [
    [(1.0, 1), (3.0, 1), (10.0, 2)],
    [(0.25, 3), (-1.5, 1)],
])
def test_average_meter_matches_jax(updates):
    m, j = AverageMeter(), JaxAverageMeter()
    for val, n in updates:
        m.update(val, n)
        j.update(val, n)
    assert (m.val, m.avg, m.sum, m.count) == (j.val, j.avg, j.sum, j.count)
    assert str(m) == str(j)


def test_log_collector_format_matches_jax():
    c, j = LogCollector(), JaxLogCollector()
    for k, v in (("loss", 0.5), ("loss", 1.5), ("lr", 0.01)):
        c.update(k, v)
        j.update(k, v)
    assert str(c) == str(j)
    assert "loss" in str(c) and "(1.0000)" in str(c)


def test_jsonl_logger_roundtrip_with_tensors(tmp_path):
    """Device results are what the loop logs: 0-d tensors and numpy
    scalars become JSON numbers, arrays lists."""
    path = str(tmp_path / "log.jsonl")
    logger = JsonlLogger(path, tensorboard=False)
    logger.log("train_step", step=1, loss=torch.tensor(0.25))
    logger.log("validate", epoch=2, rsum=np.float32(300.0),
               ranks=np.arange(3))
    logger.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["event"] == "train_step" and lines[0]["loss"] == 0.25
    assert lines[1]["rsum"] == 300.0 and lines[1]["ranks"] == [0, 1, 2]


def test_jsonl_logger_disabled_is_total_noop(tmp_path):
    path = tmp_path / "nolog" / "log.jsonl"
    lg = JsonlLogger(str(path), enabled=False)
    lg.log("train_step", step=1, loss=0.5)
    lg.close()
    assert not path.exists() and not path.parent.exists()
