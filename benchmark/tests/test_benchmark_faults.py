"""A run with its timed path broken underneath comes out not correct:
one test a fault the cell can have, through the whole harness (the card
check skipped: the CPU path at toy sizes). The control, one precision
below the configuration's, fails the committed limits on the card."""

import pytest
import torch

import control
import run
from conftest import toy_sizes
from harness import common

CPU = torch.device("cpu")
TRAIN = ["cmhse_full.train", "didemo.train"]


def _run(cell, hooks=None, seed=2**31 + 11):
    sizes = toy_sizes(common.load_json("cells", cell))
    return run.run_cell(cell, seed, 1.0, False, CPU, hooks=hooks,
                        sizes=sizes)


@pytest.mark.parametrize("cell", TRAIN)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_is_not_correct(cell):
    from cmhse_tpu_torch.train import loop

    res = _run(cell, {"train_step": control.frozen(loop.train_step)})
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_not_correct(cell):
    from cmhse_tpu_torch.train import loop

    res = _run(cell, {"train_step": control.half_batch(loop.train_step)})
    assert not res["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN)
def test_tf32_control_fails_the_limits(card, cell):
    """The reference in TF32 in the program's place, at the cell's widths
    on a batch of 16: some number reads past its committed limit."""
    train_cell = common.load_module("runners", "train")
    c = common.load_json("cells", cell)
    config = common.load_json("configs", c["config"])
    mix = common.load_json("traffic", c["traffic"])
    sizes = {"data": {"batch_size": 16}, "mix": {"videos": 256}}
    for seed in (1, 2, 3):
        T = train_cell.prepare(c, config, mix, seed, card, sizes=sizes)
        train_cell.release(T)
        numbers = train_cell.judge_steps(T, tf32=True)
        assert any(numbers[k] > v for k, v in c["limits"].items())
