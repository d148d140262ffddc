"""Readings that set a cell's limits, on the card at the cell's own size:
the program's numbers over many seeds, the control's (the reference put
in the program's place one precision below the configuration's), and the
faults that a cell can have. One process, seed after seed.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--faults 3]

Training cells: set-up's checked steps (the first three and the late
ones) of the program against the reference's, the reference in TF32
against the reference in float32, and the half-batch fault (rows past the
middle left out, the mean over the rest) on the first ``--faults`` seeds.
One JSON line a seed.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common  # noqa: E402


def half_batch(train_step):
    """The fault: each step leaves out the batch's rows past the middle
    and takes its mean over the rest."""
    import torch

    def step(state, batch, loss_cfg):
        batch = batch.to(state.model.device)
        b = batch.valid.shape[0]
        keep = torch.arange(b, device=batch.valid.device) < b // 2
        return train_step(state, dataclasses.replace(
            batch, valid=batch.valid & keep), loss_cfg)
    return step


def frozen(train_step):
    """The fault: each step computes its loss and gradients and returns
    the parameters unchanged."""
    import torch

    def step(state, batch, loss_cfg):
        saved = [p.detach().clone() for p in state.model.parameters()]
        state, metrics = train_step(state, batch, loss_cfg)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        return state, metrics
    return step


def _public(numbers: dict) -> dict:
    return {k: v for k, v in numbers.items() if k != "_left_out"}


def train_readings(cell, config, mix, seeds, faults, device) -> None:
    from cmhse_tpu_torch.train import loop

    train_cell = common.load_module("runners", "train")

    for i, seed in enumerate(seeds):
        t = time.time()
        T = train_cell.prepare(cell, config, mix, seed, device)
        train_cell.release(T)
        out = {"seed": seed,
               "program": _public(train_cell.judge_steps(T)),
               "tf32": _public(train_cell.judge_steps(T, tf32=True))}
        if i < faults:
            F = train_cell.prepare(cell, config, mix, seed, device,
                                   hooks={"train_step":
                                          half_batch(loop.train_step)})
            train_cell.release(F)
            out["half_batch"] = _public(train_cell.judge_steps(F))
        out["seconds"] = time.time() - t
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    common.prepare_environment()
    import torch

    common.card_or_exit(torch, 1)
    torch.set_num_threads(common.HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {common.power_limit()}", flush=True)
    device = torch.device("cuda")
    cell = common.load_json("cells", args.workload)
    config = common.load_json("configs", cell["config"])
    mix = common.load_json("traffic", cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    train_readings(cell, config, mix, seeds, args.faults, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
