"""``control.py``'s readings for a cell whose runner is ``train_tower`` (a
CMHSE with a DeepSeek-V2 stack as its sentence encoder): for each seed,
set-up's checked steps of the program against the reference's, the
reference in TF32 against the reference in float32, and the half-batch
fault on the first ``--faults`` seeds, on the card at the cell's own size,
one JSON line a seed (the routing numbers among them).

    python benchmark/control_tower.py --workload cmhse_dsv2_lite.train \
        --seeds 1,2,3 [--faults 1]
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import control  # noqa: E402
from harness import common  # noqa: E402


def readings(cell, config, mix, seeds, faults, device) -> None:
    from cmhse_tpu_torch.train import loop

    runner = common.load_module("runners", cell["kind"])
    for i, seed in enumerate(seeds):
        t = time.time()
        T = runner.prepare(cell, config, mix, seed, device)
        runner.release(T)
        out = {"seed": seed,
               "program": control._public(runner.judge_steps(T))}
        out["tf32"] = control._public(runner.judge_steps(T, tf32=True))
        del T
        if i < faults:
            F = runner.prepare(cell, config, mix, seed, device,
                               hooks={"train_step": control.half_batch(
                                   loop.train_step)})
            runner.release(F)
            out["half_batch"] = control._public(runner.judge_steps(F))
            del F
        out["seconds"] = time.time() - t
        print(json.dumps(out, default=str), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--faults", type=int, default=1)
    args = p.parse_args(argv)
    common.prepare_environment()
    import torch

    common.card_or_exit(torch, 1)
    torch.set_num_threads(common.HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {common.power_limit()}", flush=True)
    cell = common.load_json("cells", args.workload)
    config = common.load_json("configs", cell["config"])
    mix = common.load_json("traffic", cell["traffic"])
    readings(cell, config, mix, [int(s) for s in args.seeds.split(",")],
             args.faults, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
