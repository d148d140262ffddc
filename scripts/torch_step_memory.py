#!/usr/bin/env python3
"""Device memory of the PyTorch port's full-width cmhse_full train step, in
f32 and bf16, for the port found in each tree given (default: this
checkout), so that two commits can be compared on one card::

    python3 scripts/torch_step_memory.py [TREE ...]

A tree is a directory holding a ``cmhse_tpu_torch`` package (for example an
unpacked ``git archive`` of another commit); its kernels are built there.
Each tree and type runs in a process of its own, set up as phase 5 of
``chip_smoke.py`` (``train_setup``) with nothing else alive: the peak of
``chip_smoke.TRAIN_STEPS`` steps from a fresh state (the number phases
5/5d print as "peak device memory"), then one more step measured by
``chip_smoke.step_memory``. Prints one JSON line per tree and type. Needs a
CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys
sys.path[:0] = [{tree!r}]
sys.path.append({root!r})
import torch
import chip_smoke
import cmhse_tpu_torch
from cmhse_tpu_torch.train import train_step

assert cmhse_tpu_torch.__file__.startswith({tree!r}), cmhse_tpu_torch.__file__
cfg, model, state, batch = chip_smoke.train_setup(torch, 0, {bf16!r})
torch.cuda.reset_peak_memory_stats()
for _ in range(chip_smoke.TRAIN_STEPS):
    state, _ = train_step(state, batch, cfg.loss)
torch.cuda.synchronize()
steps_peak = torch.cuda.max_memory_allocated()
m = chip_smoke.step_memory(torch, state, batch, cfg.loss, top=10)
print(json.dumps(dict(tree={tree!r}, dtype=cfg.model.dtype,
                      steps=chip_smoke.TRAIN_STEPS, steps_peak=steps_peak,
                      **m)))
"""


def main() -> int:
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]] or [str(ROOT)]
    for tree in trees:
        for bf16 in (False, True):
            code = CHILD.format(tree=tree, root=str(ROOT), bf16=bf16)
            out = subprocess.run([sys.executable, "-c", code],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            line = out.stdout.strip().splitlines()[-1]
            m = json.loads(line)
            print(f"{tree} {m['dtype']}: {m['steps']} steps peak "
                  f"{m['steps_peak'] / 2**30:.4f} GiB; one step: start "
                  f"{m['start'] / 2**30:.4f}, peak {m['peak'] / 2**30:.4f} "
                  f"GiB", flush=True)
            for where, size in m["sites"]:
                print(f"    {size / 2**20:10.1f} MiB  {where}", flush=True)
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
