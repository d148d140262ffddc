"""Encode throughput of the port in several trees, each in a fresh
interpreter, in the order given (pass a tree twice to run it in turns):
``chip_smoke.py``'s phase 4 and 4c serving paths and their encode
pipeline (through the prefetch and the pageable path), f32 and bf16.

Run on a machine with a CUDA card, from the repository root::

    python3 scripts/encode_ab.py PARENT_TREE TREE TREE PARENT_TREE

where each TREE is a checkout (e.g. an unpacked ``git archive``) holding
``chip_smoke.py`` and ``cmhse_tpu_torch/``. Prints, per tree, the
videos/s lines of the encode pipeline.
"""

import subprocess
import sys

CODE = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from cmhse_tpu_torch.ops import cuda_lib
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_lib.library()
out = cs.phase_main_path(torch, np, 0, 512)
cs.phase_encode_pipeline(torch, np, out["model"], out["batches"])
bf = cs.phase_serving_bf16(torch, np, out)
cs.phase_encode_pipeline(torch, np, bf["model"], bf["batches"])
'''


def main(trees: list[str]) -> int:
    failed = 0
    for tree in trees:
        p = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                           capture_output=True, text=True)
        print(tree, "rc", p.returncode, flush=True)
        for line in p.stdout.splitlines():
            if "prefetch" in line and "videos/s" in line:
                print("   ", line.strip(), flush=True)
        if p.returncode:
            failed += 1
            print(p.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
