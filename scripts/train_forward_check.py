#!/usr/bin/env python3
"""Where does the card's full-width training forward leave the CPU's?

``chip_smoke.py`` phase 5's weights and 64-video batch (``cmhse_full`` at
its published widths, seed 0): the training forward (autograd on, so the
GRUs run their gate-saving kernels) and the encode forward (no autograd)
on the card, each against the CPU's plain path from the same weights.
Prints, for every submodule stage (the four sequence encoders and the
two decoders) and for the loss terms, the largest absolute difference.
It also prints the CPU's loss terms and a checksum of the fresh weights
(the sum of every parameter's absolute values), which differ between
machines whose torch versions draw other numbers from one seed; with
``--cpu-only`` it prints only those, and needs no card. Run from the
repository root::

    python3 scripts/train_forward_check.py [--seed N] [--batch B] [--cpu-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, action="append", default=[])
    ap.add_argument("--cpu-only", action="store_true")
    args = ap.parse_args()
    import torch

    if not args.cpu_only and not torch.cuda.is_available():
        print("train_forward_check: no CUDA device", file=sys.stderr)
        return 1
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import total_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)
    if not args.cpu_only:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}", flush=True)
    cfg = get_preset("cmhse_full")
    stages = ("video_low", "text_low", "video_high", "text_high",
              "video_decoder", "text_decoder")
    for bsz in args.batch or [64, 8]:
        dc = dataclasses.replace(cfg.data, batch_size=bsz)
        ds = SyntheticHierarchicalDataset(
            num_videos=bsz, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
            max_clips=dc.max_clips, max_frames=dc.max_frames,
            max_words=dc.max_words, seed=args.seed + 1)
        host = next(batches_from_dataset(ds, dc, shuffle=False))
        res = {}
        runs = (("cpu", True),) if args.cpu_only else (
            ("cpu", True), ("cuda", True), ("cuda", False))
        for dev, grad in runs:
            model = CMHSE(cfg.model, dc.vocab_size, device=dev,
                          generator=torch.Generator().manual_seed(args.seed))
            if dev == "cpu":
                total = sum(float(p.detach().abs().double().sum())
                            for p in model.parameters())
                print(f"batch {bsz}: fresh weights from seed {args.seed}, "
                      f"sum of |w| {total!r}", flush=True)
            seen = {}

            def hook(name):
                def fn(_, __, out):
                    first = out[0] if isinstance(out, tuple) else out
                    seen[name] = first.detach().float().cpu()
                return fn

            for name in stages:
                getattr(model, name).register_forward_hook(hook(name))
            b = host.to(dev)
            with torch.set_grad_enabled(grad):
                loss, metrics = total_loss(model(b), b, cfg.loss)
            seen.update({k: v.detach().float().cpu().reshape(1)
                         for k, v in metrics.items()})
            res[(dev, grad)] = seen
        want = res[("cpu", True)]
        print(f"batch {bsz}, CPU loss terms: " + ", ".join(
            f"{k} {float(want[k][0])!r}" for k in want if k.startswith(
                "loss")), flush=True)
        for key in runs[1:]:
            label = "training forward" if key[1] else "no autograd"
            got = res[key]
            parts = []
            for name, w in want.items():
                d = (got[name] - w).abs().max().item()
                parts.append(f"{name} {d:.3g}")
            print(f"batch {bsz}, card {label} vs CPU, largest |diff|: "
                  + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
