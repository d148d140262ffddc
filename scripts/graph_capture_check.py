#!/usr/bin/env python3
"""Is a captured train step bitwise equal to the eager one on the card?

At full ``cmhse_full`` width on one batch of 8 synthetic videos, from one
set of weights, compares every parameter's gradient (forward, loss and
backward; no optimizer step) between:

  * two eager runs on the default stream (is the eager step repeatable?);
  * an eager run on a side stream;
  * a CUDA-graph replay of the step, captured on a side stream after one
    eager warm-up there;

and prints, for each pair, whether all gradients are bitwise equal and the
parameters whose gradients differ, with the largest difference over the
gradient's largest entry. Run on a CUDA machine from the repository root::

    python3 scripts/graph_capture_check.py
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_capture_check: no CUDA device", file=sys.stderr)
        return 1
    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import total_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get_preset("cmhse_full")
    dc = dataclasses.replace(cfg.data, batch_size=8)
    ds = SyntheticHierarchicalDataset(
        num_videos=8, feat_dim=dc.feat_dim, vocab_size=dc.vocab_size,
        max_clips=dc.max_clips, max_frames=dc.max_frames,
        max_words=dc.max_words, seed=3)
    batch = next(batches_from_dataset(ds, dc, shuffle=False)).to("cuda")
    model = CMHSE(cfg.model, dc.vocab_size,
                  generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())

    def grads():
        for p in params.values():
            p.grad = None
        loss, _ = total_loss(model(batch), batch, cfg.loss)
        loss.backward()
        return {k: (p.grad if p.grad is not None
                    else torch.zeros_like(p)) for k, p in params.items()}

    def snapshot(g):
        return {k: v.detach().clone() for k, v in g.items()}

    ref = snapshot(grads())
    runs = {"eager again": snapshot(grads())}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs["eager, side stream"] = snapshot(grads())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        static = grads()
    graph.replay()
    torch.cuda.synchronize()
    runs["graph replay"] = snapshot(static)
    for name, got in runs.items():
        diff = {}
        for k, want in ref.items():
            if not torch.equal(got[k], want):
                d = (got[k] - want).abs().max().item()
                diff[k] = d / max(want.abs().max().item(), 1e-30)
        print(f"{name}: bitwise equal {not diff}; {len(diff)} of "
              f"{len(ref)} gradients differ", flush=True)
        for k, rel in sorted(diff.items(), key=lambda kv: -kv[1]):
            print(f"    {k}: {rel:.3g} of its largest entry")
    return 0


if __name__ == "__main__":
    sys.exit(main())
