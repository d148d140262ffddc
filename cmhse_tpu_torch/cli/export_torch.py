"""``python -m cmhse_tpu_torch.cli.export_torch``, counterpart of
``cmhse-export`` (the inverse of ``cli.import_torch``): write a run
directory's best weights as a reference-style PyTorch checkpoint. By the
output's extension:

  * ``.pth`` / ``.pth.tar`` / ``.pt``: ``torch.save({'model': state_dict})``
    with f32 tensors;
  * ``.npz``: flat dotted names -> float32 arrays.

Layouts invert the import's (fused GRU ``[D, 3H]`` -> ``[3H, D]``, Dense
kernel ``[in, out]`` -> Linear ``[out, in]``), so export then import gives
back every tensor bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cmhse_tpu_torch.cli import add_platform_flag, device_for


def export_checkpoint(checkpoint_dir: str, out_path: str,
                      prefix_map: dict | None = None,
                      device: str | torch.device | None = None) -> dict:
    """Restore ``checkpoint_dir``'s best weights on ``device`` (the card
    unless ``"cpu"`` is passed), write them to ``out_path`` in the
    reference's layout (format by extension) and return that state dict of
    numpy arrays."""
    from cmhse_tpu_torch.interop import (params_to_jax_tree,
                                         state_dict_from_model_params)
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    out_path = os.path.abspath(out_path)
    if not out_path.endswith((".npz", ".pth", ".pt", ".pth.tar")):
        # before the restore: a bare .tar would be torch.save bytes
        # masquerading as a tar archive
        raise ValueError(
            f"unsupported output extension on {out_path!r} "
            "(use .pth/.pth.tar/.pt or .npz)")
    model, _ = restore_for_eval(checkpoint_dir, device=device)
    sd = state_dict_from_model_params(
        params_to_jax_tree(model.state_dict()), prefix_map)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if out_path.endswith(".npz"):
        np.savez(out_path, **sd)
    else:
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
                   out_path)
    return sd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.export_torch")
    p.add_argument("checkpoint_dir",
                   help="run directory (config.json + best)")
    p.add_argument("out", help="output path: .pth/.pth.tar/.pt or .npz")
    p.add_argument("--prefix_map", default=None,
                   help='JSON object remapping component -> torch module '
                        'prefix, e.g. \'{"video_low": "vid_enc"}\' (as for '
                        'cli.import_torch)')
    add_platform_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_for(args.platform)
    prefix_map = json.loads(args.prefix_map) if args.prefix_map else None
    sd = export_checkpoint(args.checkpoint_dir, args.out, prefix_map,
                           device=device)
    n = sum(int(v.size) for v in sd.values())
    print(f"exported {len(sd)} tensors ({n:,} parameters) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
