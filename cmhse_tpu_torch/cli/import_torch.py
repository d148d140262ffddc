"""``python -m cmhse_tpu_torch.cli.import_torch``, counterpart of
``cmhse-import``: convert a reference PyTorch checkpoint into a run
directory of the port (``config.json`` + ``best``), which
``cli.evaluate`` and ``cli.retrieve`` then take.

The model's hyperparameters are inferred from the state dict's shapes and
keys (:func:`cmhse_tpu_torch.interop.infer_model_structure`), so the
minimal call is ``import_torch ref.pth.tar runs/imported``. Inputs:

  * ``.pth`` / ``.pth.tar`` / ``.pt``: read with ``torch.load``, the state
    dict found under ``model`` / ``state_dict`` or at the root;
  * ``.npz``: flat dotted names -> arrays.

Module names other than the documented replica naming are mapped with
``--prefix_map '{"video_low": "vid_enc", ...}'``. The ``config.json``
written here is the port's, which the JAX package also reads.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from cmhse_tpu_torch.cli import add_platform_flag, device_for


def load_flat_state_dict(path: str, allow_unsafe: bool = False) -> dict:
    """A flat name -> numpy dict from ``.pth``/``.pt``/``.pth.tar`` or
    ``.npz``.

    ``torch.load`` runs in its safe ``weights_only`` mode; full pickle
    deserialization, which executes code embedded in the file, runs only
    when that fails and the caller passed ``allow_unsafe`` for this call."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as safe_err:
        if not allow_unsafe:
            raise ValueError(
                f"{path}: not loadable with torch's safe weights_only mode "
                f"({safe_err}). If you trust this checkpoint, re-run with "
                "--unsafe-load (full pickle deserialization executes "
                "arbitrary code embedded in the file)."
            ) from safe_err
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(obj)}")

    def to_np(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            # bf16/f16 tensors have no numpy dtype: floats go to f32
            return (v.float() if v.is_floating_point() else v).numpy()
        return np.asarray(v)

    return {k: to_np(v) for k, v in obj.items()}


def import_checkpoint(
    flat_sd: dict,
    out_dir: str,
    prefix_map: dict | None = None,
    dtype: str = "float32",
    readout: str = "last",
) -> tuple:
    """Convert, check against the model's structure and write a run
    directory; returns (the port's state_dict, cfg)."""
    from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig,
                                        LossConfig, ModelConfig, TrainConfig,
                                        get_preset)
    from cmhse_tpu_torch.interop import (infer_model_structure,
                                         model_params_from_state_dict,
                                         params_from_jax)
    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train.checkpoint import eval_payload, write_best_dir

    info = infer_model_structure(flat_sd, prefix_map)
    vocab_size = info.pop("vocab_size")
    # the readout ('last' or 'mean') has no parameters: the caller says
    mcfg = ModelConfig(dtype=dtype, readout=readout, **info)
    if mcfg.hierarchical:
        data_cfg = DataConfig(vocab_size=vocab_size, feat_dim=mcfg.feat_dim)
    else:
        # a flat model takes the whole video as one clip: the flat preset's
        # caps, not the hierarchical defaults that would truncate it
        caps = get_preset("flat_anet_subset").data
        data_cfg = DataConfig(vocab_size=vocab_size, feat_dim=mcfg.feat_dim,
                              max_clips=caps.max_clips,
                              max_sentences=caps.max_sentences,
                              max_frames=caps.max_frames,
                              max_words=caps.max_words)
    cfg = ExperimentConfig(name="imported", data=data_cfg, model=mcfg,
                           loss=LossConfig(),
                           train=TrainConfig(checkpoint_dir=out_dir))

    state = params_from_jax(model_params_from_state_dict(
        flat_sd, hierarchical=mcfg.hierarchical,
        reconstruction=mcfg.reconstruction, prefix_map=prefix_map))

    # against a fresh model of the inferred structure: the same names and
    # shapes, so a wrong prefix_map or flag fails here, readably
    template = CMHSE(mcfg, vocab_size, device="cpu").state_dict()
    t_shapes = {k: tuple(v.shape) for k, v in template.items()}
    p_shapes = {k: tuple(v.shape) for k, v in state.items()}
    if t_shapes != p_shapes:
        raise ValueError(
            "imported params do not match the model structure:\n"
            f"  expected: {t_shapes}\n  imported: {p_shapes}"
        )

    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    write_best_dir(out_dir, eval_payload(state))
    return state, cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmhse_tpu_torch.cli.import_torch")
    p.add_argument("checkpoint", help=".pth/.pth.tar/.pt or .npz state_dict")
    p.add_argument("out_dir", help="output run directory (for "
                                   "cli.evaluate / cli.retrieve)")
    p.add_argument("--prefix_map", default=None,
                   help='JSON object remapping component -> torch module '
                        'prefix, e.g. \'{"video_low": "vid_enc"}\'')
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype recorded in the imported config")
    p.add_argument("--readout", default="last", choices=["last", "mean"],
                   help="low-level GRU readout of the source model; it has "
                        "no parameters, so shapes cannot tell")
    add_platform_flag(p)
    p.add_argument("--unsafe-load", action="store_true",
                   help="allow full pickle deserialization for checkpoints "
                        "torch's safe weights_only loader rejects (executes "
                        "code embedded in the file: trusted inputs only)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device_for(args.platform)
    prefix_map = json.loads(args.prefix_map) if args.prefix_map else None
    flat = load_flat_state_dict(args.checkpoint,
                                allow_unsafe=args.unsafe_load)
    state, cfg = import_checkpoint(flat, args.out_dir, prefix_map=prefix_map,
                                   dtype=args.dtype, readout=args.readout)
    n = sum(int(v.numel()) for v in state.values())
    print(f"imported {len(flat)} tensors ({n:,} parameters) -> "
          f"{args.out_dir} (model: {cfg.model})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
