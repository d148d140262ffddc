#!/usr/bin/env python3
"""Is the loss rise of ``cmhse_full`` at lr 1e-3 the optimizer's or a fault?

Eight Adam steps at lr 1e-3 (clip 2.0) on one seeded full-width 64-video
batch, from one set of weights, three ways:

  * the JAX package on the CPU (``--jax``; needs JAX);
  * the port on the CPU (``--port cpu``);
  * the port on the card (``--port cuda``; ``chip_smoke.py`` phase 6e
    runs the same function and prints the same sequence).

The batch is ``chip_smoke.py`` phase 5's: the first batch of
``SyntheticHierarchicalDataset(64 videos, seed + 1)``. The weights are
drawn with numpy from ``seed`` (``numpy_weights``, in the distributions of
the port's fresh init), so that every machine gets the same ones: torch's
generators do not promise the same numbers across torch versions, and the
CPU and card runs may use different ones. The JAX run gets them as
a params tree (``params_to_jax`` below; ``interop.params_from_jax`` maps
it back bit for bit, which is checked). JAX runs its plain contrastive
loss (``use_pallas=False``: the same function as its fused kernel, without
interpret mode) and the scan GRU. Prints each run's eight losses, and with
two or more runs (or ``--card`` with the card's losses as a JSON list) the
largest relative difference per step against the first::

    python scripts/lr_rise_check.py --jax --port cpu [--card '[...]']
    python3 scripts/lr_rise_check.py --port cuda
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LR = 1e-3
STEPS = 8
LOSS_RTOL = 1e-4  # the f32 step tolerance of chip_smoke.py and the tests


def numpy_weights(model, seed: int) -> dict:
    """A ``state_dict`` for ``model`` drawn with numpy from ``seed``, in the
    port's init distributions: the word table uniform in +-0.1, GRU
    weights and biases uniform in +-1/sqrt(H), Dense kernels normal with
    variance 1/fan_in clipped at two standard deviations, Dense biases
    zero."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    out = {}
    for name, p in model.state_dict().items():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        if leaf == "embedding":
            arr = rng.uniform(-0.1, 0.1, shape)
        elif leaf == "weight":
            std = 1.0 / np.sqrt(shape[1])
            arr = np.clip(rng.standard_normal(shape), -2.0, 2.0) * std
        elif leaf == "bias":
            arr = np.zeros(shape)
        else:  # a GRU's w_i / w_h / b_i / b_h, H = the last dim / 3
            s = 1.0 / np.sqrt(shape[-1] // 3)
            arr = rng.uniform(-s, s, shape)
        out[name] = torch.from_numpy(arr.astype(np.float32))
    return out


def setup(seed: int):
    """(cfg, host batch, weights) of phase 5 at lr 1e-3."""
    import dataclasses

    import torch

    from cmhse_tpu_torch.config import get_preset
    from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                      batches_from_dataset)
    from cmhse_tpu_torch.models import CMHSE

    cfg = get_preset("cmhse_full")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=LR))
    dc = cfg.data
    ds = SyntheticHierarchicalDataset(
        num_videos=dc.batch_size, feat_dim=dc.feat_dim,
        vocab_size=dc.vocab_size, max_clips=dc.max_clips,
        max_frames=dc.max_frames, max_words=dc.max_words, seed=seed + 1)
    batch = next(batches_from_dataset(ds, dc, shuffle=False))
    model = CMHSE(cfg.model, dc.vocab_size, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    return cfg, batch, numpy_weights(model, seed)


def run_port(cfg, batch, weights, device: str) -> list[float]:
    import torch

    from cmhse_tpu_torch.models import CMHSE
    from cmhse_tpu_torch.train import create_train_state, train_step

    model = CMHSE(cfg.model, cfg.data.vocab_size, device=device)
    model.load_state_dict(weights)
    state = create_train_state(cfg, model)
    losses = []
    for _ in range(STEPS):
        state, m = train_step(state, batch, cfg.loss)
        losses.append(float(m["loss"]))
    if device == "cuda":
        torch.cuda.synchronize()
    return losses


def params_to_jax(weights: dict) -> dict:
    """The port's ``state_dict`` as a JAX ``CMHSE`` params tree: the
    inverse of ``interop.params_from_jax`` (``weight [out, in]`` back to
    ``kernel [in, out]``)."""
    import numpy as np

    tree: dict = {}
    for name, value in weights.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        arr = value.numpy()
        if leaf == "weight":
            node["kernel"] = np.array(arr.T, order="C")
        else:
            node[leaf] = np.array(arr)
    return tree


def run_jax(cfg, batch, weights) -> list[float]:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    import torch

    from cmhse_tpu.config import ExperimentConfig
    from cmhse_tpu.data.batch import Batch as JaxBatch
    from cmhse_tpu.train import create_train_state, train_step
    from cmhse_tpu_torch.interop import params_from_jax

    jcfg = ExperimentConfig.from_json(cfg.to_json())
    jcfg = jcfg.replace(loss=dataclasses.replace(jcfg.loss,
                                                 use_pallas=False))
    tree = params_to_jax(weights)
    back = params_from_jax(tree)
    assert back.keys() == weights.keys()
    for k, v in weights.items():
        if not torch.equal(back[k], v):
            raise AssertionError(f"params_to_jax does not invert {k}")
    jbatch = JaxBatch(**{f.name: np.asarray(getattr(batch, f.name))
                         for f in dataclasses.fields(JaxBatch)})
    state = create_train_state(jcfg, jax.random.PRNGKey(0), jbatch)
    params = jax.tree.map(jax.numpy.asarray, tree)
    if jax.tree.structure(params) != jax.tree.structure(state.params):
        raise AssertionError("the port's tree differs from the JAX model's")
    state = state.replace(params=params, opt_state=state.tx.init(params))
    losses = []
    for _ in range(STEPS):
        state, m = train_step(state, jbatch, jcfg.loss)
        losses.append(float(m["loss"]))
    return losses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jax", action="store_true",
                    help="run the JAX package on the CPU")
    ap.add_argument("--port", action="append", default=[],
                    choices=["cpu", "cuda"], help="run the port there")
    ap.add_argument("--card", default="",
                    help="the card's eight losses as a JSON list")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg, batch, weights = setup(args.seed)
    runs = {}
    if args.jax:
        t0 = time.perf_counter()
        runs["JAX, CPU"] = run_jax(cfg, batch, weights)
        print(f"JAX on the CPU: {time.perf_counter() - t0:.1f} s", flush=True)
    for dev in args.port:
        if dev == "cuda":
            print(torch.cuda.get_device_name(0), flush=True)
        t0 = time.perf_counter()
        runs[f"port, {dev}"] = run_port(cfg, batch, weights, dev)
        print(f"port on {dev}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.card:
        runs["port, card (chip_smoke.py)"] = json.loads(args.card)
    for name, losses in runs.items():
        print(json.dumps({"run": name, "lr": LR, "losses": losses}))
    names = list(runs)
    ok = True
    for other in names[1:]:
        rel = [abs(a - b) / abs(b) for a, b in zip(runs[other],
                                                   runs[names[0]])]
        ok &= max(rel) <= LOSS_RTOL
        print(f"{other} vs {names[0]}: largest relative difference a step "
              f"{max(rel):.3g} (limit {LOSS_RTOL}); per step "
              + ", ".join(f"{r:.2g}" for r in rel))
    for name, losses in runs.items():
        rises = sum(b > a for a, b in zip(losses, losses[1:]))
        print(f"{name}: first {losses[0]:.6f}, largest "
              f"{max(losses):.6f} at step {losses.index(max(losses)) + 1}, "
              f"last {losses[-1]:.6f}; {rises} of {STEPS - 1} steps rise")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
