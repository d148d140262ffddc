"""Checkpoints, counterpart of ``cmhse_tpu/train/checkpoint.py`` (the
reference's ``torch.save({epoch, model, best_rsum, opt, Eiters})`` each
epoch plus ``model_best.pth.tar`` when rsum improves, with ``--resume``).

Layout: ``<dir>/ckpt/<step>`` (one ``torch.save`` file a checkpoint, the
newest three kept), ``<dir>/config.json`` (the port's
``ExperimentConfig.to_json``, which the JAX package's reads too; with a
text tower, ``<dir>/text_tower.json`` beside it) and
``<dir>/best`` (rewritten when rsum improves). A training checkpoint holds
the model's and Adam's ``state_dict``, ``step``, ``epoch``, ``best_rsum``
and ``groups_done``; ``best`` and :func:`eval_payload` hold the model,
``step``, ``epoch`` and ``best_rsum``.

Every file is written under a temporary name and then moved into place
with ``os.replace``, so a process killed during a save leaves the previous
checkpoint whole. Files are read with ``torch.load(weights_only=True,
map_location="cpu")``: a checkpoint written on the card restores on the
CPU and the other way round.

The JAX package's checkpoints are orbax trees; this module does not read
them (orbax is not a dependency of the port). In a run of several
processes (``torchrun``) rank 0 alone writes the directory, as the JAX
module's process 0 does; every save ends at a barrier, so the other ranks
go on, and read the same files on a resume, only once the write is whole.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from cmhse_tpu_torch.config import ExperimentConfig
from cmhse_tpu_torch.parallel.mesh import barrier, process_index

MAX_TO_KEEP = 3


TOWER_FILE = "text_tower.json"


def load_text_tower(directory: str):
    """The run directory's ``TextTowerConfig`` (``text_tower.json``), or
    None when its model has the GRU sentence encoder."""
    from cmhse_tpu_torch.models.text_tower import TextTowerConfig

    path = os.path.join(_abs(directory), TOWER_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return TextTowerConfig.from_json(f.read())


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _atomic_save(payload: dict, path: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str) -> dict:
    return torch.load(path, weights_only=True, map_location="cpu")


def _steps(ckpt_dir: str) -> list[int]:
    """The steps that have a checkpoint under ``ckpt_dir``, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())


class CheckpointManager:
    """Save and restore a :class:`~cmhse_tpu_torch.train.state.TrainState`,
    the experiment config and the best-by-rsum checkpoint."""

    def __init__(self, directory: str, cfg: ExperimentConfig | None = None,
                 text_tower=None):
        """``text_tower`` (a ``TextTowerConfig``) is written beside
        ``config.json`` as ``text_tower.json``, which
        :func:`restore_for_eval` reads."""
        self.directory = _abs(directory)
        self.ckpt_dir = os.path.join(self.directory, "ckpt")
        if process_index() == 0:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            texts = {"config.json": None if cfg is None else cfg.to_json(),
                     TOWER_FILE: (None if text_tower is None
                                  else text_tower.to_json())}
            for name, text in texts.items():
                if text is None:
                    continue
                path = os.path.join(self.directory, name)
                tmp = f"{path}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    f.write(text)
                os.replace(tmp, path)
        barrier()

    # -- save ---------------------------------------------------------------

    def save(
        self,
        state,
        *,
        epoch: int,
        best_rsum: float,
        is_best: bool = False,
        groups_done: int = 0,
    ) -> None:
        """``groups_done``: dispatch groups of epoch ``epoch`` already
        consumed (mid-epoch snapshot position; 0 = epoch boundary). A save
        at a step that already has a checkpoint replaces it: a mid-epoch
        snapshot and the epoch-end save can land on one step, and the later
        one carries the advanced epoch. Rank 0 writes; every rank returns
        after the write."""
        if process_index() != 0:
            barrier()
            return
        sd = state.state_dict()
        payload = {
            "model": sd["model"],
            "optimizer": sd["optimizer"],
            "step": int(sd["step"]),
            "epoch": int(epoch),
            "best_rsum": float(best_rsum),
            "groups_done": int(groups_done),
        }
        _atomic_save(payload,
                     os.path.join(self.ckpt_dir, str(payload["step"])))
        for old in self.all_steps()[:-MAX_TO_KEEP]:
            os.remove(os.path.join(self.ckpt_dir, str(old)))
        if is_best:
            write_best_dir(self.directory, eval_payload(
                sd["model"], step=payload["step"], epoch=epoch,
                best_rsum=best_rsum))
        barrier()

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """The steps that have a checkpoint, oldest first."""
        return _steps(self.ckpt_dir)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self, state, step: int | None = None
    ) -> tuple[Any, int, float, int]:
        """Load a checkpoint into ``state`` (in place; it is also
        returned); returns (state, epoch, best_rsum, groups_done).
        ``groups_done`` is 0 for an epoch-boundary checkpoint, including
        one written without the key."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        payload = _load(os.path.join(self.ckpt_dir, str(step)))
        state.load_state_dict({"model": payload["model"],
                               "optimizer": payload["optimizer"],
                               "step": payload["step"]})
        return (state, int(payload["epoch"]), float(payload["best_rsum"]),
                int(payload.get("groups_done", 0)))

    def close(self) -> None:
        """Nothing to release: every save has finished when it returns
        (the JAX manager joins its writer thread here)."""


def write_best_dir(directory: str, payload: dict) -> None:
    """Write (replace) ``<dir>/best`` with a payload in the schema
    :func:`eval_payload` builds and :func:`restore_for_eval` reads."""
    _atomic_save(payload, os.path.join(_abs(directory), "best"))


def eval_payload(model_state: dict, *, step: int = 0, epoch: int = 0,
                 best_rsum: float = 0.0) -> dict:
    """A model-only checkpoint payload (no optimizer state) in the schema
    :func:`restore_for_eval` reads."""
    return {"model": model_state, "step": int(step), "epoch": int(epoch),
            "best_rsum": float(best_rsum)}


def restore_for_eval(directory: str, device: str | torch.device | None = None):
    """Rebuild ``(model, cfg)`` from a run directory's ``best`` or, when
    there is none, its latest checkpoint, with the model on ``device`` (the
    card unless ``"cpu"`` is passed). ``<run>/best`` is accepted for
    ``<run>``."""
    from cmhse_tpu_torch.models import CMHSE

    directory = _abs(directory)
    parent = os.path.dirname(directory)
    if (os.path.basename(directory) == "best"
            and not os.path.isdir(directory)
            and os.path.exists(os.path.join(parent, "config.json"))):
        directory = parent
    with open(os.path.join(directory, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    best = os.path.join(directory, "best")
    if os.path.exists(best):
        payload = _load(best)
    else:
        steps = _steps(os.path.join(directory, "ckpt"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        payload = _load(os.path.join(directory, "ckpt", str(steps[-1])))
    model = CMHSE(cfg.model, cfg.data.vocab_size, device=device,
                  text_tower=load_text_tower(directory))
    model.load_state_dict(payload["model"])
    return model, cfg
