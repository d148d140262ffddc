"""Train state and the update step, counterpart of
``cmhse_tpu/train/state.py``: forward, loss, backward, global-norm clip,
Adam.

The model's parameters are updated in place (the JAX step donates its
state and returns a new one; here the returned state is the one passed in,
its ``step`` advanced). ``train_steps`` (K steps in one dispatch) is not
ported: it amortises dispatch and belongs with the training loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cmhse_tpu_torch.config import ExperimentConfig, LossConfig
from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.models.cmhse import CMHSE
from cmhse_tpu_torch.train.objective import total_loss


@dataclass
class TrainState:
    """The model, its optimizer, the clip threshold and the step count."""

    model: CMHSE
    optimizer: torch.optim.Optimizer
    grad_clip: float
    step: int = 0


def make_optimizer(model: CMHSE, cfg: ExperimentConfig) -> torch.optim.Adam:
    """Adam at ``cfg.train.lr`` with optax's defaults: betas (0.9, 0.999),
    eps 1e-8 added outside the square root. The clip at
    ``cfg.train.grad_clip`` runs in :func:`train_step`, before it."""
    return torch.optim.Adam(model.parameters(), lr=cfg.train.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg: ExperimentConfig, model: CMHSE) -> TrainState:
    """A fresh state for ``model`` (built by the caller, on its device)."""
    return TrainState(model=model, optimizer=make_optimizer(model, cfg),
                      grad_clip=cfg.train.grad_clip)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """The reference's per-epoch ``adjust_learning_rate``: set the lr."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every gradient (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm`` in place: each gradient becomes
    ``(g / norm) * max_norm`` when ``norm >= max_norm`` and stays as it is
    otherwise (``torch.nn.utils.clip_grad_norm_`` differs: it scales by
    ``max_norm / (norm + 1e-6)``). Decided on the device, with no host
    sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def train_step(state: TrainState, batch: Batch, loss_cfg: LossConfig
               ) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimisation step; returns (state, metrics). Metrics are 0-d
    tensors on the model's device: the loss terms of :func:`total_loss`
    and ``grad_norm``, the global norm before clipping. A parameter that
    gets no gradient is given zeros, so Adam updates it as optax does."""
    model = state.model
    batch = batch.to(model.device)
    params = list(model.parameters())
    for p in params:
        p.grad = None
    outputs = model(batch)
    loss, metrics = total_loss(outputs, batch, loss_cfg)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    with torch.no_grad():
        norm = global_norm(grads)
    clip_by_global_norm_(grads, state.grad_clip, norm)
    state.optimizer.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = norm
    return state, metrics
