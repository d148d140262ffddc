"""Contrastive max-of-hinges ranking loss and the reconstruction loss,
counterpart of ``cmhse_tpu/ops/loss.py`` (plain PyTorch: the JAX package
computes these with no kernel).

The fused hardest-negative variant on the ``simhinge`` kernel lives in
:mod:`cmhse_tpu_torch.ops.simhinge_kernel`; both compute the same loss.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.ops.similarity import cosine_sim


def positive_mask_from_ids(a_ids: torch.Tensor,
                           b_ids: torch.Tensor) -> torch.Tensor:
    """``mask[i, j] = True`` iff ``a_ids[i] == b_ids[j]`` (same group =>
    positive). Padded slots are handled by the loss's ``valid`` argument."""
    return a_ids[:, None] == b_ids[None, :]


def pair_masks(b: int, positive_mask: torch.Tensor | None,
               valid: torch.Tensor | None, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(valid ``[B]``, negatives ``[B, B]``) with the JAX package's
    defaults: the identity as positives, every row valid."""
    if positive_mask is None:
        positive_mask = torch.eye(b, dtype=torch.bool, device=device)
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=device)
    valid = valid.bool()
    pair_valid = valid[:, None] & valid[None, :]
    return valid, ~positive_mask.bool() & pair_valid


def contrastive_loss(
    emb_a: torch.Tensor,
    emb_b: torch.Tensor,
    margin: float = 0.2,
    max_violation: bool = True,
    positive_mask: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bidirectional hinge ranking loss over the in-batch similarity matrix.

    ``emb_a``/``emb_b``: ``[B, D]`` L2-normalized, row ``i`` of each the
    positive of the other's row ``i``. ``max_violation``: hardest negative
    per query (VSE++) or the sum over negatives. ``positive_mask``: bool
    ``[B, B]`` (default the identity); ``valid``: bool ``[B]``, False rows
    are excluded as queries and as negatives. Returns the float32 mean over
    valid queries of both directions' terms summed.
    """
    b = emb_a.shape[0]
    sims = cosine_sim(emb_a, emb_b)
    valid, neg_mask = pair_masks(b, positive_mask, valid, sims.device)
    diag = torch.diagonal(sims)
    cost_ab = torch.clamp(margin + sims - diag[:, None], min=0.0)
    cost_ab = torch.where(neg_mask, cost_ab, 0.0)
    cost_ba = torch.clamp(margin + sims - diag[None, :], min=0.0)
    cost_ba = torch.where(neg_mask, cost_ba, 0.0)
    if max_violation:
        loss_ab = torch.amax(cost_ab, dim=1)
        loss_ba = torch.amax(cost_ba, dim=0)
    else:
        loss_ab = torch.sum(cost_ab, dim=1)
        loss_ba = torch.sum(cost_ba, dim=0)
    n_valid = torch.clamp(valid.float().sum(), min=1.0)
    return torch.where(valid, loss_ab + loss_ba, 0.0).sum() / n_valid


def reconstruction_loss(pred: torch.Tensor, target: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked squared error summed over the feature axis, mean over valid
    slots: ``pred``/``target`` ``[B, T, D]``, ``mask`` bool ``[B, T]``."""
    err = torch.square((pred - target).float()).sum(dim=-1)
    err = torch.where(mask, err, 0.0)
    return err.sum() / torch.clamp(mask.float().sum(), min=1.0)
