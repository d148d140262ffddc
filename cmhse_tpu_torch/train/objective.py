"""The full CMHSE training objective, counterpart of
``cmhse_tpu/train/objective.py``::

    L = w_high * L_rank(video, paragraph)
      + w_low  * L_rank(clips, sentences)          (flattened across batch)
      + tau    * (L_recon_video + L_recon_text)

The low-level term aligns clip k of video i with sentence k of video i; all
slots sharing a (video, k) group id are masked as positives.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.config import LossConfig
from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.models.cmhse import ModelOutputs
from cmhse_tpu_torch.ops.loss import (contrastive_loss, pair_masks,
                                      positive_mask_from_ids,
                                      reconstruction_loss)
from cmhse_tpu_torch.ops.similarity import cosine_sim
from cmhse_tpu_torch.ops.simhinge_kernel import \
    fused_contrastive_loss_from_masks


def _rank_loss(emb_a, emb_b, cfg: LossConfig, positive_mask, valid):
    """The hardest-negative variant takes the fused loss — the ``simhinge``
    kernel on a CUDA tensor, its plain version on the CPU — whatever
    ``cfg.use_pallas`` says: the port chooses by the device, and keeps the
    flag only so that ``config.json`` round-trips with the JAX package. The
    sum-over-negatives variant is plain torch, as in JAX."""
    if cfg.max_violation:
        return fused_contrastive_loss_from_masks(
            emb_a, emb_b, margin=cfg.margin, positive_mask=positive_mask,
            valid=valid)
    return contrastive_loss(emb_a, emb_b, margin=cfg.margin,
                            max_violation=False, positive_mask=positive_mask,
                            valid=valid)


def _rank_levels(outputs: ModelOutputs, batch: Batch, cfg: LossConfig):
    """(metric name, weight, emb_a, emb_b, positive mask, valid) of each
    ranking term the config turns on: video <-> paragraph, then clip <->
    sentence flattened over the batch."""
    levels = []
    if cfg.high_weight:
        high_pos = positive_mask_from_ids(batch.video_ids, batch.video_ids)
        levels.append(("loss_high", cfg.high_weight, outputs.video_emb,
                       outputs.para_emb, high_pos, batch.valid.bool()))
    if cfg.low_weight:
        b, cmax, e = outputs.clip_emb.shape
        smax = outputs.sent_emb.shape[1]
        if cmax != smax:
            raise ValueError(
                "low-level loss requires aligned clip/sentence slot counts; "
                f"got Cmax={cmax} Smax={smax}")
        clips = outputs.clip_emb.reshape(b * cmax, e)
        sents = outputs.sent_emb.reshape(b * smax, e)
        slot = torch.arange(cmax, device=batch.video_ids.device)[None, :]
        pair_ids = (batch.video_ids[:, None] * cmax + slot).reshape(-1)
        low_pos = positive_mask_from_ids(pair_ids, pair_ids)
        low_valid = (outputs.clip_valid.reshape(-1)
                     & outputs.sent_valid.reshape(-1))
        levels.append(("loss_low", cfg.low_weight, clips, sents, low_pos,
                       low_valid))
    return levels


def _recon_term(outputs: ModelOutputs, cfg: LossConfig):
    """Both reconstruction losses summed, or None when the term is off
    (gated on the model producing decoder outputs, not only on the
    weight)."""
    if not cfg.recon_weight or outputs.video_recon is None:
        return None
    return (reconstruction_loss(outputs.video_recon, outputs.clip_emb,
                                outputs.clip_valid)
            + reconstruction_loss(outputs.text_recon, outputs.sent_emb,
                                  outputs.sent_valid))


def total_loss(outputs: ModelOutputs, batch: Batch, cfg: LossConfig
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(scalar loss, metrics) in float32; ``batch`` holds tensors on the
    outputs' device. Metrics: ``loss_high``, ``loss_low``, ``loss_recon``
    (each when its term is on) and ``loss``."""
    metrics: dict[str, torch.Tensor] = {}
    loss = torch.zeros((), dtype=torch.float32,
                       device=outputs.video_emb.device)
    for name, weight, emb_a, emb_b, pos, valid in _rank_levels(
            outputs, batch, cfg):
        term = _rank_loss(emb_a, emb_b, cfg, pos, valid)
        metrics[name] = term
        loss = loss + weight * term
    recon = _recon_term(outputs, cfg)
    if recon is not None:
        metrics["loss_recon"] = recon
        loss = loss + cfg.recon_weight * recon
    metrics["loss"] = loss
    return loss, metrics


def hardest_negatives(outputs: ModelOutputs, batch: Batch, cfg: LossConfig
                      ) -> list[torch.Tensor]:
    """The negatives the hardest-negative objective picks: for each ranking
    term, row i's hardest negative column, then column j's hardest negative
    row (int64, -1 where the query is invalid or has no negative; the
    earliest index on a tie). For :func:`total_loss_at`."""
    picks = []
    for _, _, emb_a, emb_b, pos, valid in _rank_levels(outputs, batch, cfg):
        sims = cosine_sim(emb_a, emb_b).detach()
        valid, neg = pair_masks(sims.shape[0], pos, valid, sims.device)
        sims = torch.where(neg, sims, float("-inf"))
        for dim in (1, 0):
            has = neg.any(dim) & valid
            picks.append(torch.where(has, sims.argmax(dim), -1))
    return picks


def total_loss_at(outputs: ModelOutputs, batch: Batch, cfg: LossConfig,
                  negatives: list[torch.Tensor]) -> torch.Tensor:
    """The hardest-negative :func:`total_loss` with its negatives given
    (as :func:`hardest_negatives` returns them) instead of searched: the
    same loss and gradients at the picks the search makes.

    Where similarities nearly tie (bf16 at random init) two implementations
    of the objective may pick different negatives, which moves whole rows
    of gradient; given the same negatives, their gradients compare."""
    if not cfg.max_violation:
        raise ValueError("total_loss_at takes the hardest-negative objective")
    loss = torch.zeros((), dtype=torch.float32,
                       device=outputs.video_emb.device)
    picks = iter(negatives)
    for _, weight, emb_a, emb_b, _, valid in _rank_levels(outputs, batch,
                                                         cfg):
        a, b = emb_a.float(), emb_b.float()
        diag = torch.sum(a * b, dim=-1)
        cost = torch.zeros_like(diag)
        for pick, other in ((next(picks), lambda i: b[i] * a),
                            (next(picks), lambda i: a[i] * b)):
            sims = torch.sum(other(pick.clamp_min(0)), dim=-1)
            hinge = torch.clamp(cfg.margin + sims - diag, min=0.0)
            cost = cost + torch.where(pick >= 0, hinge, 0.0)
        n_valid = torch.clamp(valid.float().sum(), min=1.0)
        loss = loss + weight * torch.where(valid, cost, 0.0).sum() / n_valid
    recon = _recon_term(outputs, cfg)
    if recon is not None:
        loss = loss + cfg.recon_weight * recon
    return loss
