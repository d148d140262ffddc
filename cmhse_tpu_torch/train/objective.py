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
from cmhse_tpu_torch.ops.loss import (contrastive_loss, positive_mask_from_ids,
                                      reconstruction_loss)
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


def total_loss(outputs: ModelOutputs, batch: Batch, cfg: LossConfig
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(scalar loss, metrics) in float32; ``batch`` holds tensors on the
    outputs' device. Metrics: ``loss_high``, ``loss_low``, ``loss_recon``
    (each when its term is on) and ``loss``."""
    metrics: dict[str, torch.Tensor] = {}
    loss = torch.zeros((), dtype=torch.float32,
                       device=outputs.video_emb.device)
    valid = batch.valid.bool()

    if cfg.high_weight:
        high_pos = positive_mask_from_ids(batch.video_ids, batch.video_ids)
        l_high = _rank_loss(outputs.video_emb, outputs.para_emb, cfg,
                            high_pos, valid)
        metrics["loss_high"] = l_high
        loss = loss + cfg.high_weight * l_high

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
        l_low = _rank_loss(clips, sents, cfg, low_pos, low_valid)
        metrics["loss_low"] = l_low
        loss = loss + cfg.low_weight * l_low

    # gated on the model producing decoder outputs, not only on the weight
    if cfg.recon_weight and outputs.video_recon is not None:
        l_rec_v = reconstruction_loss(outputs.video_recon, outputs.clip_emb,
                                      outputs.clip_valid)
        l_rec_t = reconstruction_loss(outputs.text_recon, outputs.sent_emb,
                                      outputs.sent_valid)
        metrics["loss_recon"] = l_rec_v + l_rec_t
        loss = loss + cfg.recon_weight * (l_rec_v + l_rec_t)

    metrics["loss"] = loss
    return loss, metrics
