"""Retrieval evaluation, counterpart of ``cmhse_tpu/eval/retrieval.py``
(single device; the sharded mesh path and ``evalrank`` wait).

Encode a split, rank both directions on the device, report R@k / MedR /
MeanR / rsum. Galleries of at least ``STREAMING_GALLERY_MIN`` rows on the
card rank through the ``rankcount`` kernel and never materialize ``[N, N]``.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.eval.encode import encode_gallery_device
from cmhse_tpu_torch.ops.rankcount_kernel import rank_counts, should_stream
from cmhse_tpu_torch.ops.ranking import (bidirectional_metrics,
                                         bidirectional_metrics_from_ranks)
from cmhse_tpu_torch.ops.similarity import cosine_sim


def streaming_bidirectional_metrics(
    v_emb: torch.Tensor,
    p_emb: torch.Tensor,
    ks: tuple[int, ...] = (1, 5, 10, 50),
    valid: torch.Tensor | None = None,
    return_ranks: bool = False,
    precision: str = "float32",
) -> dict:
    """Bidirectional metrics via the streaming rank count. Same rank
    semantics as :func:`bidirectional_metrics` (strict-greater counting,
    NaN positives rank worst); the positive score is the row-wise dot,
    reduced in f32. ``valid``: row validity; invalid rows are excluded as
    queries and as gallery items. ``precision``: the rank count's product,
    ``"float32"`` or ``"bfloat16"`` (bf16 multiplies, f32 accumulation; see
    :func:`cmhse_tpu_torch.ops.rankcount_kernel.violation_counts`). The f32
    count takes f32 copies of bf16 embeddings (exact); the bf16 one takes
    the embeddings in their own type."""
    pos_score = torch.sum(v_emb.float() * p_emb.float(), dim=1)
    if valid is not None:
        # invalid rows must not look like (possibly NaN) real queries
        pos_score = torch.where(valid, pos_score, float("inf"))
    pos_idx = torch.arange(v_emb.shape[0], dtype=torch.int32,
                           device=v_emb.device)

    def rank_fn(a, b):
        if precision != "bfloat16":
            a, b = a.float(), b.float()
        return rank_counts(a.contiguous(), b.contiguous(), pos_score,
                           gallery_valid=valid, pos_idx=pos_idx,
                           precision=precision)

    return bidirectional_metrics_from_ranks(rank_fn, v_emb, p_emb, ks=ks,
                                            valid=valid,
                                            return_ranks=return_ranks)


def validate_metrics(
    model,
    batches,
    ks: tuple[int, ...] = (1, 5, 10, 50),
    streaming: bool | None = None,
    return_ranks: bool = False,
):
    """Encode a split on the model's device and compute bidirectional
    retrieval metrics. ``streaming``: force the rank-count kernel path
    (True) or the dense path (False); None = by gallery size on the card.
    Returns plain floats; with ``return_ranks`` also a dict of int numpy
    ``v2p_ranks`` / ``p2v_ranks`` compacted to valid rows in dataset order
    (identical from the dense and streaming paths)."""
    video_embs, para_embs, valid = encode_gallery_device(model, batches)
    with torch.inference_mode():
        if should_stream(video_embs.shape[0], video_embs.device, streaming):
            metrics = streaming_bidirectional_metrics(
                video_embs, para_embs, ks=ks, valid=valid,
                return_ranks=return_ranks)
        else:
            sims = cosine_sim(video_embs[valid], para_embs[valid])
            metrics = bidirectional_metrics(sims, ks=ks,
                                            return_ranks=return_ranks)
            valid = None  # ranks are already valid-rows-only
    ranks = {}
    for k in [k for k in metrics if k.endswith("_ranks")]:
        r = metrics.pop(k).cpu().numpy()
        ranks[k] = r[valid.cpu().numpy()] if valid is not None else r
    scalars = {k: float(v) for k, v in metrics.items()}
    return (scalars, ranks) if return_ranks else scalars


def format_table(metrics: dict, ks=(1, 5, 10, 50)) -> str:
    """Console table in the reference's format."""
    lines = []
    for direction, label in (("v2p", "Video to Paragraph"),
                             ("p2v", "Paragraph to Video")):
        rks = ", ".join(
            f"R@{k}: {metrics[f'{direction}_r@{k}']:.1f}" for k in ks
            if f"{direction}_r@{k}" in metrics
        )
        lines.append(
            f"{label}: {rks}, MedR: {metrics[f'{direction}_medr']:.1f}, "
            f"MeanR: {metrics[f'{direction}_meanr']:.1f}"
        )
    if "rsum" in metrics:
        lines.append(f"rsum: {metrics['rsum']:.1f}")
    return "\n".join(lines)
