"""Retrieval evaluation, counterpart of ``cmhse_tpu/eval/retrieval.py``.

Encode a split, rank both directions on the device, report R@k / MedR /
MeanR / rsum; :func:`evalrank` does it for a checkpoint directory, the
reference's ``python evaluation.py`` entry. Galleries of at least
``STREAMING_GALLERY_MIN`` rows on the card rank through the ``rankcount``
kernel and never materialize ``[N, N]``. With a mesh
(:mod:`cmhse_tpu_torch.parallel`) each rank encodes its slice of every
batch, the embeddings are all-gathered, and the ranks are counted sharded
(:func:`~cmhse_tpu_torch.parallel.eval_sharded.sharded_retrieval_metrics`).
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


def _gather_batches(x: torch.Tensor, mesh, rows: int) -> torch.Tensor:
    """Every rank's encoded rows in the global batches' order: batch 0's
    rows of rank 0, 1, ..., then batch 1's. The loader gives every rank a
    contiguous slice of ``rows`` rows of every global batch."""
    from cmhse_tpu_torch.parallel.mesh import all_gather_rows

    g = all_gather_rows(x, mesh)
    return g.reshape(mesh.data_size, -1, rows, *x.shape[1:]).transpose(
        0, 1).reshape(-1, *x.shape[1:])


def validate_metrics(
    model,
    batches,
    ks: tuple[int, ...] = (1, 5, 10, 50),
    streaming: bool | None = None,
    return_ranks: bool = False,
    mesh=None,
    mode: str = "query",
):
    """Encode a split on the model's device and compute bidirectional
    retrieval metrics. ``streaming``: force the rank-count kernel path
    (True) or the dense path (False); None = by gallery size on the card.
    Returns plain floats; with ``return_ranks`` also a dict of int numpy
    ``v2p_ranks`` / ``p2v_ranks`` compacted to valid rows in dataset order
    (identical from the dense, streaming and sharded paths).

    ``mesh``: ``batches`` hold this rank's slice of every global batch (the
    loader's ``process_index`` / ``process_count``); each rank encodes its
    rows, the embeddings and validity are all-gathered into dataset order,
    and the ranks are counted sharded in ``mode`` ("query" or "gallery")."""
    if mesh is not None:
        from cmhse_tpu_torch.parallel.eval_sharded import \
            sharded_retrieval_metrics

        mesh.check_process_mesh("validate_metrics(mesh=)")
        # The JAX path pads each batch to whole rows a device (devices a
        # process); a rank is one device, so no batch needs padding.
        rows = []

        def counted(it):
            for b in it:
                rows.append(b.valid.shape[0])
                yield b

        video_embs, para_embs, valid = encode_gallery_device(
            model, counted(batches))
        if len(set(rows)) != 1:
            raise ValueError(f"sharded validation needs batches of one row "
                             f"count on every rank, got {sorted(set(rows))}")
        with torch.inference_mode():
            video_embs, para_embs, valid = (
                _gather_batches(x, mesh, rows[0])
                for x in (video_embs, para_embs, valid))
            metrics = sharded_retrieval_metrics(
                video_embs, para_embs, mesh, ks=ks, mode=mode, valid=valid,
                streaming=streaming, return_ranks=return_ranks)
        return _host_metrics(metrics, valid, return_ranks)
    if mode != "query":
        # mode picks how the sharded count splits its work: without a mesh
        # there is nothing to pick, so say so rather than ignore it
        print(f"validate_metrics: mode={mode!r} is a sharded-eval knob and "
              "has no effect without a mesh (pass --sharded)")
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
    return _host_metrics(metrics, valid, return_ranks)


def _host_metrics(metrics: dict, valid, return_ranks: bool):
    """Plain floats, and the rank vectors compacted to valid rows."""
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


def evalrank(
    checkpoint_path: str,
    data_path: str | None = None,
    split: str = "val",
    ks: tuple[int, ...] = (1, 5, 10, 50),
    streaming: bool | None = None,
    dump_ranks: str | None = None,
    device: str | torch.device | None = None,
    mesh=None,
    mode: str = "query",
) -> dict[str, float]:
    """Load a checkpoint and evaluate a split on ``device`` (the card
    unless ``"cpu"`` is passed), printing the R@k table.

    ``dump_ranks``: also write one JSONL line per example, ``{"index",
    "key", "v2p_rank", "p2v_rank"}``, in the JAX package's format, so two
    runs can be diffed line for line. ``mesh`` / ``mode``: sharded
    evaluation (see :func:`validate_metrics`); each rank loads its slice of
    every batch, and rank 0 alone writes the dump."""
    import json
    import os

    from cmhse_tpu_torch.data import (PrecompDataset, Vocabulary,
                                      batches_from_dataset, find_vocab)
    from cmhse_tpu_torch.train.checkpoint import restore_for_eval

    if dump_ranks is not None:
        # fail on an unwritable dump path before the encode; make missing
        # parent directories, probe without truncating
        os.makedirs(os.path.dirname(os.path.abspath(dump_ranks)),
                    exist_ok=True)
        with open(dump_ranks, "a"):
            pass

    model, cfg = restore_for_eval(checkpoint_path, device=device)
    data_path = data_path or cfg.data.data_path
    vocab = Vocabulary.load(find_vocab(data_path))
    # a flat model takes the whole video as one clip and the paragraph as
    # one sentence, as the train CLI sets it
    dataset = PrecompDataset(data_path, split, vocab,
                             feat_dim=cfg.data.feat_dim,
                             flat=not cfg.model.hierarchical)
    # under a mesh each rank loads its slice of every batch; full batches
    # on every rank would repeat each gallery row once a rank
    slicing = ({} if mesh is None else
               dict(process_index=mesh.data_index,
                    process_count=mesh.data_size))
    batches = batches_from_dataset(dataset, cfg.data, shuffle=False,
                                   **slicing)
    out = validate_metrics(model, batches, ks=ks, streaming=streaming,
                           return_ranks=dump_ranks is not None, mesh=mesh,
                           mode=mode)
    metrics, ranks = out if dump_ranks is not None else (out, None)
    # the table first: a failed dump write must not lose the metrics
    print(format_table(metrics, ks))
    if ranks is not None and (mesh is None or mesh.rank == 0):
        v2p, p2v = ranks["v2p_ranks"], ranks["p2v_ranks"]
        with open(dump_ranks, "w") as f:
            for i in range(len(v2p)):
                f.write(json.dumps({
                    "index": i,
                    "key": dataset.keys[i],
                    "v2p_rank": int(v2p[i]),
                    "p2v_rank": int(p2v[i]),
                }) + "\n")
        print(f"wrote {len(v2p)} per-query ranks to {dump_ranks}")
    return metrics
