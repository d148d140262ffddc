"""Sharded retrieval evaluation and top-k, counterpart of
``cmhse_tpu/parallel/eval_sharded.py`` (BASELINE config 5: a 10k-video
gallery ranked across a mesh).

Rank by counting, as on one device::

    rank_i = 1 + |{j : sims[i, j] > sims[i, pos_i]}|

with the work split over the mesh's ``data`` axis in one of two modes:

* ``query``: each rank counts its rows of the (padded) queries against the
  whole gallery, then the ranks are all-gathered;
* ``gallery``: each rank counts every query against its shard of the
  gallery, then the counts are all-reduced. In the dense branch the
  positive's score comes from the owning shard's own product, all-reduced
  with zeros from the others: a separately reduced dot could move the last
  ulps and flip a near tie.

Both give exactly the single-device ranks. The inputs are the global
embeddings on every rank, as the JAX package's are replicated; every rank
returns the same answer. Each rank counts with the ``rankcount`` kernel
(K4) when streaming, with a dense block otherwise; ``streaming`` is
decided on the full padded gallery, as the JAX package decides it.

The top-k functions run on either form of the mesh
(:mod:`cmhse_tpu_torch.parallel.mesh`): over the shards this process holds
(``mesh.local_shards()``: its own under a process group, every shard of a
local mesh), each shard's local top-k (the exact streaming scan, or the
int8 two stages on a per-shard
:class:`~cmhse_tpu_torch.ops.topk.PreparedGallery`) runs on the shard's
device, the query copied there; the indices are offset by ``shard *
shard_rows``, the k candidates of every shard are gathered (an all-gather,
or copies to ``devices[0]``), and the final top-k takes ties to the lowest
global index. A shard's work is enqueued under ``torch.cuda.device`` of
its card, and nothing in the shard loop waits on the device, so the cards
of a local mesh run their shards at once. The rank counts keep one card a
process and refuse a local mesh of several devices.
"""

from __future__ import annotations

import contextlib

import torch

from cmhse_tpu_torch.ops.rankcount_kernel import should_stream, violation_counts
from cmhse_tpu_torch.ops.ranking import bidirectional_metrics_from_ranks
from cmhse_tpu_torch.ops.topk import (PreparedGallery, _pad_rows,
                                      prepare_topk_gallery,
                                      quantized_sim_topk, should_stream_topk,
                                      streaming_sim_topk, topk_lowest_index)
from cmhse_tpu_torch.parallel.mesh import (Mesh, all_gather_rows,
                                           all_reduce_sum, gather_shards)


def _padded_valid_mask(npad: int, n: int, valid, device) -> torch.Tensor:
    """Rows past ``n`` are padding (never valid); caller validity folds
    in."""
    mask = torch.arange(npad, device=device) < n
    if valid is not None:
        mask = mask & _pad_rows(valid.to(device).bool(), npad - n)
    return mask


def _shard(mesh: Mesh, axis: str, npad: int) -> tuple[int, int]:
    """(first row, rows) of this rank's shard of ``npad`` rows."""
    mesh.check_axis(axis)
    rows = npad // mesh.data_size
    return mesh.data_index * rows, rows


def _on(dev: torch.device):
    """The context that makes ``dev`` the current card (allocations,
    streams and cuBLAS handles go to it); nothing for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def sharded_ranks(
    v_emb: torch.Tensor,
    p_emb: torch.Tensor,
    mesh: Mesh,
    axis: str = "data",
    mode: str = "query",
    valid: torch.Tensor | None = None,
    streaming: bool | None = None,
) -> torch.Tensor:
    """1-based int32 rank ``[N]`` of the aligned positive (row i of
    ``p_emb``) for every query row of ``v_emb``, the same on every rank and
    equal to the single-device ranks.

    ``mode``: "query" (shard the queries) or "gallery" (shard the gallery).
    ``valid``: bool ``[N]``; invalid rows never count as gallery items, and
    a NaN positive ranks at the valid gallery size. ``streaming``: count
    with the ``rankcount`` kernel inside each shard (None: by the padded
    gallery size on the card)."""
    if mode not in ("query", "gallery"):
        raise ValueError(f"unknown mode {mode!r}")
    mesh.check_process_mesh("sharded_ranks")
    dev = v_emb.device
    ndev = mesh.data_size
    n = v_emb.shape[0]
    npad = n + (-n) % ndev
    lo, rows = _shard(mesh, axis, npad)
    stream = should_stream(npad, dev, streaming)
    v_pad = _pad_rows(v_emb, npad - n)
    p_pad = _pad_rows(p_emb, npad - n)
    gallery_valid = _padded_valid_mask(npad, n, valid, dev)
    pos_idx = torch.arange(npad, dtype=torch.int32, device=dev)
    # the aligned positive's score, the row-wise dot in f32
    pos_score_full = torch.sum(v_pad.float() * p_pad.float(), dim=1)
    worst = (torch.tensor(n, dtype=torch.int32, device=dev) if valid is None
             else valid.to(dev).bool().sum().to(torch.int32))
    if stream:
        v_pad, p_pad = v_pad.float().contiguous(), p_pad.float().contiguous()

    if mode == "query":
        v_loc, pos_loc = v_pad[lo:lo + rows], pos_idx[lo:lo + rows]
        if stream:
            pos_score = pos_score_full[lo:lo + rows].contiguous()
            counts = violation_counts(v_loc, p_pad, pos_score,
                                      gallery_valid=gallery_valid,
                                      pos_idx=pos_loc)
        else:
            sims = v_loc.float() @ p_pad.float().T
            ps = torch.gather(sims, 1, pos_loc.long()[:, None])
            counts = ((sims > ps) & gallery_valid[None, :]).sum(
                dim=1, dtype=torch.int32)
            pos_score = ps[:, 0]
        ranks = torch.where(torch.isnan(pos_score), worst, counts + 1)
        ranks = all_gather_rows(ranks, mesh)
    else:
        p_loc, gv_loc = p_pad[lo:lo + rows], gallery_valid[lo:lo + rows]
        # the positive's index local to this shard (outside it when another
        # shard owns the positive)
        local_pos = pos_idx - lo
        if stream:
            pos_score = pos_score_full
            local_counts = violation_counts(v_pad, p_loc.contiguous(),
                                            pos_score, gallery_valid=gv_loc,
                                            pos_idx=local_pos)
        else:
            sims = v_pad.float() @ p_loc.float().T
            in_shard = (local_pos >= 0) & (local_pos < rows)
            safe = local_pos.clamp(0, rows - 1).long()
            pos_local = torch.gather(sims, 1, safe[:, None])[:, 0]
            pos_score = all_reduce_sum(
                torch.where(in_shard, pos_local, 0.0), mesh)
            local_counts = ((sims > pos_score[:, None]) & gv_loc[None, :]
                            ).sum(dim=1, dtype=torch.int32)
        counts = all_reduce_sum(local_counts, mesh)
        ranks = torch.where(torch.isnan(pos_score), worst, counts + 1)
    return ranks[:n]


def sharded_retrieval_metrics(
    v_emb: torch.Tensor,
    p_emb: torch.Tensor,
    mesh: Mesh,
    ks: tuple[int, ...] = (1, 5, 10, 50),
    axis: str = "data",
    mode: str = "query",
    valid: torch.Tensor | None = None,
    streaming: bool | None = None,
    return_ranks: bool = False,
) -> dict:
    """Bidirectional R@k / MedR / MeanR / rsum over a sharded gallery:
    :func:`~cmhse_tpu_torch.ops.ranking.bidirectional_metrics_from_ranks`
    with :func:`sharded_ranks` as its rank function. ``valid``: invalid
    rows are left out as queries and as gallery items."""

    def rank_fn(a, b):
        return sharded_ranks(a, b, mesh, axis=axis, mode=mode, valid=valid,
                             streaming=streaming)

    return bidirectional_metrics_from_ranks(
        rank_fn, v_emb, p_emb, ks=ks,
        valid=None if valid is None else valid.to(v_emb.device).bool(),
        return_ranks=return_ranks)


def _merge_shard_candidates(parts: list, mesh: Mesh, k: int):
    """Gather each shard's ``[Q, kk]`` candidates (``parts``: one
    ``(scores, global indices)`` pair a shard this process holds),
    shard-major along the candidates, and take the global top-k on
    ``mesh.devices[0]``, ties to the lowest index."""
    all_s = gather_shards([s.contiguous() for s, _ in parts], mesh)
    all_i = gather_shards([i.contiguous() for _, i in parts], mesh)
    q, kk = parts[0][0].shape
    all_s = all_s.reshape(-1, q, kk).permute(1, 0, 2).reshape(q, -1)
    all_i = all_i.reshape(-1, q, kk).permute(1, 0, 2).reshape(q, -1)
    return topk_lowest_index(all_s, k, index=all_i)


def sharded_sim_topk(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    valid: torch.Tensor | None = None,
    streaming: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery rows for each query against the gallery sharded over
    the mesh: each shard's top-k over its rows on its device (the streaming
    scan, or one dense block), gathered and merged. Returns (scores
    ``[Q, k]`` f32, global indices ``[Q, k]`` int64) on ``devices[0]``, the
    same on every rank. ``k``: the caller clamps it to the valid row count.
    ``streaming`` None: the serving rule on the padded gallery (its dense
    block's bytes)."""
    mesh.check_axis(axis)
    n = gallery.shape[0]
    npad = n + (-n) % mesh.data_size
    rows = npad // mesh.data_size
    stream = (should_stream_topk(queries.shape[0], npad) if streaming is None
              else streaming)
    g_pad = _pad_rows(gallery, npad - n)
    v_pad = _padded_valid_mask(npad, n, valid, gallery.device)
    kk = min(k, rows)
    parts = []
    for shard, dev in mesh.local_shards():
        lo = shard * rows
        with _on(dev):
            q = queries.to(dev)
            g_loc = g_pad[lo:lo + rows].to(dev)
            v_loc = v_pad[lo:lo + rows].to(dev)
            if stream:
                scores, idx = streaming_sim_topk(q, g_loc, kk, valid=v_loc)
            else:
                sims = q.float() @ g_loc.float().T
                sims = torch.where(v_loc[None, :], sims, float("-inf"))
                scores, idx = topk_lowest_index(sims, kk)
            parts.append((scores, idx + lo))
    return _merge_shard_candidates(parts, mesh, k)


def prepare_sharded_topk_gallery(
    gallery: torch.Tensor,
    mesh: Mesh,
    axis: str = "data",
    valid: torch.Tensor | None = None,
    quantize: bool = False,
) -> tuple[list[PreparedGallery], int]:
    """The shards this process holds of the gallery, each padded and
    equalize-chunked once on its own device (and int8-quantized with
    ``quantize``): ``(prepared, shard_rows)``, ``prepared[i]`` the shard of
    ``mesh.local_shards()[i]``. The JAX function returns every device's
    shard under a leading device axis; here a rank holds its own, and a
    local mesh every shard, which is what each serves from."""
    mesh.check_axis(axis)
    n = gallery.shape[0]
    npad = n + (-n) % mesh.data_size
    rows = npad // mesh.data_size
    g_pad = _pad_rows(gallery, npad - n)
    v_pad = _padded_valid_mask(npad, n, valid, gallery.device)
    prepared = []
    for shard, dev in mesh.local_shards():
        lo = shard * rows
        with _on(dev):
            prepared.append(prepare_topk_gallery(
                g_pad[lo:lo + rows].to(dev), v_pad[lo:lo + rows].to(dev),
                quantize=quantize))
    return prepared, rows


def sharded_sim_topk_prepared(
    queries: torch.Tensor,
    prepared: list[PreparedGallery],
    k: int,
    mesh: Mesh,
    shard_rows: int,
    axis: str = "data",
    quantized: bool = False,
    rescore_m: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k against the per-shard forms of
    :func:`prepare_sharded_topk_gallery`: the exact streaming scan, or with
    ``quantized`` the int8 two stages, on each shard's device; then the
    candidates' merge of :func:`sharded_sim_topk`. Padding rows are masked
    and cannot surface (the caller clamps ``k`` to the valid rows)."""
    mesh.check_axis(axis)
    shards = mesh.local_shards()
    if len(prepared) != len(shards):
        raise ValueError(f"{len(prepared)} prepared shards for the "
                         f"{len(shards)} this process holds")
    if quantized and any(p.int8_chunks is None for p in prepared):
        raise ValueError("quantized=True needs prepare_sharded_topk_"
                         "gallery(..., quantize=True)")
    capacity = prepared[0].chunks.shape[0] * prepared[0].chunks.shape[1]
    kk = min(k, capacity)
    parts = []
    for (shard, dev), prep in zip(shards, prepared):
        with _on(dev):
            q = queries.to(dev)
            if quantized:
                scores, idx = quantized_sim_topk(q, prep, kk,
                                                 rescore_m=rescore_m)
            else:
                scores, idx = streaming_sim_topk(q, prep, kk)
            parts.append((scores, idx + shard * shard_rows))
    return _merge_shard_candidates(parts, mesh, k)
