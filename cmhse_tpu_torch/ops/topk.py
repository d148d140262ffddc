"""Streaming large-gallery top-k and the int8 two-stage top-k, counterpart
of ``cmhse_tpu/ops/topk.py``.

The gallery is scanned in equalized chunks: per chunk one ``[Q, chunk]``
product and a local top-k, then one merge over the ``[Q, n_chunks * k']``
candidates. Peak similarity memory is ``[Q, chunk]`` whatever N is. A
chunk's local top-k is the grouped pre-select where it shrinks the
selection (the max of each 128-column group, the top groups, then the
top-k of their columns), else a top-k over the whole chunk; both return
the same columns in the same order. :func:`quantized_sim_topk` scans
per-row symmetric int8 copies of the rows instead, keeps a candidate pool
a chunk, and rescores the pool exactly in f32.

These are plain PyTorch ops, as the JAX package leaves them to XLA (no
Pallas kernel): the int8 product is ``torch._int_mm`` (int8 in, int32
out, on the CPU and on the card alike), so its sums equal the JAX
package's int32 ``einsum`` exactly, and so do the pool and the indices.

Two rules of the JAX module have no counterpart here: its TPU-only bf16
conversion of the chunks (``convert``, ``_round_to_bf16_bits``) — the
chunks stay in the gallery's dtype, as on the JAX package's CPU path —
and its rolled-versus-unrolled scan (``_MAX_UNROLL``), a matter of XLA's
compile; the chunks here are a Python loop.

Ties: the JAX package resolves equal scores to the lowest gallery index
(``lax.top_k`` is stable). ``torch.topk`` promises no order among ties, so
every top-k here goes through :func:`topk_lowest_index`, which ranks by one
int64 key per score: the order-preserving int32 image of the f32 score in
the high half, ``N - 1 - index`` in the low half.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cmhse_tpu_torch.ops.rankcount_kernel import STREAMING_GALLERY_MIN

# adaptive chunking (chunk=None): equalize the gallery into
# max(TOPK_NCHUNKS, ceil(N / TOPK_CHUNK_CAP)) chunks of a multiple of
# _GROUP rows; the same arithmetic as the JAX package, so both packages cut
# a gallery into the same chunks
TOPK_NCHUNKS = 4
TOPK_CHUNK_CAP = 262144
# pre-select group width: columns reduced to one max before the top-k
_GROUP = 128
# the largest f32 [Q, N] block the dense serving top-k materializes; its
# tie-ordered top-k holds int64 keys of the same shape beside it, so its
# peak memory is ~7x the block, the streaming top-k's a quarter of that
DENSE_TOPK_MAX_BYTES = 1 << 30
# cuBLASLt's int8 product wants more than 16 rows and K, N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """int64 image of f32 scores that orders like the floats (-inf lowest)."""
    bits = scores.float().contiguous().view(torch.int32).long()
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def topk_lowest_index(scores: torch.Tensor, k: int,
                      index: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim of ``[Q, M]`` scores, descending, equal
    scores resolved to the lowest index: the order of the JAX package's
    stable ``lax.top_k``.

    ``index``: optional int64 ``[Q, M]`` global index of each column (the
    candidates of a chunked scan); default ``arange(M)``. Indices must lie in
    ``[0, 2**31)``. Returns (scores ``[Q, k]`` f32, indices ``[Q, k]``
    int64)."""
    m = scores.shape[-1]
    if index is None:
        index = torch.arange(m, device=scores.device).expand_as(scores)
    key = _order_key(scores) * 2**32 + ((2**31 - 1) - index)
    _, pos = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    return (torch.gather(scores.float(), -1, pos),
            torch.gather(index, -1, pos))


class PreparedGallery(NamedTuple):
    """Gallery pre-chunked for :func:`streaming_sim_topk`: encode once,
    prepare once, answer queries forever. Slot ``s < n`` of the flattened
    chunks is gallery row ``s``; padding sits only at the tail."""

    chunks: torch.Tensor  # [n_chunks, chunk, D]
    valid: torch.Tensor   # bool [n_chunks, chunk]
    # present only when prepared with quantize=True (the int8 serving path,
    # :func:`quantized_sim_topk`): per-row symmetric int8 values + scales
    int8_chunks: torch.Tensor | None = None  # [n_chunks, chunk, D] int8
    int8_scale: torch.Tensor | None = None   # [n_chunks, chunk] f32


def adaptive_n_chunks(n: int) -> int:
    """The chunk count :func:`prepare_topk_gallery` picks for ``n`` rows."""
    n_chunks = max(TOPK_NCHUNKS, _cdiv(n, TOPK_CHUNK_CAP))
    return min(n_chunks, max(1, _cdiv(n, _GROUP)))


def _quantize_rows_int8(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: ``(values int8, scale f32
    [rows])`` with ``x ~= values * scale[:, None]``; an all-zero row gets
    scale 1. Divisions and round-half-to-even, as the JAX package computes
    them, so both give the same bits. The 127 is a tensor on ``x``'s
    device: on CUDA, PyTorch divides by a Python number as a multiply by
    its reciprocal, an ulp off the quotient."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` zero (False) rows appended along dim 0."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def prepare_topk_gallery(gallery: torch.Tensor,
                         valid: torch.Tensor | None = None,
                         chunk: int | None = None,
                         quantize: bool = False) -> PreparedGallery:
    """Pad and equalize-chunk a gallery once. ``chunk=None`` picks the
    adaptive chunk count; an int sets the count to ``ceil(n / chunk)``. Rows
    per chunk are the equalized ``ceil(n / n_chunks)`` rounded up to
    ``_GROUP`` (one group at least, so an empty gallery still gives an
    appendable form). ``quantize`` adds the int8 rows and scales, quantized
    from the gallery's own values."""
    n, d = gallery.shape
    if chunk is None:
        n_chunks = adaptive_n_chunks(n)
    else:
        n_chunks = max(1, _cdiv(n, max(chunk, 1)))
    csize = max(_GROUP, _cdiv(_cdiv(n, n_chunks), _GROUP) * _GROUP)
    pad = n_chunks * csize - n
    g = _pad_rows(gallery, pad)
    gvalid = torch.arange(n + pad, device=gallery.device) < n
    if valid is not None:
        gvalid = gvalid & _pad_rows(valid.bool(), pad)
    int8_chunks = int8_scale = None
    if quantize:
        qv, qs = _quantize_rows_int8(g)
        int8_chunks = qv.reshape(n_chunks, csize, d)
        int8_scale = qs.reshape(n_chunks, csize)
    return PreparedGallery(chunks=g.reshape(n_chunks, csize, d),
                           valid=gvalid.reshape(n_chunks, csize),
                           int8_chunks=int8_chunks, int8_scale=int8_scale)


def append_to_prepared(pg: PreparedGallery, new_rows: torch.Tensor,
                       n_existing: int,
                       valid: torch.Tensor | None = None) -> PreparedGallery:
    """Append rows to a :class:`PreparedGallery` without reprocessing it:
    only the last partly filled chunk and the new rows are rebuilt (and
    quantized, for an int8 form); the full chunks are copied as they are.
    Existing rows keep their indices, the new ones take ``n_existing ...
    n_existing + m - 1``: a fresh prepare of the concatenation, cut into
    chunks of the same (fixed) size. The chunk count grows as needed; the
    new rows are stored in the form's dtype.

    ``n_existing``: rows the form holds before its tail padding (the caller
    tracks it; the form cannot tell tail padding from invalid rows).
    ``valid``: optional bool ``[m]`` of the new rows. Returns a new form;
    ``pg``'s tensors are not modified."""
    n_chunks, csize, d = pg.chunks.shape
    if new_rows.shape[-1] != d:
        raise ValueError(f"new rows have D={new_rows.shape[-1]}, "
                         f"prepared gallery has D={d}")
    if not 0 <= n_existing <= n_chunks * csize:
        raise ValueError(f"n_existing={n_existing} outside the prepared "
                         f"capacity [0, {n_chunks * csize}]")
    m = new_rows.shape[0]
    if m == 0:
        return pg
    dev = pg.chunks.device
    new_valid = (torch.ones(m, dtype=torch.bool, device=dev) if valid is None
                 else valid.to(dev).bool())
    head = n_existing // csize  # full chunks, copied as they are
    tail_rows = n_existing - head * csize
    region_chunks = max(1, _cdiv(tail_rows + m, csize))
    pad = region_chunks * csize - (tail_rows + m)

    def extend(old, new, shape):
        tail = old[head:].reshape(-1, *shape)[:tail_rows]
        region = torch.cat([tail, new, new.new_zeros((pad, *shape))])
        return torch.cat([old[:head],
                          region.reshape(region_chunks, csize, *shape)])

    chunks = extend(pg.chunks, new_rows.to(dev, pg.chunks.dtype), (d,))
    gvalid = extend(pg.valid, new_valid, ())
    int8_chunks = int8_scale = None
    if pg.int8_chunks is not None:
        # per-row quantization composes: only the new rows are quantized,
        # from their own values, as prepare_topk_gallery does
        new_q, new_s = _quantize_rows_int8(new_rows.to(dev))
        int8_chunks = extend(pg.int8_chunks, new_q, (d,))
        int8_scale = extend(pg.int8_scale, new_s, ())
    return PreparedGallery(chunks=chunks, valid=gvalid,
                           int8_chunks=int8_chunks, int8_scale=int8_scale)


def should_prepare_topk(n_gallery: int) -> bool:
    """The JAX package's size rule (its ``should_stream_topk(n)``): a
    gallery of at least ``STREAMING_GALLERY_MIN`` rows is held prepared by
    the Retriever (chunked, and int8 when it quantizes). So the int8 path
    engages, and an add appends to a prepared form, at the same sizes as in
    the JAX package."""
    return n_gallery >= STREAMING_GALLERY_MIN


def should_stream_topk(n_queries: int, n_gallery: int) -> bool:
    """Serving top-k streams once a request's dense f32 ``[Q, N]`` block
    would pass :data:`DENSE_TOPK_MAX_BYTES`. A memory rule: on an H100 the
    dense path is as fast or faster at every size chip_smoke.py phase 3b
    times, so only its peak memory argues for streaming."""
    return 4 * n_queries * n_gallery > DENSE_TOPK_MAX_BYTES


def dense_sim_topk(queries: torch.Tensor, gallery: torch.Tensor,
                   valid: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Small-gallery top-k: one product, the padding mask, one top-k."""
    sims = queries.float() @ gallery.float().T
    sims = torch.where(valid.bool()[None, :], sims, float("-inf"))
    return topk_lowest_index(sims, k)


def _grouped_preselect(sims: torch.Tensor, kk: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``kk`` of ``sims [Q, ngroups, _GROUP]`` (already -inf-masked),
    tie order included, without a top-k over every column: reduce each group
    to its max, take the top-``kk`` groups (ties to the lowest group), put
    the chosen group ids back in ascending order, then take the top-``kk``
    of their ``kk * _GROUP`` columns. An element of the true top-``kk`` lies
    in a chosen group: were its group left out, ``kk`` groups would beat it
    on (max, group id), each holding an element that beats it.

    Returns ``(scores [Q, kk], columns [Q, kk])``, columns local to the
    block."""
    q = sims.shape[0]
    _, gsel = topk_lowest_index(sims.amax(dim=2), kk)
    gsel, _ = torch.sort(gsel, dim=1)
    cand = torch.gather(sims, 1, gsel[:, :, None].expand(-1, -1, _GROUP))
    cols = (gsel[:, :, None] * _GROUP
            + torch.arange(_GROUP, device=sims.device))
    return topk_lowest_index(cand.reshape(q, kk * _GROUP), kk,
                             index=cols.reshape(q, kk * _GROUP))


def _chunk_topk(sims: torch.Tensor, kk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """A chunk's local top-``kk`` of ``sims [Q, chunk]``: the grouped
    pre-select where the chunk is whole groups and they outnumber ``kk``
    twice (the JAX package's rule), else a top-k over the chunk."""
    csize = sims.shape[1]
    ngroups = csize // _GROUP
    if ngroups * _GROUP == csize and ngroups >= 2 * kk:
        return _grouped_preselect(
            sims.reshape(sims.shape[0], ngroups, _GROUP), kk)
    return topk_lowest_index(sims, kk)


def streaming_sim_topk(
    queries: torch.Tensor,
    gallery: torch.Tensor | PreparedGallery,
    k: int,
    valid: torch.Tensor | None = None,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery scores and indices for each query, streaming the
    gallery in chunks.

    ``gallery``: ``[N, D]`` embeddings, or a :class:`PreparedGallery` (then
    its own mask holds and ``valid`` must be None). ``k``: the caller clamps
    it to the valid row count. Returns (scores ``[Q, k]`` f32 descending,
    indices ``[Q, k]`` int64), equal to a dense masked top-k including tie
    order."""
    if isinstance(gallery, PreparedGallery):
        if valid is not None:
            raise ValueError(
                "streaming_sim_topk(PreparedGallery, valid=...) is invalid: "
                "validity lives in the prepared form")
        prep = gallery
        if k > prep.chunks.shape[0] * prep.chunks.shape[1]:
            raise ValueError(f"k={k} exceeds prepared gallery capacity")
    else:
        if k > gallery.shape[0]:
            raise ValueError(f"k={k} exceeds gallery size {gallery.shape[0]}")
        prep = prepare_topk_gallery(gallery, valid, chunk)
    n_chunks, csize, _ = prep.chunks.shape
    kk = min(k, csize)
    q = queries.float()
    cand_s, cand_i = [], []
    for ci in range(n_chunks):
        sims = q @ prep.chunks[ci].float().T  # [Q, chunk], the only block
        sims = torch.where(prep.valid[ci][None, :], sims, float("-inf"))
        s, i = _chunk_topk(sims, kk)
        cand_s.append(s)
        cand_i.append(i + ci * csize)
    cat_s, cat_i = torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1)
    if n_chunks == 1 and kk == k:
        return cat_s, cat_i
    return topk_lowest_index(cat_s, k, index=cat_i)


def int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of int8 ``[M, D]`` and ``[N, D]`` as int32 ``[M, N]``,
    exact (``torch._int_mm``). On the card, cuBLASLt's int8 product wants
    more than 16 rows and K, N multiples of 8: rows and D are zero-padded
    to that (zeros add nothing), and the result is cut back."""
    m, d = a.shape
    n = b.shape[0]
    if a.device.type == "cuda":
        dpad = -d % _INT_MM_ALIGN
        if dpad:
            a, b = F.pad(a, (0, dpad)), F.pad(b, (0, dpad))
        a = _pad_rows(a, max(0, _INT_MM_MIN_ROWS - m))
        b = _pad_rows(b, -n % _INT_MM_ALIGN)
    return torch._int_mm(a.contiguous(), b.T)[:m, :n]


def quantized_sim_topk(queries: torch.Tensor, prepared: PreparedGallery,
                       k: int, rescore_m: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage int8 top-k: an int8 pre-select, then an exact rescore.

    Stage 1 scans the int8 rows (the query quantized the same way; its
    scale is a positive factor a row, so it ranks nothing) and keeps each
    chunk's top ``kk = min(max(k, ceil(m / n_chunks)), chunk)`` candidates,
    ``m = min(max(64, 4k) if rescore_m is None else rescore_m, capacity)``:
    a depth a chunk, never below k, since all k true tops may share one
    chunk. Stage 2 rescores the whole pool against the gallery's own rows
    in f32, the pool sorted by ascending index first, and takes the top-k
    with the lowest index first among ties. The indices differ from
    :func:`streaming_sim_topk`'s only where a true top-k row missed the
    pool, or two rows' exact scores lie within f32 summation noise: an
    opt-in approximate mode.

    ``prepared``: from ``prepare_topk_gallery(..., quantize=True)``.
    Returns (scores ``[Q, k]`` f32 descending, indices ``[Q, k]`` int64)."""
    if prepared.int8_chunks is None:
        raise ValueError(
            "gallery was not prepared with quantize=True; call "
            "prepare_topk_gallery(gallery, valid, quantize=True)")
    g8, s8, vc = prepared.int8_chunks, prepared.int8_scale, prepared.valid
    n_chunks, csize, d = g8.shape
    capacity = n_chunks * csize
    if k > capacity:
        raise ValueError(f"k={k} exceeds prepared gallery capacity")
    m = min(max(64, 4 * k) if rescore_m is None else rescore_m, capacity)
    if m < k:
        raise ValueError(f"rescore_m={m} must be >= k={k}")
    kk = min(max(k, _cdiv(m, n_chunks)), csize)
    qi, _ = _quantize_rows_int8(queries)
    cand = []
    for ci in range(n_chunks):
        sims = int8_product(qi, g8[ci]).float() * s8[ci][None, :]
        sims = torch.where(vc[ci][None, :], sims, float("-inf"))
        _, i = _chunk_topk(sims, kk)
        cand.append(i + ci * csize)
    idx_m, _ = torch.sort(torch.cat(cand, dim=1), dim=1)
    rows = prepared.chunks.reshape(capacity, d)[idx_m]  # [Q, pool, D]
    # an elementwise product and sum in f32: no TF32, whatever the
    # matmul setting; equal to the exact path's product up to the order
    # of the f32 sum
    rescored = (rows.float() * queries.float()[:, None, :]).sum(-1)
    rescored = torch.where(vc.reshape(capacity)[idx_m], rescored,
                           float("-inf"))
    return topk_lowest_index(rescored, k, index=idx_m)
