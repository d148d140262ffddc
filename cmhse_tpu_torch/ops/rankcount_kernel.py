"""Streaming rank count: the hand-written CUDA kernel ``csrc/rankcount.cu``
and its plain PyTorch version.

Replaces ``cmhse_tpu/ops/pallas_sim.py:_rankcount_kernel`` (launched by
``pallas_violation_counts`` <- ``pallas_rank_counts``), both branches: f32,
and ``lowp`` (``precision="bfloat16"``: both operands rounded to bf16, f32
accumulation). For each query it counts the valid gallery rows scoring
strictly above the query's positive, without materializing the ``[Q, N]``
similarity block.

What bounds it on an H100: the ``2*Q*N*D`` f32 FLOPs (compute, not bytes:
the gallery is re-read once per 128-query tile, mostly from L2). The
kernel keeps every score in registers (8 x 8 per thread, 128 x 128 per
block) and reduces counts in shared memory, one integer atomic per query
per block, so the result is deterministic; PERF.md has its times against
the bound. See the source for the full note.

Dispatch: a CPU tensor takes :func:`violation_counts_plain`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.ops import cuda_lib

PRECISIONS = ("float32", "bfloat16")

# Galleries of at least this many rows take the streaming count on the card
# (the JAX package's crossover, kept so that the two packages choose the
# same path for the same gallery). Below it the dense [N, N] block is small.
STREAMING_GALLERY_MIN = 32_768

# rows of the [chunk, N] block the plain version materializes at a time
_PLAIN_CHUNK = 1024


def should_stream(n_gallery: int, device: torch.device,
                  force: bool | None = None) -> bool:
    """Dispatch policy for rank counting: an explicit ``force`` wins;
    otherwise stream on a CUDA device for galleries of at least
    :data:`STREAMING_GALLERY_MIN` rows."""
    if force is not None:
        return force
    return (torch.device(device).type == "cuda"
            and n_gallery >= STREAMING_GALLERY_MIN)


def _prepare(queries, gallery, pos_score, gallery_valid, pos_idx,
             precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    q, d = queries.shape
    n = gallery.shape[0]
    if gallery.dim() != 2 or gallery.shape[1] != d:
        raise ValueError(f"gallery must be [N, {d}], got "
                         f"{tuple(gallery.shape)}")
    if tuple(pos_score.shape) != (q,):
        raise ValueError(f"pos_score must be [{q}], got "
                         f"{tuple(pos_score.shape)}")
    if gallery_valid is not None and tuple(gallery_valid.shape) != (n,):
        raise ValueError(f"gallery_valid must be [{n}], got "
                         f"{tuple(gallery_valid.shape)}")
    if pos_idx is not None and tuple(pos_idx.shape) != (q,):
        raise ValueError(f"pos_idx must be [{q}], got {tuple(pos_idx.shape)}")
    tensors = [queries, gallery, pos_score]
    tensors += [x for x in (gallery_valid, pos_idx) if x is not None]
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")


def violation_counts_plain(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    pos_score: torch.Tensor,
    gallery_valid: torch.Tensor | None = None,
    pos_idx: torch.Tensor | None = None,
    precision: str = "float32",
) -> torch.Tensor:
    """Plain version: a chunked ``q @ g^T`` with the kernel's masks; with
    ``precision="bfloat16"`` both operands are rounded to bf16 first (f32
    products of them are exact). Returns int32 ``[Q]`` counts."""
    q = queries.shape[0]
    n = gallery.shape[0]
    dt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    g = gallery.to(dt).float()
    cols = torch.arange(n, device=gallery.device)
    counts = []
    for s in range(0, q, _PLAIN_CHUNK):
        sims = queries[s : s + _PLAIN_CHUNK].to(dt).float() @ g.T
        gt = sims > pos_score[s : s + _PLAIN_CHUNK].float()[:, None]
        if gallery_valid is not None:
            gt &= gallery_valid.bool()[None, :]
        if pos_idx is not None:
            gt &= cols[None, :] != pos_idx[s : s + _PLAIN_CHUNK].long()[:, None]
        counts.append(gt.sum(dim=1, dtype=torch.int32))
    if not counts:
        return torch.zeros(0, dtype=torch.int32, device=queries.device)
    return torch.cat(counts)


def violation_counts(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    pos_score: torch.Tensor,
    gallery_valid: torch.Tensor | None = None,
    pos_idx: torch.Tensor | None = None,
    precision: str = "float32",
) -> torch.Tensor:
    """Strictly-greater counts ``[Q]`` int32: how many valid gallery rows
    score above each query's positive. Same contract as the JAX package's
    ``pallas_violation_counts``.

    Args:
      queries: ``[Q, D]``; gallery: ``[N, D]``.
      pos_score: ``[Q]`` each query's similarity to its positive.
      gallery_valid: optional bool ``[N]``; False rows never count.
      pos_idx: optional int ``[Q]`` gallery index of each query's positive,
        excluded by index (None = no exclusion).
      precision: ``"float32"`` (exact; the default) or ``"bfloat16"``
        (bf16 multiplies, f32 accumulation: the TPU's default matmul
        precision, so near-tie counts may differ from the f32 ones).

    On the CPU it is the plain version. On a CUDA device it launches the
    ``rankcount`` kernel's branch for ``precision``, which takes f32
    contiguous inputs (the lowp branch rounds them itself); anything else
    raises. Each launch counts in ``cuda_lib.launches`` under
    ("rankcount", precision, "f32" or "lowp").
    """
    if queries.dim() != 2:
        raise ValueError(f"queries must be [Q, D], got "
                         f"{tuple(queries.shape)}")
    _prepare(queries, gallery, pos_score, gallery_valid, pos_idx, precision)
    if queries.device.type == "cpu":
        return violation_counts_plain(queries, gallery, pos_score,
                                      gallery_valid, pos_idx, precision)
    if queries.device.type != "cuda":
        raise ValueError(f"violation_counts runs on cpu or cuda, not "
                         f"{queries.device.type}")
    for name, x in (("queries", queries), ("gallery", gallery),
                    ("pos_score", pos_score)):
        if x.dtype != torch.float32:
            raise TypeError(f"the rankcount kernel takes float32 {name}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the rankcount kernel takes a contiguous {name}")
    q, d = queries.shape
    n = gallery.shape[0]
    if d % 4:
        raise ValueError(f"the rankcount kernel takes D a multiple of 4, "
                         f"got {d}")
    # 16-byte loads: an offset view gets an aligned copy
    queries, gallery = [x if x.data_ptr() % 16 == 0 else x.clone()
                        for x in (queries, gallery)]
    counts = torch.zeros(q, dtype=torch.int32, device=queries.device)
    if q == 0 or n == 0:
        return counts
    # the kernel reads these two as int32 / uint8: convert (small, [Q]/[N])
    posidx = None if pos_idx is None else pos_idx.to(torch.int32).contiguous()
    gvalid = (None if gallery_valid is None
              else gallery_valid.to(torch.uint8).contiguous())
    lib = cuda_lib.library()
    q_tiles = -(-q // lib.cmhse_rankcount_tile_queries())
    n_tiles = -(-n // lib.cmhse_rankcount_tile_rows())
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    # ~2 resident blocks per SM; each split walks n_tiles/splits tiles
    splits = max(1, min(n_tiles, -(-2 * sms // q_tiles), 65535))
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    with torch.cuda.device(queries.device):
        err = lib.cmhse_rankcount(
            queries.data_ptr(), gallery.data_ptr(), pos_score.data_ptr(),
            None if posidx is None else posidx.data_ptr(),
            None if gvalid is None else gvalid.data_ptr(),
            counts.data_ptr(), q, n, d, splits, int(precision == "bfloat16"),
            stream)
    cuda_lib.check(err, "rankcount launch")
    cuda_lib.count_launch("rankcount", precision,
                          "lowp" if precision == "bfloat16" else "f32")
    return counts


def rank_counts(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    pos_score: torch.Tensor,
    gallery_valid: torch.Tensor | None = None,
    pos_idx: torch.Tensor | None = None,
    precision: str = "float32",
) -> torch.Tensor:
    """1-based rank of each query's positive via :func:`violation_counts`;
    a NaN positive ranks worst: the valid gallery size when a mask is given
    (the dense path drops invalid rows before ranking), else N."""
    ranks = violation_counts(queries, gallery, pos_score, gallery_valid,
                             pos_idx, precision) + 1
    n = gallery.shape[0]
    worst = (torch.tensor(n, dtype=torch.int32, device=ranks.device)
             if gallery_valid is None
             else gallery_valid.bool().sum().to(torch.int32))
    return torch.where(torch.isnan(pos_score), worst, ranks)
