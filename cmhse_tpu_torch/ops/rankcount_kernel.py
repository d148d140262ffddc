"""Streaming rank count: the hand-written CUDA kernel ``csrc/rankcount.cu``
and its plain PyTorch version.

Replaces ``cmhse_tpu/ops/pallas_sim.py:_rankcount_kernel`` (launched by
``pallas_violation_counts`` <- ``pallas_rank_counts``), both branches: f32,
and ``lowp`` (``precision="bfloat16"``: both operands rounded to bf16, f32
accumulation). For each query it counts the valid gallery rows scoring
strictly above the query's positive, without materializing the ``[Q, N]``
similarity block.

What bounds it on an H100: the ``2*Q*N*D`` operations (3.1 ms in f32 FFMA,
0.21 ms on the bf16 tensor cores at Q=1024, N=100k, D=1024), not bytes:
both branches walk (gallery tile, query tile) gallery-major, so a gallery
tile comes from HBM once and from L2 for the other query tiles. The f32
branch is a register-blocked FFMA product (f32-exact, so no tensor core);
the ``lowp`` branch is a persistent TMA + ``wgmma`` kernel on bf16
operands (a TMA producer warp feeding a 4-stage shared-memory ring, two
consumer warpgroups). Both compare, mask and count straight from the
scores in registers, one integer atomic per query per tile or block, so
the result is deterministic; PERF.md has their times against the bound.
See the source for the full note.

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
    ``rankcount`` kernel's branch for ``precision``; both take contiguous
    operands and an f32 ``pos_score``. ``"float32"`` takes f32
    ``queries`` / ``gallery`` with D a multiple of 4. ``"bfloat16"`` takes
    f32 or bf16 ones, any D: f32 operands are rounded to bf16 here (nearest
    even, as the TPU's ``astype``; the cast is part of the call's time), and
    D is padded with zero columns to a multiple of 8 where it is not one
    (exact); bf16 operands with D a multiple of 8 are read in place.
    Anything else raises. Each launch counts in ``cuda_lib.launches`` under
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
    lowp = precision == "bfloat16"
    takes = (torch.float32, torch.bfloat16) if lowp else (torch.float32,)
    for name, x in (("queries", queries), ("gallery", gallery)):
        if x.dtype not in takes:
            raise TypeError(f"the rankcount kernel ({precision}) takes "
                            f"{name} of a type in {takes}, got {x.dtype}")
    if pos_score.dtype != torch.float32:
        raise TypeError(f"the rankcount kernel takes float32 pos_score, got "
                        f"{pos_score.dtype}")
    for name, x in (("queries", queries), ("gallery", gallery),
                    ("pos_score", pos_score)):
        if not x.is_contiguous():
            raise ValueError(f"the rankcount kernel takes a contiguous {name}")
    q, d = queries.shape
    n = gallery.shape[0]
    if not lowp and d % 4:
        raise ValueError(f"the rankcount kernel takes D a multiple of 4, "
                         f"got {d}")
    counts = torch.zeros(q, dtype=torch.int32, device=queries.device)
    if q == 0 or n == 0:
        return counts
    if lowp:
        queries, gallery = _bf16_operand(queries), _bf16_operand(gallery)
    else:
        # 16-byte loads: an offset view gets an aligned copy
        queries, gallery = [x if x.data_ptr() % 16 == 0 else x.clone()
                            for x in (queries, gallery)]
    # the kernel reads these two as int32 / uint8: convert (small, [Q]/[N])
    posidx = None if pos_idx is None else pos_idx.to(torch.int32).contiguous()
    gvalid = (None if gallery_valid is None
              else gallery_valid.to(torch.uint8).contiguous())
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    with torch.cuda.device(queries.device):
        err = lib.cmhse_rankcount(
            queries.data_ptr(), gallery.data_ptr(), pos_score.data_ptr(),
            None if posidx is None else posidx.data_ptr(),
            None if gvalid is None else gvalid.data_ptr(),
            counts.data_ptr(), q, n, queries.shape[1], int(lowp), stream)
    cuda_lib.check(err, "rankcount launch")
    cuda_lib.count_launch("rankcount", precision, "lowp" if lowp else "f32")
    return counts


def _bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the lowp kernel reads it: bf16 (f32 rounded to nearest
    even), rows of a multiple of 8 values (zero columns appended, which
    changes no product), 16-byte aligned (TMA's rule)."""
    d = x.shape[1]
    dp = -(-d // 8) * 8
    if dp == d:
        if x.dtype != torch.bfloat16:
            return x.to(torch.bfloat16)
        return x if x.data_ptr() % 16 == 0 else x.clone()
    out = torch.zeros(x.shape[0], dp, dtype=torch.bfloat16, device=x.device)
    out[:, :d] = x
    return out


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
