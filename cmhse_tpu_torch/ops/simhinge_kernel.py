"""Fused similarity + hardest-negative hinge loss: the hand-written CUDA
kernel ``csrc/simhinge.cu``, its plain PyTorch version, and the loss built on
them as a ``torch.autograd.Function``.

Replaces ``cmhse_tpu/ops/pallas_sim.py:_simhinge_row_kernel`` (run twice
by ``_simhinge_forward``), f32. One pass gives, for every query row ``i`` of
``A``, the hardest negative ``max_j margin + (A B^T)[i, j] - diag[i]`` over
the negatives mask and its earliest argmax; the loss runs it for (A, B, neg)
and (B, A, neg^T). The ``[B, B]`` similarity block never leaves the chip.

What bounds it on an H100: at the training shapes (64 and 512 rows,
D = 1024) the kernel's work is microseconds at the f32 peak, so launches and
a short grid dominate; the gradient (``_loss_bwd`` in JAX) is O(B * D)
gathers and a scatter-add, plain torch here as it is plain XLA there. See
the source for the full note.

Dispatch: a CPU tensor takes :func:`simhinge_rowpass_plain`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from cmhse_tpu_torch.ops import cuda_lib
from cmhse_tpu_torch.ops.loss import pair_masks

NEG_INF = -1e30  # a row with no negative: the JAX kernel's _NEG_INF


def simhinge_rowpass_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    neg: torch.Tensor,
    diag: torch.Tensor,
    margin: float,
    transposed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one pass: (row_max f32 ``[M]``, row_arg int32
    ``[M]``) of ``margin + (a @ b^T)[i, j] - diag[i]`` over the negatives
    ``neg[i, j]`` (``neg[j, i]`` when ``transposed``); the earliest index
    wins ties, and a row with no negative gets ``NEG_INF`` and index 0."""
    mask = neg.bool().T if transposed else neg.bool()
    sims = a.float() @ b.float().T
    logit = torch.where(mask, margin + sims - diag.float()[:, None], NEG_INF)
    row_max = torch.amax(logit, dim=1)
    cols = torch.arange(logit.shape[1], device=logit.device)
    row_arg = torch.where(logit == row_max[:, None], cols,
                          logit.shape[1]).amin(dim=1)
    return row_max, row_arg.to(torch.int32)


def simhinge_rowpass(
    a: torch.Tensor,
    b: torch.Tensor,
    neg: torch.Tensor,
    diag: torch.Tensor,
    margin: float,
    transposed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One direction of the fused loss: same contract as
    :func:`simhinge_rowpass_plain`.

    ``a`` ``[M, D]``, ``b`` ``[N, D]``, ``neg`` bool ``[M, N]`` (``[N, M]``
    when ``transposed``), ``diag`` ``[M]``. On the CPU it is the plain
    version. On a CUDA device it launches the ``simhinge`` kernel, which
    takes f32 contiguous ``a``/``b``/``diag`` and a contiguous bool mask;
    anything else raises. Each launch counts in ``cuda_lib.launches`` under
    ("simhinge", "float32", "rowpass").
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b must be [M, D] and [N, D], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, d = a.shape
    n = b.shape[0]
    want = (n, m) if transposed else (m, n)
    if tuple(neg.shape) != want:
        raise ValueError(f"neg must be {list(want)}, got {tuple(neg.shape)}")
    if tuple(diag.shape) != (m,):
        raise ValueError(f"diag must be [{m}], got {tuple(diag.shape)}")
    devices = {x.device for x in (a, b, neg, diag)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if a.device.type == "cpu":
        return simhinge_rowpass_plain(a, b, neg, diag, margin, transposed)
    if a.device.type != "cuda":
        raise ValueError(f"simhinge_rowpass runs on cpu or cuda, not "
                         f"{a.device.type}")
    for name, x in (("a", a), ("b", b), ("diag", diag)):
        if x.dtype != torch.float32:
            raise TypeError(f"the simhinge kernel takes float32 {name}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the simhinge kernel takes a contiguous {name}")
    if neg.dtype != torch.bool or not neg.is_contiguous():
        raise TypeError("the simhinge kernel takes a contiguous bool mask")
    row_max = torch.empty(m, dtype=torch.float32, device=a.device)
    row_arg = torch.zeros(m, dtype=torch.int32, device=a.device)
    if m == 0:
        return row_max, row_arg
    if n == 0:
        return row_max.fill_(NEG_INF), row_arg
    lib = cuda_lib.library()
    if d > lib.cmhse_simhinge_max_depth():
        raise ValueError(f"the simhinge kernel takes D up to "
                         f"{lib.cmhse_simhinge_max_depth()}, got {d}")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.cmhse_simhinge(
            a.data_ptr(), b.data_ptr(), neg.data_ptr(), diag.data_ptr(),
            row_max.data_ptr(), row_arg.data_ptr(), m, n, d, neg.shape[1],
            int(transposed), float(margin), stream)
    cuda_lib.check(err, "simhinge launch")
    cuda_lib.count_launch("simhinge", "float32", "rowpass")
    return row_max, row_arg


class FusedContrastiveLoss(torch.autograd.Function):
    """The max-violation loss of :func:`cmhse_tpu_torch.ops.loss.
    contrastive_loss` from two :func:`simhinge_rowpass` passes; the backward
    is ``_loss_bwd`` of the JAX package: gathers and a scatter-add by the
    saved argmaxes, O(B * D)."""

    @staticmethod
    def forward(ctx, emb_a, emb_b, neg_mask, valid, margin):
        a32 = emb_a.float().contiguous()
        b32 = emb_b.float().contiguous()
        neg = neg_mask.bool().contiguous()
        diag = torch.sum(a32 * b32, dim=1)
        row_max, row_arg = simhinge_rowpass(a32, b32, neg, diag, margin)
        col_max, col_arg = simhinge_rowpass(b32, a32, neg, diag, margin,
                                            transposed=True)
        valid = valid.bool()
        n_valid = torch.clamp(valid.float().sum(), min=1.0)
        loss = (torch.where(valid, torch.clamp(row_max, min=0.0), 0.0).sum()
                + torch.where(valid, torch.clamp(col_max, min=0.0), 0.0).sum()
                ) / n_valid
        ctx.save_for_backward(a32, b32, row_max, row_arg, col_max, col_arg,
                              valid, n_valid)
        ctx.dtypes = (emb_a.dtype, emb_b.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        a32, b32, row_max, row_arg, col_max, col_arg, valid, n_valid = (
            ctx.saved_tensors)
        w = (g / n_valid).float()
        act_r = (valid & (row_max > 0)).float()[:, None] * w
        act_c = (valid & (col_max > 0)).float()[:, None] * w
        row_arg, col_arg = row_arg.long(), col_arg.long()
        # dS: row term +1 at (i, row_arg[i]) and -1 at (i, i); column term
        # +1 at (col_arg[j], j) and -1 at (j, j). dA = dS B, dB = dS^T A.
        d_a = act_r * (b32.index_select(0, row_arg) - b32) - act_c * b32
        d_a.index_add_(0, col_arg, act_c * b32)
        d_b = act_c * (a32.index_select(0, col_arg) - a32) - act_r * a32
        d_b.index_add_(0, row_arg, act_r * a32)
        return (d_a.to(ctx.dtypes[0]), d_b.to(ctx.dtypes[1]), None, None,
                None)


def fused_contrastive_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                           neg_mask: torch.Tensor, valid: torch.Tensor,
                           margin: float = 0.2) -> torch.Tensor:
    """Bidirectional max-of-hinges loss with ``neg_mask = ~positive &
    valid_i & valid_j`` given; mean over valid queries, both directions
    summed (the JAX package's ``fused_contrastive_loss``)."""
    return FusedContrastiveLoss.apply(emb_a, emb_b, neg_mask, valid,
                                      float(margin))


def fused_contrastive_loss_from_masks(
    emb_a: torch.Tensor,
    emb_b: torch.Tensor,
    margin: float = 0.2,
    positive_mask: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Same arguments and value as ``contrastive_loss(...,
    max_violation=True)``: builds the negatives mask and runs the fused
    loss (the JAX package's ``pallas_contrastive_loss``)."""
    valid, neg_mask = pair_masks(emb_a.shape[0], positive_mask, valid,
                                 emb_a.device)
    return fused_contrastive_loss(emb_a, emb_b, neg_mask, valid, margin)
