"""Fused similarity + hardest-negative hinge loss: the hand-written CUDA
kernel ``csrc/simhinge.cu``, its plain PyTorch version, and the loss built on
them as a ``torch.autograd.Function``.

Replaces ``cmhse_tpu/ops/pallas_sim.py:_simhinge_row_kernel``, f32, which
``_simhinge_forward`` runs twice, once per direction. The port makes one
launch for both: for every row ``i`` of ``A`` the hardest negative
``max_j margin + (A B^T)[i, j] - diag[i]`` over the negatives mask and its
earliest argmax, and for every column ``j`` the same over ``i`` with
``diag[j]`` (the JAX package's second pass, (B, A, neg^T), is the column
view of the same product). The ``[B, B]`` similarity block never leaves the
chip.

What bounds it on an H100: at the training shapes (64 and 512 rows,
D = 1024) the kernel's work is microseconds at the f32 peak; a 2-D grid of
32 x 32 tiles fills the card at 512 rows and the launch dominates at 64.
The gradient (``_loss_bwd`` in JAX) is O(B * D) gathers and a scatter-add,
plain torch here as it is plain XLA there. See the source for the full
note.

Dispatch: a CPU tensor takes :func:`simhinge_pair_plain`; a CUDA tensor
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


def simhinge_pair_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    neg: torch.Tensor,
    row_diag: torch.Tensor,
    col_diag: torch.Tensor,
    margin: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of both directions: ``(row_max, row_arg, col_max,
    col_arg)``, two :func:`simhinge_rowpass_plain` passes, (a, b, neg) and
    (b, a, neg^T), as the JAX package's ``_simhinge_forward`` runs them."""
    row_max, row_arg = simhinge_rowpass_plain(a, b, neg, row_diag, margin)
    col_max, col_arg = simhinge_rowpass_plain(b, a, neg, col_diag, margin,
                                              transposed=True)
    return row_max, row_arg, col_max, col_arg


def simhinge_pair(
    a: torch.Tensor,
    b: torch.Tensor,
    neg: torch.Tensor,
    row_diag: torch.Tensor,
    col_diag: torch.Tensor,
    margin: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both directions of the fused loss: same contract as
    :func:`simhinge_pair_plain`.

    ``a`` ``[M, D]``, ``b`` ``[N, D]``, ``neg`` bool ``[M, N]``,
    ``row_diag`` ``[M]`` (subtracted in the row direction), ``col_diag``
    ``[N]`` (in the column direction). On the CPU it is the plain version.
    On a CUDA device it launches the ``simhinge`` kernel once for both
    directions; it takes f32 contiguous ``a``/``b``/diagonals and a
    contiguous bool mask, and anything else raises. A depth that is not a
    multiple of 4 is padded with zeros (the products do not change). Each
    launch counts in ``cuda_lib.launches`` under ("simhinge", "float32",
    "pair").
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b must be [M, D] and [N, D], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, d = a.shape
    n = b.shape[0]
    if tuple(neg.shape) != (m, n):
        raise ValueError(f"neg must be {[m, n]}, got {tuple(neg.shape)}")
    for name, x, size in (("row_diag", row_diag, m), ("col_diag", col_diag,
                                                      n)):
        if tuple(x.shape) != (size,):
            raise ValueError(f"{name} must be [{size}], got "
                             f"{tuple(x.shape)}")
    devices = {x.device for x in (a, b, neg, row_diag, col_diag)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if a.device.type == "cpu":
        return simhinge_pair_plain(a, b, neg, row_diag, col_diag, margin)
    if a.device.type != "cuda":
        raise ValueError(f"simhinge_pair runs on cpu or cuda, not "
                         f"{a.device.type}")
    for name, x in (("a", a), ("b", b), ("row_diag", row_diag),
                    ("col_diag", col_diag)):
        if x.dtype != torch.float32:
            raise TypeError(f"the simhinge kernel takes float32 {name}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the simhinge kernel takes a contiguous {name}")
    if neg.dtype != torch.bool or not neg.is_contiguous():
        raise TypeError("the simhinge kernel takes a contiguous bool mask")
    dev = a.device
    if m == 0 or n == 0:
        return (torch.full((m,), NEG_INF, device=dev),
                torch.zeros(m, dtype=torch.int32, device=dev),
                torch.full((n,), NEG_INF, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev))
    if d % 4:  # zero depths: 16-byte rows, the same products
        a = torch.nn.functional.pad(a, (0, -d % 4))
        b = torch.nn.functional.pad(b, (0, -d % 4))
    a, b = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))
    keys = torch.zeros(m + n, dtype=torch.int64, device=dev)
    # one buffer for the four outputs, all written by the kernel's decode
    out = torch.empty(2 * (m + n), dtype=torch.int32, device=dev)
    row_max, col_max = out[:m].view(torch.float32), out[m:m + n].view(
        torch.float32)
    row_arg, col_arg = out[m + n:2 * m + n], out[2 * m + n:]
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        err = lib.cmhse_simhinge_pair(
            a.data_ptr(), b.data_ptr(), neg.data_ptr(), row_diag.data_ptr(),
            col_diag.data_ptr(), keys.data_ptr(), row_max.data_ptr(),
            row_arg.data_ptr(), col_max.data_ptr(), col_arg.data_ptr(), m, n,
            a.shape[1], float(margin),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "simhinge launch")
    cuda_lib.count_launch("simhinge", "float32", "pair")
    return row_max, row_arg, col_max, col_arg


class FusedContrastiveLoss(torch.autograd.Function):
    """The max-violation loss of :func:`cmhse_tpu_torch.ops.loss.
    contrastive_loss` from one :func:`simhinge_pair` call; the backward
    is ``_loss_bwd`` of the JAX package: gathers and a scatter-add by the
    saved argmaxes, O(B * D), repeatable bit for bit on the card."""

    @staticmethod
    def forward(ctx, emb_a, emb_b, neg_mask, valid, margin):
        a32 = emb_a.float().contiguous()
        b32 = emb_b.float().contiguous()
        neg = neg_mask.bool().contiguous()
        diag = torch.sum(a32 * b32, dim=1)
        row_max, row_arg, col_max, col_arg = simhinge_pair(
            a32, b32, neg, diag, diag, margin)
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
        # The scatter-adds accumulate with index_put_, which sums duplicate
        # indices in a fixed order on the card too (index_add_ there adds
        # them with atomics, in whatever order they land: the step would
        # not repeat bit for bit); on the CPU both add in index order.
        d_a = act_r * (b32.index_select(0, row_arg) - b32) - act_c * b32
        d_a.index_put_((col_arg,), act_c * b32, accumulate=True)
        d_b = act_c * (a32.index_select(0, col_arg) - a32) - act_r * a32
        d_b.index_put_((row_arg,), act_r * a32, accumulate=True)
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
