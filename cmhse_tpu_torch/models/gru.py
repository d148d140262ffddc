"""Masked GRU over padded sequences, counterpart of ``cmhse_tpu/models/gru.py``.

Numerics contract (the same as the JAX package's):
  * gate equations and order match ``torch.nn.GRU``::

        r_t = sigmoid(x_t W_ir + b_ir + h_{t-1} W_hr + b_hr)
        z_t = sigmoid(x_t W_iz + b_iz + h_{t-1} W_hz + b_hz)
        n_t = tanh  (x_t W_in + b_in + r_t * (h_{t-1} W_hn + b_hn))
        h_t = (1 - z_t) * n_t + z_t * h_{t-1}

    with the fused weights stored as in the JAX package: ``w_i [D, 3H]``,
    ``w_h [H, 3H]``, ``b_i``/``b_h [3H]``, gate-major (r, z, n);
  * steps with ``t >= length`` carry ``h_{t-1}`` through unchanged, so the
    final state is the state at the true length and padded output steps
    HOLD the carried state (``nn.GRU`` over packed sequences zero-fills
    them instead).

The input projection for all steps is one matrix product; the recurrence
is :func:`cmhse_tpu_torch.ops.gru_kernel.gru_recurrence` — the ``gru_fwd``
CUDA kernel on the card, its plain loop on the CPU; when autograd needs a
gradient, its gate-saving variant and the ``gru_bwd`` backward (or their
plain versions) through ``TrainableGRU``.

Mixed precision (``dtype=torch.bfloat16``): the input is rounded to bf16,
the projection multiplies bf16 operands with f32 accumulation, adds the f32
``b_i`` and rounds once; the recurrence runs in bf16 with an f32 carry; the
parameters and their gradients stay f32, as in the JAX package's
``pallas_gru_trainable``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cmhse_tpu_torch.ops.gru_kernel import gru_recurrence, gru_recurrence_plain


class _InputProjection(torch.autograd.Function):
    """``x @ w_i + b_i`` in ``x``'s dtype, with f32 accumulation and f32
    gradients of the parameters. In bf16 autograd of the casts would round
    ``dW_i`` to bf16 before it reaches the f32 parameter, a rounding the JAX
    package's custom VJP does not make (``pallas_gru_grad.py:335-341``)."""

    @staticmethod
    def forward(ctx, x, w_i, b_i):
        w = w_i.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.dtypes = (w_i.dtype, b_i.dtype)
        return (x.float() @ w.float() + b_i.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float().reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (g @ w.float().T).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (x.float().reshape(-1, x.shape[-1]).T @ g).to(ctx.dtypes[0])
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=0).to(ctx.dtypes[1])
        return dx, dw, db


def gru_input_projection(x: torch.Tensor, w_i: torch.Tensor,
                         b_i: torch.Tensor) -> torch.Tensor:
    """``x [B, T, D] @ w_i [D, 3H] + b_i`` for every step at once, in
    ``x``'s dtype: ``w_i`` rounded to it, f32 products of the (exact)
    operands, the f32 ``b_i`` added, one rounding (the JAX package's
    ``gru_input_projection``). The backward gives f32 ``dW_i``/``db_i`` and
    ``dx`` rounded to ``x``'s dtype."""
    return _InputProjection.apply(x, w_i, b_i)


def gru_sequence(
    x: torch.Tensor,
    lengths: torch.Tensor,
    w_i: torch.Tensor,
    w_h: torch.Tensor,
    b_i: torch.Tensor,
    b_h: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain masked GRU: the input projection and a Python loop over T.

    Returns outputs ``[B, T, H]`` (padded steps hold the carried state) and
    final ``[B, H]`` (the state at each row's true length; ``h0``, zeros by
    default, for length 0). This is the reference the ``gru_fwd`` kernel is
    held against."""
    xw = gru_input_projection(x, w_i, b_i)
    return gru_recurrence_plain(xw, w_h, b_h, lengths, h0)


def flip_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row's valid prefix in place, leaving padding at the
    tail: ``[a b c PAD PAD] -> [c b a PAD PAD]``."""
    b, t = x.shape[0], x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    lens = lengths.long()[:, None]
    src = torch.where(pos < lens, lens - 1 - pos, pos)  # [B, T]
    idx = src.reshape(b, t, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


class MaskedGRU(nn.Module):
    """Masked GRU, optionally bidirectional. Parameters ``fwd_w_i``,
    ``fwd_w_h``, ``fwd_b_i``, ``fwd_b_h`` (and ``bwd_*``) carry the JAX
    package's names and layouts; they stay f32 whatever ``dtype``, the
    compute dtype the input is cast to. Init is uniform(-1/sqrt(H),
    1/sqrt(H)) for every parameter, biases included, as PyTorch's GRU and
    the JAX package do."""

    def __init__(self, in_dim: int, features: int,
                 bidirectional: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.features = features
        self.bidirectional = bidirectional
        self.dtype = dtype
        scale = 1.0 / math.sqrt(features)
        shapes = {"w_i": (in_dim, 3 * features),
                  "w_h": (features, 3 * features),
                  "b_i": (3 * features,), "b_h": (3 * features,)}
        for direction in ("fwd", "bwd") if bidirectional else ("fwd",):
            for name, shape in shapes.items():
                p = torch.empty(shape)
                nn.init.uniform_(p, -scale, scale, generator=generator)
                self.register_parameter(f"{direction}_{name}",
                                        nn.Parameter(p))

    def _run(self, x, lengths, direction: str):
        xw = gru_input_projection(x, getattr(self, f"{direction}_w_i"),
                                  getattr(self, f"{direction}_b_i"))
        return gru_recurrence(xw.contiguous(),
                              getattr(self, f"{direction}_w_h"),
                              getattr(self, f"{direction}_b_h"), lengths)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (outputs ``[B, T, H]`` or ``[B, T, 2H]``, final ``[B, H]``
        or ``[B, 2H]``)."""
        x = x.to(self.dtype)
        lengths = lengths.to(torch.int32)
        outs_f, final_f = self._run(x, lengths, "fwd")
        if not self.bidirectional:
            return outs_f, final_f
        outs_b, final_b = self._run(flip_padded(x, lengths), lengths, "bwd")
        outs_b = flip_padded(outs_b, lengths)
        return (torch.cat([outs_f, outs_b], dim=-1),
                torch.cat([final_f, final_b], dim=-1))


def masked_mean(outputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean over valid timesteps of ``[B, T, H]`` -> ``[B, H]``."""
    t = outputs.shape[1]
    mask = (torch.arange(t, device=outputs.device)[None, :]
            < lengths[:, None]).to(outputs.dtype)
    summed = torch.sum(outputs * mask[:, :, None], dim=1)
    denom = torch.clamp(lengths.to(outputs.dtype), min=1.0)[:, None]
    return summed / denom
