"""Encoder modules, counterpart of ``cmhse_tpu/models/encoders.py``.

Hierarchy:
  video side:  frames --GRU--> clip embedding --GRU--> video embedding
  text side:   words  --GRU--> sentence embed --GRU--> paragraph embedding
Every embedding is projected to the joint space (when its width differs)
and L2-normalized. The low-level GRUs run over ``[B * Cmax]`` flattened rows.

Dense layers are :class:`Dense` (an ``nn.Linear``) named as the JAX
package's ``nn.Dense`` modules, so a JAX kernel ``[in, out]`` maps to
``weight`` by one transpose. Fresh init follows flax (lecun-normal kernels,
zero biases), not torch's ``nn.Linear`` default.

``dtype`` is the compute dtype (f32, or bf16 for mixed precision); the
parameters stay f32 and the word-embedding table f32, as in the JAX
package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cmhse_tpu_torch.models.gru import MaskedGRU, masked_mean
from cmhse_tpu_torch.ops.similarity import l2norm


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense(dtype=...)``'s rule: input, weight
    and bias are cast to the compute dtype, so a bf16 layer multiplies bf16
    operands (f32 accumulation) and returns bf16; its f32 parameters get
    their gradients through the casts, rounded to bf16 as flax's are."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool,
                 dtype: torch.dtype) -> None:
        super().__init__(in_dim, out_dim, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return nn.functional.linear(x.to(dt), self.weight.to(dt), bias)


def _dense(in_dim: int, out_dim: int, bias: bool,
           generator: torch.Generator | None,
           dtype: torch.dtype = torch.float32) -> Dense:
    """:class:`Dense` with flax's ``nn.Dense`` default init: a truncated
    normal of variance 1/fan_in (lecun_normal) and a zero bias."""
    layer = Dense(in_dim, out_dim, bias, dtype)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978  # truncation fix-up
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


class AttentionPool(nn.Module):
    """Self-attentive pooling over per-step GRU states:
    ``scores_t = v . tanh(W h_t + c)``, alpha = softmax over valid steps,
    ``pooled = sum_t alpha_t h_t``. Length-0 rows pool to zeros."""

    def __init__(self, width: int, attn_dim: int = 256,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.proj = _dense(width, attn_dim, True, generator, dtype)
        self.score = _dense(attn_dim, 1, False, generator, dtype)

    def forward(self, states: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        t = states.shape[1]
        scores = self.score(torch.tanh(self.proj(states)))[..., 0]  # [B, T]
        mask = (torch.arange(t, device=states.device)[None, :]
                < lengths[:, None])
        scores = torch.where(mask, scores, -1e9)
        alpha = torch.softmax(scores, dim=-1)
        alpha = torch.where(mask, alpha, 0.0)  # zero rows with length 0
        return torch.einsum("bt,bth->bh", alpha, states)


class SequenceEncoder(nn.Module):
    """GRU + readout + joint-space projection + L2 norm: one hierarchy
    stage. ``readout``: "last" (state at the true length), "mean" (masked
    mean over steps) or "attn" (:class:`AttentionPool`)."""

    def __init__(self, in_dim: int, embed_size: int, rnn_hidden: int,
                 readout: str = "last", bidirectional: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if readout not in ("last", "mean", "attn"):
            raise ValueError(f"unknown readout {readout!r}")
        self.readout = readout
        width = rnn_hidden * (2 if bidirectional else 1)
        self.gru = MaskedGRU(in_dim, rnn_hidden, bidirectional, generator,
                             dtype)
        if readout == "attn":
            self.attn_pool = AttentionPool(width, generator=generator,
                                           dtype=dtype)
        # the JAX package projects only when the readout width differs
        self.proj = (_dense(width, embed_size, True, generator, dtype)
                     if width != embed_size else None)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (embedding ``[B, E]``, states ``[B, T, H]``), both in the
        compute dtype (``l2norm`` reduces in f32)."""
        outs, final = self.gru(x, lengths)
        if self.readout == "last":
            emb = final
        elif self.readout == "mean":
            emb = masked_mean(outs, lengths)
        else:
            emb = self.attn_pool(outs, lengths)
        if self.proj is not None:
            emb = self.proj(emb)
        return l2norm(emb), outs


class WordEmbedding(nn.Module):
    """Token id -> word vector table, init uniform(-0.1, 0.1) (the
    reference's ``nn.Embedding`` init_weights)."""

    def __init__(self, vocab_size: int, word_dim: int = 300,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab_size, word_dim))
        nn.init.uniform_(self.embedding, -0.1, 0.1, generator=generator)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(token_ids.long(), self.embedding)
