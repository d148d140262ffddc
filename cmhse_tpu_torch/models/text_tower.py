"""A DeepSeek-V2 decoder stack as CMHSE's sentence encoder (words ->
sentence), in place of the word embedding and ``text_low``'s GRU.

Each sentence, a row of ``W`` token slots, is its own causal sequence at
positions ``0 .. len - 1``. With ``h`` the residual stream::

    h = embed[ids]
    for each layer:  h += Attn(RMSNorm(h));  h += FFN(RMSNorm(h))
    h = RMSNorm(h)          RMSNorm(x) = x rsqrt(mean(x^2) + eps) w
    sentence = l2norm(proj(AttentionPool(h over the live tokens)))

Attention is multi-head latent attention (MLA) without a query LoRA::

    q = h W_q                       -> H x (nope + rope)
    [c_kv, k_pe] = h W_kva          -> rank + rope;   c_kv = RMSNorm(c_kv)
    [k_nope, v] = c_kv W_kvb        -> H x (nope + v)
    q_pe, k_pe (one, shared by the heads): RoPE with YaRN frequencies, the
        rope dims de-interleaved first ((x0, x1, x2, ...) -> (x0, x2, ...,
        x1, x3, ...)) as DeepSeek-V2's apply_rotary_pos_emb does, then
        rotate-half
    softmax(q k^T * scale) over the keys t' <= t, t' < len, then v, then W_o
    scale = (nope + rope)^-1/2 * mscale(factor, mscale_all_dim)^2

YaRN: ``inv_freq = f_inter (1 - m) + f_extra m`` with ``f_extra =
theta^(-2i / rope)``, ``f_inter = f_extra / factor`` and the ramp ``m = 1 -
clamp((i - low) / (high - low), 0, 1)``, ``low = max(floor(d(beta_fast)),
0)``, ``high = min(ceil(d(beta_slow)), rope - 1)``, ``d(r) = rope ln(L /
(2 pi r)) / (2 ln theta)`` (L the original context); cos and sin are scaled by
``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``, ``mscale(s, m) =
0.1 m ln s + 1``.

The FFN is a SwiGLU MLP, ``W_down(silu(x W_gate) * x W_up)``, in the first
``first_k_dense_replace`` layers, and a mixture of experts after them::

    s = softmax(x W_router)  (f32, over every routed expert)
    y = sum over the top-k experts e that are held here of s_e E_e(x)
        + Shared(x)

(greedy top-k, the raw scores as weights, times ``routed_scaling_factor``;
``E_e`` SwiGLU MLPs of ``moe_intermediate_size``, ``Shared`` one of
``n_shared_experts`` times it). The layer is told which experts it holds
(``experts_held`` from ``expert_offset``), as one chip of an
expert-parallel deployment is: it routes over all of them and computes only
its held experts' part; what the others would add is left out.

Departures from the published model (also the config's ``assumed``): f32
compute and parameters; one token a word (the sentence's word ids index the
embedding); weights random from a seed; no auxiliary balance loss; the
readout, an attention pool and a projection to the joint space, is CMHSE's.

Weights are stored ``[in, out]``, the GRU's ``w_i`` layout; ``w_gu`` holds
the gate's columns and then the up's; routed experts are stacked
``[held, in, out]``.

On the card, in f32, the products over tokens (the MLA projections, the
dense and shared MLPs, the router) take the live tokens only: the row and
reduction forms of ``csrc/live_gemm.cu`` on the live-row plan of the words
(:func:`cmhse_tpu_torch.ops.gru_kernel._live_plan`, made once a forward),
through :class:`~cmhse_tpu_torch.ops.live_gemm.LiveProduct`, with the dead
rows of every product zeros. The routed experts take the grouped forms
(kernels ``moe_*``) on a routing plan made on the card
(:func:`~cmhse_tpu_torch.ops.live_gemm.moe_plan`). Nothing is read back to
the host, so ``train_step`` captures the step. The attention core (at most
``W`` keys) is plain PyTorch. On the CPU the token products are dense and
the grouped forms their plain versions. bf16 is refused.

With the recorder on (:mod:`cmhse_tpu_torch.utils.timing`), an eager
forward records ``tower.forward``, and in each expert layer ``moe.route``
and ``moe.experts``. Two device-side running totals count the live tokens
(``tower.tokens``) and the assignments to held experts (``moe.assignments``)
that the forwards saw, a captured step adding to them too; they are read
(:meth:`TextTower.counters`) only where the caller already waits for the
card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from dataclasses import dataclass

import torch
from torch import nn

from cmhse_tpu_torch.models.encoders import AttentionPool, _dense
from cmhse_tpu_torch.ops import live_gemm
from cmhse_tpu_torch.ops.gru_kernel import _live_plan
from cmhse_tpu_torch.ops.similarity import l2norm
from cmhse_tpu_torch.utils import timing

ASSUMED = (
    "f32 compute and parameters (the published weights are bf16)",
    "one token a word: a sentence's word ids index the embedding",
    "weights random from a seed, dense kernels and the embedding uniform "
    "with std initializer_range 0.02, RMSNorm weights 1",
    "no auxiliary balance loss: the config gives no weight for one",
    "readout: CMHSE's attention pool over the live tokens, a projection to "
    "the joint space and an L2 norm",
)


@dataclass(frozen=True)
class TextTowerConfig:
    """The tower's settings, named as DeepSeek-V2's ``config.json`` where it
    has the setting. Defaults: DeepSeek-V2-Lite whole (every layer, every
    expert held). ``routed_experts`` is the router's width; ``experts_held``
    experts from ``expert_offset`` are computed here."""

    hidden_size: int = 2048
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 10944
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    routed_experts: int = 64
    experts_held: int = 64
    expert_offset: int = 0
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    n_shared_experts: int = 2
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_original_max_position: int = 4096
    initializer_range: float = 0.02
    attn_dim: int = 256
    assumed: tuple = ASSUMED

    def __post_init__(self) -> None:
        object.__setattr__(self, "assumed", tuple(self.assumed))
        if not 0 <= self.expert_offset <= \
                self.routed_experts - self.experts_held or \
                self.experts_held < 1:
            last = self.expert_offset + self.experts_held - 1
            raise ValueError(
                f"experts {self.expert_offset} .. {last} are not among the "
                f"router's {self.routed_experts}")
        if not 1 <= self.num_experts_per_tok <= self.routed_experts:
            raise ValueError("num_experts_per_tok must be in 1 .. "
                             f"{self.routed_experts}")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even")

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["assumed"] = list(self.assumed)
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_dict(cls, raw: dict) -> "TextTowerConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - names
        if unknown:
            raise ValueError(f"unknown text tower settings: {sorted(unknown)}")
        return cls(**raw)

    @classmethod
    def from_json(cls, text: str) -> "TextTowerConfig":
        return cls.from_dict(json.loads(text))


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(cfg: TextTowerConfig) -> torch.Tensor:
    """The YaRN frequencies ``[rope / 2]`` (float64)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    extra = 1.0 / base ** (i / dim)
    inter = extra / cfg.rope_factor

    def turns(r):
        return (dim * math.log(cfg.rope_original_max_position
                               / (r * 2 * math.pi)) / (2 * math.log(base)))

    low = max(math.floor(turns(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(turns(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_tables(cfg: TextTowerConfig, steps: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[steps, rope]`` f32 at positions ``0 .. steps - 1``."""
    freqs = torch.outer(torch.arange(steps, dtype=torch.float64),
                        yarn_inv_freq(cfg))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return ((emb.cos() * m).float().to(device),
            (emb.sin() * m).float().to(device))


def softmax_scale(cfg: TextTowerConfig) -> float:
    return ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
            * yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) ** 2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x`` ``[..., T, rope]`` with ``cos`` / ``sin`` ``[T, rope]``: the
    pairs de-interleaved, then ``x cos + rotate_half(x) sin``."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(
        x.shape)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _span(name: str):
    """A recorder span outside a graph capture (a capture's host time is
    not a step's)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return timing.span(name)


class _Tokens:
    """One forward's view of the live tokens: lengths ``[N]`` int32, the
    live mask ``[N, W]`` and the plan of the live rows (empty where the
    products are dense)."""

    def __init__(self, h: torch.Tensor, lengths: torch.Tensor) -> None:
        self.lengths = lengths
        w = h.shape[1]
        self.live = (torch.arange(w, device=h.device)[None, :]
                     < lengths[:, None])
        self.plan = _live_plan(h, lengths) if live_gemm.takes(h) else ()

    def product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [N, W, K] @ w [K, N']``: on the live rows only (dead rows
        zeros) where :func:`live_gemm.takes` ``x``, else dense."""
        return live_gemm.live_product(x, w, None, self.lengths, self.plan,
                                      zero_dead=True)


def _param(shape, std: float | None, generator) -> nn.Parameter:
    """Uniform with standard deviation ``std`` (ones where None)."""
    p = torch.empty(shape)
    if std is None:
        nn.init.ones_(p)
    else:
        half = std * math.sqrt(3.0)
        nn.init.uniform_(p, -half, half, generator=generator)
    return nn.Parameter(p)


class MLA(nn.Module):
    """Multi-head latent attention, no query LoRA (module docstring)."""

    def __init__(self, cfg: TextTowerConfig, generator) -> None:
        super().__init__()
        d, h, std = cfg.hidden_size, cfg.num_attention_heads, \
            cfg.initializer_range
        self.cfg = cfg
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.w_q = _param((d, h * qk), std, generator)
        self.w_kva = _param((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), std,
                            generator)
        self.kv_norm = _param((cfg.kv_lora_rank,), None, generator)
        self.w_kvb = _param(
            (cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            std, generator)
        self.w_o = _param((h * cfg.v_head_dim, d), std, generator)

    def forward(self, x: torch.Tensor, tok: _Tokens, cos, sin) -> torch.Tensor:
        c = self.cfg
        n, w, _ = x.shape
        h, nope, rope, vd = (c.num_attention_heads, c.qk_nope_head_dim,
                             c.qk_rope_head_dim, c.v_head_dim)
        q = tok.product(x, self.w_q).view(n, w, h, nope + rope)
        kva = tok.product(x, self.w_kva)
        c_kv = rms_norm(kva[..., :c.kv_lora_rank], self.kv_norm,
                        c.rms_norm_eps)
        k_pe = kva[..., c.kv_lora_rank:]
        kv = tok.product(c_kv.contiguous(), self.w_kvb).view(n, w, h,
                                                             nope + vd)
        q = q.transpose(1, 2)  # [N, H, W, nope + rope]
        kv = kv.transpose(1, 2)
        q_pe = apply_rope(q[..., nope:], cos, sin)
        k_pe = apply_rope(k_pe[:, None], cos, sin).expand(n, h, w, rope)
        qf = torch.cat([q[..., :nope], q_pe], dim=-1)
        kf = torch.cat([kv[..., :nope], k_pe], dim=-1)
        scores = torch.matmul(qf, kf.transpose(-1, -2)) * softmax_scale(c)
        t = torch.arange(w, device=x.device)
        allowed = (t[None, :] <= t[:, None])[None] & tok.live[:, None, :]
        scores = torch.where(allowed[:, None], scores, -1e9)
        out = torch.matmul(torch.softmax(scores, dim=-1), kv[..., nope:])
        out = out.transpose(1, 2).reshape(n, w, h * vd)
        return tok.product(out.contiguous(), self.w_o)


class MLP(nn.Module):
    """SwiGLU MLP, ``w_down(silu(x w_gate) * x w_up)``, gate and up in one
    weight ``w_gu [in, 2 I]``."""

    def __init__(self, d: int, width: int, std: float, generator) -> None:
        super().__init__()
        self.width = width
        self.w_gu = _param((d, 2 * width), std, generator)
        self.w_down = _param((width, d), std, generator)

    def forward(self, x: torch.Tensor, tok: _Tokens) -> torch.Tensor:
        gu = tok.product(x, self.w_gu)
        act = nn.functional.silu(gu[..., :self.width]) * gu[..., self.width:]
        return tok.product(act.contiguous(), self.w_down)


class _RoutedExperts(torch.autograd.Function):
    """The held experts' part of a mixture-of-experts layer over its routing
    plan, in the grouped forms: ``y [R, D] = sum over each row's
    assignments to held experts e of s * E_e(x)``. The assignments' rows
    live in slot order (sorted by expert); the down product writes each to
    its assignment's row of ``[R * k, D]``, zeros where an assignment has
    no held expert, and the rows' ``k`` assignments are summed in order."""

    @staticmethod
    def forward(ctx, x, w_gu, w_down, top_w, tok, assign, gstarts, valid):
        r, d = x.shape
        k = top_w.shape[1]
        width = w_down.shape[1]
        cap = r * k
        s_slot = top_w.reshape(-1)[assign.long()].contiguous()
        gu = live_gemm.moe_rows(
            x, w_gu, gstarts,
            torch.empty(cap, 2 * width, dtype=x.dtype, device=x.device),
            a_idx=tok)
        act = nn.functional.silu(gu[:, :width]) * gu[:, width:]
        y = live_gemm.moe_rows(
            act, w_down, gstarts,
            torch.zeros(cap, d, dtype=x.dtype, device=x.device),
            c_idx=assign, scale=s_slot)
        ctx.save_for_backward(x, w_gu, w_down, gu, s_slot, tok, assign,
                              gstarts, valid)
        ctx.k = k
        return y.view(r, k, d).sum(dim=1)

    @staticmethod
    def backward(ctx, dy):
        x, w_gu, w_down, gu, s_slot, tok, assign, gstarts, valid = \
            ctx.saved_tensors
        r, d = x.shape
        k = ctx.k
        width = w_down.shape[1]
        cap = r * k
        dy = dy.contiguous()
        gate, up = gu[:, :width], gu[:, width:]
        silu = nn.functional.silu(gate)
        act = silu * up
        # dy[tok] @ w_down[e]^T: the down product's input gradient, unscaled
        ud = live_gemm.moe_rows(
            dy, w_down, gstarts,
            torch.empty(cap, width, dtype=x.dtype, device=x.device),
            a_idx=tok, w_nk=True)
        d_s = torch.where(valid, (ud * act).sum(dim=-1), 0.0)
        d_top = torch.zeros(cap, dtype=x.dtype, device=x.device).scatter_(
            0, assign.long(), d_s).view(r, k)
        dw_down = live_gemm.moe_reduce(act.mul_(s_slot[:, None]), dy,
                                       gstarts, g_idx=tok)
        d_act = ud.mul_(s_slot[:, None])
        d_gu = torch.empty_like(gu)
        torch.mul(d_act, silu, out=d_gu[:, width:])
        torch.ops.aten.silu_backward.grad_input(
            d_act.mul_(up), gate, grad_input=d_gu[:, :width])
        dw_gu = live_gemm.moe_reduce(x, d_gu, gstarts, a_idx=tok)
        dx = live_gemm.moe_rows(
            d_gu, w_gu, gstarts,
            torch.zeros(cap, d, dtype=x.dtype, device=x.device),
            c_idx=assign, w_nk=True).view(r, k, d).sum(dim=1)
        return dx, dw_gu, dw_down, d_top, None, None, None, None


class MoE(nn.Module):
    """The mixture-of-experts FFN (module docstring): a softmax router over
    every routed expert, the held experts' part, the shared experts."""

    def __init__(self, cfg: TextTowerConfig, generator) -> None:
        super().__init__()
        d, std = cfg.hidden_size, cfg.initializer_range
        self.cfg = cfg
        self.router = _param((d, cfg.routed_experts), std, generator)
        self.shared = MLP(d, cfg.moe_intermediate_size * cfg.n_shared_experts,
                          std, generator)
        self.experts_gu = _param(
            (cfg.experts_held, d, 2 * cfg.moe_intermediate_size), std,
            generator)
        self.experts_down = _param(
            (cfg.experts_held, cfg.moe_intermediate_size, d), std, generator)
        # the top-k of the last forward, by its [N * W, k] shape: a buffer
        # made in an eager forward that a captured step copies into too
        self.route_buffers: dict = {}
        self.last_routes = None

    def forward(self, x: torch.Tensor, tok: _Tokens) -> tuple:
        """-> (output ``[N, W, D]``, assignments to held experts, a 0-d
        device tensor)."""
        c = self.cfg
        n, w, d = x.shape
        with _span("moe.route"):
            logits = tok.product(x, self.router)
            scores = torch.softmax(logits.float(), dim=-1).reshape(n * w, -1)
            top_w, top_i = torch.topk(scores, c.num_experts_per_tok, dim=-1)
            if c.norm_topk_prob:
                top_w = top_w / top_w.sum(dim=-1, keepdim=True)
            top_w = top_w * c.routed_scaling_factor
            key = (tuple(top_i.shape), str(top_i.device))
            if key not in self.route_buffers:
                self.route_buffers[key] = torch.empty_like(top_i)
            self.last_routes = self.route_buffers[key]
            self.last_routes.copy_(top_i)
            tok_of, assign, gstarts, valid = live_gemm.moe_plan(
                top_i, tok.live.reshape(-1), c.experts_held, c.expert_offset)
        with _span("moe.experts"):
            routed = _RoutedExperts.apply(
                x.reshape(n * w, d), self.experts_gu, self.experts_down,
                top_w, tok_of, assign, gstarts, valid)
        return (routed.view(n, w, d) + self.shared(x, tok),
                gstarts[c.experts_held])


class TowerLayer(nn.Module):
    def __init__(self, cfg: TextTowerConfig, dense: bool, generator) -> None:
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.attn_norm = _param((cfg.hidden_size,), None, generator)
        self.attn = MLA(cfg, generator)
        self.ffn_norm = _param((cfg.hidden_size,), None, generator)
        self.ffn = (MLP(cfg.hidden_size, cfg.intermediate_size,
                        cfg.initializer_range, generator) if dense
                    else MoE(cfg, generator))

    def forward(self, h, tok: _Tokens, cos, sin):
        """-> (h, assignments to held experts or None)."""
        h = h + self.attn(rms_norm(h, self.attn_norm, self.eps), tok, cos,
                          sin)
        x = rms_norm(h, self.ffn_norm, self.eps)
        if isinstance(self.ffn, MoE):
            out, assigned = self.ffn(x, tok)
            return h + out, assigned
        return h + self.ffn(x, tok), None


class TextTower(nn.Module):
    """The decoder stack and its readout: token ids ``[N, W]`` and lengths
    ``[N]`` -> sentence embeddings ``[N, embed_size]`` (L2-normalised).
    Built on the CPU from ``generator``, as CMHSE's other parts are; the
    embedding has ``vocab_size`` rows, the model's vocabulary."""

    def __init__(self, cfg: TextTowerConfig, vocab_size: int, embed_size: int,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed = _param((vocab_size, d), cfg.initializer_range,
                            generator)
        self.layers = nn.ModuleList(
            TowerLayer(cfg, i < cfg.first_k_dense_replace, generator)
            for i in range(cfg.num_hidden_layers))
        self.norm = _param((d,), None, generator)
        self.pool = AttentionPool(d, cfg.attn_dim, generator=generator)
        self.proj = _dense(d, embed_size, True, generator)
        self._tables: dict = {}
        self.token_total: torch.Tensor | None = None
        self.assign_total: torch.Tensor | None = None

    def _rope(self, steps: int, device):
        key = (steps, str(device))
        if key not in self._tables:
            self._tables[key] = rope_tables(self.cfg, steps, device)
        return self._tables[key]

    def _count(self, tokens, assigned) -> None:
        if self.token_total is None or \
                self.token_total.device != tokens.device:
            self.token_total = torch.zeros((), dtype=torch.int64,
                                           device=tokens.device)
            self.assign_total = torch.zeros_like(self.token_total)
        self.token_total.add_(tokens)
        for a in assigned:
            self.assign_total.add_(a)

    def counters(self) -> dict:
        """``{"tower.tokens": n, "moe.assignments": n}``, the running totals
        (read from the device: call where the caller waits for it)."""
        if self.token_total is None:
            return {"tower.tokens": 0, "moe.assignments": 0}
        return {"tower.tokens": int(self.token_total),
                "moe.assignments": int(self.assign_total)}

    def routes(self) -> list:
        """The last forward's top-k expert ids ``[N * W, k]`` of each expert
        layer, in layer order. On the card a replayed step writes them into
        the buffers of its batch shape, so after a replay these are its
        routes when its shape was also the last to run eagerly (as in a
        fixed-shape run)."""
        return [layer.ffn.last_routes for layer in self.layers
                if isinstance(layer.ffn, MoE)]

    def forward(self, ids: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        with _span("tower.forward"):
            n, w = ids.shape
            lengths = lengths.to(torch.int32)
            h = nn.functional.embedding(ids.long(), self.embed)
            tok = _Tokens(h, lengths)
            live = tok.live[..., None]
            h = torch.where(live, h, 0.0)
            cos, sin = self._rope(w, h.device)
            assigned = []
            for layer in self.layers:
                h, a = layer(h, tok, cos, sin)
                if a is not None:
                    assigned.append(a)
            h = torch.where(
                live, rms_norm(h, self.norm, self.cfg.rms_norm_eps), 0.0)
            self._count(tok.live.sum(), assigned)
            emb = self.proj(self.pool(h, lengths))
            return l2norm(emb)
