"""Plain PyTorch reference of CMHSE with a DeepSeek-V2 decoder stack as its
sentence encoder (words -> sentence), written from the equations alone:
DeepSeek-V2's ``modeling_deepseek.py`` for the stack (RMSNorm, multi-head
latent attention with YaRN RoPE, SwiGLU MLPs, the softmax top-k router, the
routed and shared experts), CMHSE (``reference/cmhse.py``, reused) for the
rest: the video hierarchy, ``text_high``, the attention pools, the
reconstruction decoders and the objective.

It imports nothing of the measured program and runs on any device in
float32, TF32 off; every matrix product goes through ``Reference.mm``, so
``tf32=True`` rounds their operands as a TF32 product does (the control).
The experts are a Python loop over the held experts, each multiplying the
rows routed to it; nothing is planned, packed or fused.

The stack, for each sentence (``W`` token slots, ``len`` live, positions
``0 .. len - 1``)::

    h = embed[ids]
    for each layer: h += MLA(RMSNorm(h)); h += FFN(RMSNorm(h))
    sentence = l2norm(proj(pool(RMSNorm(h))))

    MLA: q = x W_q (H x (nope + rope)); [c, k_pe] = x W_kva; c = RMSNorm(c);
         [k_nope, v] = c W_kvb; RoPE (pairs de-interleaved, rotate-half,
         YaRN frequencies) on q_pe and the shared k_pe; softmax(q k^T scale)
         over keys t' <= t, t' < len; scale = (nope + rope)^-1/2 mscale^2;
         then W_o
    FFN: SwiGLU W_down(silu(x W_g) * x W_u) in the first
         ``first_k_dense_replace`` layers; after them softmax(x W_router)
         over every routed expert, greedy top-k, the raw scores as weights,
         the held experts' part summed, plus the shared experts' MLP

Parameters: a dict of tensors keyed by the program's names
(``text_tower.layers.0.attn.w_q`` and so on), kernels stored ``[in, out]``,
routed experts stacked ``[held, in, out]``, gate and up in one ``w_gu``
(gate's columns first).

Routing near ties. Two f32 paths (the program's and this one) can order two
experts whose scores nearly tie differently. A batch may carry the experts
each row was routed to (``batch["routes"]``, one ``[R, k]`` tensor a layer);
then those are used, and this reference's own top-k is logged beside them
(``route_log``) for the judge to count the rows that differ.
"""

from __future__ import annotations

import math

import torch

from reference import cmhse as base


def yarn_mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def rope_tables(t: dict, steps: int, device):
    """(cos, sin) ``[steps, rope]`` of DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``, computed in float64, then f32."""
    dim, base_ = t["qk_rope_head_dim"], t["rope_theta"]
    factor = t["rope_factor"]
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    freq_extra = 1.0 / base_ ** (i / dim)
    freq_inter = 1.0 / (factor * base_ ** (i / dim))

    def correction_dim(rotations):
        return (dim * math.log(t["rope_original_max_position"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base_)))

    low = max(math.floor(correction_dim(t["rope_beta_fast"])), 0)
    high = min(math.ceil(correction_dim(t["rope_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    linear = (torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)
    mask = 1.0 - linear.clamp(0, 1)
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    freqs = torch.outer(torch.arange(steps, dtype=torch.float64), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = (yarn_mscale(factor, t["rope_mscale"])
         / yarn_mscale(factor, t["rope_mscale_all_dim"]))
    return ((emb.cos() * m).float().to(device),
            (emb.sin() * m).float().to(device))


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def apply_rope(x, cos, sin):
    """DeepSeek-V2's apply_rotary_pos_emb on ``x`` ``[..., T, d]``."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    return x * cos + rotate_half(x) * sin


class Reference(base.Reference):
    """CMHSE with the stack. ``tower``: the configuration's ``text_tower``
    section (a dict of the stack's settings)."""

    def __init__(self, model_cfg: dict, loss_cfg: dict | None = None,
                 tower: dict | None = None, tf32: bool = False) -> None:
        super().__init__(model_cfg, loss_cfg, tf32)
        self.t = dict(tower)
        self.route_log: list = []
        self._given = None
        self._moe_layer = 0

    # -- pieces ---------------------------------------------------------------

    def rms(self, x, w):
        x32 = x.float()
        return x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True)
                                 + self.t["rms_norm_eps"]) * w

    def lin(self, x, w):
        """``x [..., K] @ w [K, N]`` as one 2-D product."""
        return self.mm(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])

    def mlp(self, p, pre, x):
        gu = self.lin(x, p[f"{pre}w_gu"])
        width = gu.shape[-1] // 2
        act = torch.nn.functional.silu(gu[..., :width]) * gu[..., width:]
        return self.lin(act, p[f"{pre}w_down"])

    def mla(self, p, pre, x, live, cos, sin):
        t = self.t
        n, w, _ = x.shape
        h, nope, rope, vd = (t["num_attention_heads"], t["qk_nope_head_dim"],
                             t["qk_rope_head_dim"], t["v_head_dim"])
        rank = t["kv_lora_rank"]
        q = self.lin(x, p[f"{pre}w_q"]).view(n, w, h, nope + rope)
        q = q.transpose(1, 2)
        kva = self.lin(x, p[f"{pre}w_kva"])
        c = self.rms(kva[..., :rank], p[f"{pre}kv_norm"])
        k_pe = kva[..., rank:][:, None]
        kv = self.lin(c, p[f"{pre}w_kvb"]).view(n, w, h, nope + vd)
        kv = kv.transpose(1, 2)
        q_pe = apply_rope(q[..., nope:], cos, sin)
        k_pe = apply_rope(k_pe, cos, sin)
        query = torch.cat([q[..., :nope], q_pe], dim=-1)
        key = torch.cat([kv[..., :nope], k_pe.expand(n, h, w, rope)], dim=-1)
        m = yarn_mscale(t["rope_factor"], t["rope_mscale_all_dim"])
        scale = (nope + rope) ** -0.5 * m ** 2
        scores = self.mm(query, key.transpose(-1, -2)) * scale
        pos = torch.arange(w, device=x.device)
        allowed = (pos[None, :] <= pos[:, None])[None] & live[:, None, :]
        scores = torch.where(allowed[:, None], scores,
                             torch.full_like(scores, -1e9))
        out = self.mm(torch.softmax(scores, dim=-1), kv[..., nope:])
        out = out.transpose(1, 2).reshape(n, w, h * vd)
        return self.lin(out, p[f"{pre}w_o"])

    def moe(self, p, pre, x, live):
        """The held experts' part (a loop over them) plus the shared
        experts."""
        t = self.t
        n, w, d = x.shape
        k, held, off = (t["num_experts_per_tok"], t["experts_held"],
                        t["expert_offset"])
        xf = x.reshape(n * w, d)
        livef = live.reshape(-1)
        scores = torch.softmax(self.lin(xf, p[f"{pre}router"]).float(),
                               dim=-1)
        _, own = torch.topk(scores, k, dim=-1)
        use = own if self._given is None else \
            self._given[self._moe_layer].to(x.device).long()
        weights = scores.gather(1, use)
        if t.get("norm_topk_prob"):
            weights = weights / weights.sum(dim=-1, keepdim=True)
        weights = weights * t["routed_scaling_factor"]
        self.route_log.append({"own": own.detach(), "used": use.detach(),
                               "scores": scores.detach(), "live": livef})
        self._moe_layer += 1
        out = torch.zeros_like(xf)
        width = p[f"{pre}experts_down"].shape[1]
        for e in range(held):
            hit = (use == off + e) & livef[:, None]
            rows = hit.any(dim=-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            s = (weights * hit).sum(dim=-1)[rows]
            gu = self.mm(xf[rows], p[f"{pre}experts_gu"][e])
            act = torch.nn.functional.silu(gu[:, :width]) * gu[:, width:]
            y = self.mm(act, p[f"{pre}experts_down"][e]) * s[:, None]
            out = out.index_add(0, rows, y)
        return out.view(n, w, d) + self.mlp(p, f"{pre}shared.", x)

    def tower(self, p, ids, lengths):
        """Token ids ``[N, W]``, lengths ``[N]`` -> sentence embeddings
        ``[N, E]``."""
        t = self.t
        n, w = ids.shape
        live = torch.arange(w, device=ids.device)[None, :] < lengths[:, None]
        h = torch.where(live[..., None], p["text_tower.embed"][ids.long()],
                        torch.zeros((), device=ids.device))
        cos, sin = rope_tables(t, w, ids.device)
        for i in range(t["num_hidden_layers"]):
            pre = f"text_tower.layers.{i}."
            x = self.rms(h, p[f"{pre}attn_norm"])
            h = h + self.mla(p, f"{pre}attn.", x, live, cos, sin)
            x = self.rms(h, p[f"{pre}ffn_norm"])
            if i < t["first_k_dense_replace"]:
                h = h + self.mlp(p, f"{pre}ffn.", x)
            else:
                h = h + self.moe(p, f"{pre}ffn.", x, live)
        h = torch.where(live[..., None], self.rms(h, p["text_tower.norm"]),
                        torch.zeros((), device=ids.device))
        emb = self.attention_pool(p, "text_tower.pool.", h, lengths)
        return self.l2norm(self.dense(p, "text_tower.proj", emb))

    # -- the model ------------------------------------------------------------

    def encode_text(self, p, words, word_len, sent_len):
        b, s, w = words.shape
        sent = self.tower(p, words.reshape(b * s, w), word_len.reshape(b * s))
        sent = sent.reshape(b, s, -1)
        para, _ = self.stage(p, "text_high", sent, sent_len,
                             self._readouts()[1])
        return para, sent

    def loss(self, p, batch):
        self._given = batch.get("routes")
        self._moe_layer = 0
        return super().loss(p, batch)


@torch.no_grad()
def _adam_(params: dict, grads: dict, m: dict, v: dict, t: int, lr: float,
           clip: float, betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """``reference.cmhse.AdamState.step`` in place on the moments given, no
    copies kept; returns the per-leaf norms of the clipped gradient."""
    norm = math.sqrt(sum(float(torch.sum(g.double() * g.double()))
                         for g in grads.values()))
    scale = clip / norm if norm >= clip else 1.0
    b1, b2 = betas
    norms = {}
    for k, p in params.items():
        g = grads[k] * scale
        norms[k] = float(torch.linalg.vector_norm(g.double()))
        m[k].mul_(b1).add_(g, alpha=1 - b1)
        v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m[k] / (1 - b1 ** t)
        v_hat = v[k] / (1 - b2 ** t)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
        del g, m_hat, v_hat
    return norms


def train_steps(ref: Reference, params: dict, batches: list, lr: float,
                grad_clip: float, moments: tuple | None = None) -> dict:
    """``reference.cmhse.train_steps`` for a model whose state fills much of
    the card: ``params`` (and the ``moments``, first, second, steps taken)
    are taken over and changed in place, the start is kept on the host.
    Returns each step's loss, the per-leaf norm of the first step's clipped
    gradient, the per-leaf norm of the parameters' change after the last
    step, and each step's ``route_log``."""
    start = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in live.items()}
        v2 = {k: torch.zeros_like(v) for k, v in live.items()}
        t = 0
    else:
        m, v2, t = moments
    losses, first_grad, logs = [], None, []
    for batch in batches:
        for x in live.values():
            x.grad = None
        ref.route_log = []
        loss = ref.loss(live, batch)
        loss.backward()
        losses.append(float(loss.detach()))
        del loss
        logs.append(ref.route_log)
        ref.route_log = []
        grads = {k: (x.grad if x.grad is not None else torch.zeros_like(x))
                 for k, x in live.items()}
        t += 1
        norms = _adam_(live, grads, m, v2, t, lr, grad_clip)
        del grads
        if first_grad is None:
            first_grad = norms
    for x in live.values():
        x.grad = None
    change = {}
    for k, x in live.items():
        change[k] = float(torch.linalg.vector_norm(
            (x.detach() - start[k].to(x.device)).double()))
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change, "route_logs": logs}
