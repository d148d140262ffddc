"""Plain PyTorch reference of CMHSE (Zhang, Hu & Sha, ECCV 2018): the
hierarchical GRU encoders, attention pooling, the layer-wise reconstruction
decoders, the max-of-hinges ranking objective, the global-norm clip and
Adam, written from the model's equations alone.

It imports nothing of the measured program and runs on any device in
float32. Every matrix product goes through ``Reference.mm``; with
``tf32=True`` their operands are rounded to TF32 (10 mantissa bits, round
to nearest even) and summed in float32, which is what a TF32 product on
the card computes: that is the control, one precision below the
configuration's float32.

Parameters are a dict of tensors keyed by the names below (``video_low.gru
.fwd_w_i`` and so on); GRU weights are fused gate-major ``[in, 3H]`` in the
order (r, z, n), dense weights ``[out, in]``.

GRU::

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h          (steps past a row's length keep h)
"""

from __future__ import annotations

import math

import torch

EPS = 1e-8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = (bits + 0x0FFF + lsb) & ~0x1FFF
    return out.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return (torch.matmul(rg, rb.transpose(-1, -2)),
                torch.matmul(ra.transpose(-1, -2), rg))


class Reference:
    """The model's functions over a parameter dict. ``cfg`` is the
    configuration file's ``model`` and ``loss`` sections (plain dicts)."""

    def __init__(self, model_cfg: dict, loss_cfg: dict | None = None,
                 tf32: bool = False) -> None:
        self.m = dict(model_cfg)
        self.loss_cfg = dict(loss_cfg or {})
        self.tf32 = tf32

    # -- products -----------------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)

    def dense(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.mm(x, p[f"{name}.weight"].transpose(0, 1))
        bias = p.get(f"{name}.bias")
        return y if bias is None else y + bias

    # -- layers -------------------------------------------------------------

    def gru(self, p: dict, prefix: str, x: torch.Tensor,
            lengths: torch.Tensor, h0: torch.Tensor | None = None):
        """x ``[N, T, D]``, lengths ``[N]`` -> (outputs ``[N, T, H]``,
        final ``[N, H]``); padded steps hold the carried state."""
        w_i, w_h = p[f"{prefix}w_i"], p[f"{prefix}w_h"]
        b_i, b_h = p[f"{prefix}b_i"], p[f"{prefix}b_h"]
        n, t, d = x.shape
        hsz = w_h.shape[0]
        xw = (self.mm(x.reshape(n * t, d), w_i) + b_i).reshape(n, t, 3 * hsz)
        h = x.new_zeros(n, hsz) if h0 is None else h0
        outs = []
        for s in range(t):
            hw = self.mm(h, w_h) + b_h
            xr, xz, xn = xw[:, s].split(hsz, dim=-1)
            hr, hz, hn = hw.split(hsz, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            cand = torch.tanh(xn + r * hn)
            h_new = (1 - z) * cand + z * h
            live = (lengths > s)[:, None]
            h = torch.where(live, h_new, h)
            outs.append(h)
        return torch.stack(outs, dim=1), h

    def attention_pool(self, p: dict, prefix: str, states: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
        t = states.shape[1]
        hidden = torch.tanh(self.dense(p, f"{prefix}proj", states))
        scores = self.dense(p, f"{prefix}score", hidden)[..., 0]
        mask = torch.arange(t, device=states.device)[None, :] < lengths[:, None]
        scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
        alpha = torch.softmax(scores, dim=-1)
        alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
        return self.mm(alpha[:, None, :], states)[:, 0, :]

    @staticmethod
    def l2norm(x: torch.Tensor) -> torch.Tensor:
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)
                              + EPS * EPS)

    def stage(self, p: dict, prefix: str, x: torch.Tensor,
              lengths: torch.Tensor, readout: str):
        """One hierarchy stage: GRU, readout, projection to the joint space
        where the widths differ, L2 norm -> (embedding, states)."""
        outs, final = self.gru(p, f"{prefix}.gru.fwd_", x, lengths)
        if readout == "attn":
            emb = self.attention_pool(p, f"{prefix}.attn_pool.", outs,
                                      lengths)
        elif readout == "last":
            emb = final
        else:
            raise ValueError(f"the reference has no {readout!r} readout")
        if f"{prefix}.proj.weight" in p:
            emb = self.dense(p, f"{prefix}.proj", emb)
        return self.l2norm(emb), outs

    def _readouts(self) -> tuple[str, str]:
        if self.m.get("attention_pool"):
            return "attn", "attn"
        return self.m.get("readout", "last"), "last"

    def encode_video(self, p: dict, frames, frame_len, clip_len):
        """frames ``[B, C, F, feat]`` -> (video ``[B, E]``, clips
        ``[B, C, E]``)."""
        low, high = self._readouts()
        b, c, f, d = frames.shape
        clip_emb, _ = self.stage(p, "video_low", frames.reshape(b * c, f, d),
                                 frame_len.reshape(b * c), low)
        clip_emb = clip_emb.reshape(b, c, -1)
        video_emb, _ = self.stage(p, "video_high", clip_emb, clip_len, high)
        return video_emb, clip_emb

    def encode_text(self, p: dict, words, word_len, sent_len):
        """words ``[B, S, W]`` token ids -> (paragraph ``[B, E]``,
        sentences ``[B, S, E]``)."""
        low, high = self._readouts()
        b, s, w = words.shape
        vecs = p["word_embedding.embedding"][words.reshape(b * s, w).long()]
        sent_emb, _ = self.stage(p, "text_low", vecs, word_len.reshape(b * s),
                                 low)
        sent_emb = sent_emb.reshape(b, s, -1)
        para_emb, _ = self.stage(p, "text_high", sent_emb, sent_len, high)
        return para_emb, sent_emb

    def decode(self, p: dict, prefix: str, high_emb, low_seq, lengths):
        """Teacher-forced reconstruction of the low-level sequence from the
        high-level embedding: h0 = tanh(init(high)), input at step t the
        true low-level embedding at t - 1 (zeros at t = 0)."""
        h0 = torch.tanh(self.dense(p, f"{prefix}.init", high_emb))
        shifted = torch.cat([torch.zeros_like(low_seq[:, :1]),
                             low_seq[:, :-1]], dim=1)
        outs, _ = self.gru(p, f"{prefix}.", shifted, lengths, h0)
        return self.dense(p, f"{prefix}.out", outs)

    # -- objective ----------------------------------------------------------

    def hinge(self, a, b, pos, valid) -> torch.Tensor:
        """Max-of-hinges over in-batch negatives in both directions, mean
        over valid queries; ``pos`` marks positives, ``valid`` real rows."""
        margin = float(self.loss_cfg.get("margin", 0.2))
        sims = self.mm(a, b.transpose(0, 1))
        diag = torch.diagonal(sims)
        neg = ~pos & valid[:, None] & valid[None, :]
        cost_ab = torch.clamp(margin + sims - diag[:, None], min=0.0)
        cost_ba = torch.clamp(margin + sims - diag[None, :], min=0.0)
        zero = torch.zeros_like(sims)
        cost_ab = torch.where(neg, cost_ab, zero)
        cost_ba = torch.where(neg, cost_ba, zero)
        if self.loss_cfg.get("max_violation", True):
            per = cost_ab.amax(dim=1) + cost_ba.amax(dim=0)
        else:
            per = cost_ab.sum(dim=1) + cost_ba.sum(dim=0)
        per = torch.where(valid, per, torch.zeros_like(per))
        return per.sum() / torch.clamp(valid.float().sum(), min=1.0)

    @staticmethod
    def recon_error(pred, target, mask) -> torch.Tensor:
        err = torch.square(pred - target).sum(-1)
        err = torch.where(mask, err, torch.zeros_like(err))
        return err.sum() / torch.clamp(mask.float().sum(), min=1.0)

    def loss(self, p: dict, batch: dict) -> torch.Tensor:
        """The training objective of one padded batch (a dict of tensors:
        frames, frame_len, clip_len, words, word_len, sent_len, ids,
        valid)."""
        lc = self.loss_cfg
        video, clips = self.encode_video(p, batch["frames"],
                                         batch["frame_len"],
                                         batch["clip_len"])
        para, sents = self.encode_text(p, batch["words"], batch["word_len"],
                                       batch["sent_len"])
        ids, valid = batch["ids"], batch["valid"]
        b, c, e = clips.shape
        slots = torch.arange(c, device=ids.device)
        clip_valid = (slots[None, :] < batch["clip_len"][:, None]) & \
            valid[:, None]
        sent_valid = (slots[None, :] < batch["sent_len"][:, None]) & \
            valid[:, None]
        total = video.new_zeros(())
        hw = float(lc.get("high_weight", 1.0))
        if hw:
            pos = ids[:, None] == ids[None, :]
            total = total + hw * self.hinge(video, para, pos, valid)
        lw = float(lc.get("low_weight", 1.0))
        if lw:
            pair = (ids[:, None] * c + slots[None, :]).reshape(-1)
            pos = pair[:, None] == pair[None, :]
            low_valid = (clip_valid & sent_valid).reshape(-1)
            total = total + lw * self.hinge(clips.reshape(b * c, e),
                                            sents.reshape(b * c, e), pos,
                                            low_valid)
        rw = float(lc.get("recon_weight", 0.0))
        if rw and self.m.get("reconstruction"):
            v_rec = self.decode(p, "video_decoder", video, clips,
                                batch["clip_len"])
            t_rec = self.decode(p, "text_decoder", para, sents,
                                batch["sent_len"])
            total = total + rw * (self.recon_error(v_rec, clips, clip_valid)
                                  + self.recon_error(t_rec, sents,
                                                     sent_valid))
        return total


class AdamState:
    """Adam with bias correction and eps outside the square root (the
    original paper's form), after a clip of the global gradient norm:
    ``g * max_norm / norm`` where ``norm >= max_norm``."""

    def __init__(self, params: dict, lr: float, grad_clip: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 moments: tuple | None = None) -> None:
        self.lr, self.clip, self.betas, self.eps = lr, grad_clip, betas, eps
        if moments is None:
            self.m = {k: torch.zeros_like(v) for k, v in params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in params.items()}
            self.t = 0
        else:
            m, v, self.t = moments
            self.m = {k: m[k].detach().clone() for k in params}
            self.v = {k: v[k].detach().clone() for k in params}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place; returns the clipped gradients."""
        norm = math.sqrt(sum(float(torch.sum(g.double() * g.double()))
                             for g in grads.values()))
        scale = self.clip / norm if norm >= self.clip else 1.0
        b1, b2 = self.betas
        self.t += 1
        clipped = {}
        for k, p in params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))
        return clipped


def train_steps(ref: Reference, params: dict, batches: list, lr: float,
                grad_clip: float, moments: tuple | None = None) -> dict:
    """Run the objective, its gradients, the clip and Adam over ``batches``
    in order, from ``params`` (copied, not changed) and Adam's ``moments``
    (first, second, steps taken; a fresh Adam without). Returns each step's
    loss, the per-leaf norm of the first step's clipped gradient, and the
    per-leaf norm of the parameters' change after the last step."""
    start = {k: v.detach().clone() for k, v in params.items()}
    live = {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}
    opt = AdamState(live, lr, grad_clip, moments=moments)
    losses, first_grad = [], None
    for batch in batches:
        for v in live.values():
            v.grad = None
        loss = ref.loss(live, batch)
        loss.backward()
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in live.items()}
        losses.append(float(loss.detach()))
        clipped = opt.step(live, grads)
        if first_grad is None:
            first_grad = {k: float(torch.linalg.vector_norm(g.double()))
                          for k, g in clipped.items()}
    change = {k: float(torch.linalg.vector_norm(
        (live[k].detach() - start[k]).double())) for k in live}
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change}
