"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes the work needs, counted from the live lengths of the
inputs (padded steps and padded rows count nothing).

``gru_bound_s`` is the GRU kernels' roofline of ``chip_smoke.py``
(``gru_bounds``): the recurrent product's FLOPs over live row-steps, each
input read and each output written once. ``train_step_flops`` is the matrix
products of ``cmhse_tpu_torch/cli/bench.py``'s
``analytic_encode_flops_per_pair``, counted over live steps instead of the
padded caps, with the decoders and the two ranking products added.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAKS = {
    "f32": 67e12,  # FLOP/s, float32 outside the tensor cores
    "hbm_bytes": 3.35e12,  # bytes/s
}
ATTN_DIM = 256


def bound_s(ops: float, nbytes: float, peak: str = "f32") -> float:
    """Least time: the larger of operations at the peak of their type and
    bytes at the memory's bandwidth."""
    return max(ops / PEAKS[peak], nbytes / PEAKS["hbm_bytes"])


def gru_bound_s(b: int, t: int, h: int, live: int, gates: bool = False,
                seeded: bool = False, backward: bool = False) -> float:
    """Least time of one f32 ``gru_fwd`` (``backward=False``) or ``gru_bwd``
    call over ``b`` rows of ``t`` steps with ``live`` live row-steps."""
    flops = 2.0 * live * h * 3 * h
    if not backward:
        streams = (live * 3 * h + h * 3 * h + b * t * h + b * h
                   + (live * 4 * h if gates else 0)
                   + (b * h if seeded else 0))
        words = 3 * h + b
    else:
        streams = (live * 5 * h + b * t * h + b * h + 3 * h * h
                   + (b * h if seeded else 0) + b * t * 4 * h + b * h)
        words = b + 4 * h
    return bound_s(flops, 4.0 * streams + 4.0 * words)


def gru_calls(lengths: dict, model: dict) -> list:
    """The GRU calls of one training step of a batch with these lengths:
    ``(rows, steps, live row-steps, seeded)`` for each recurrence, each run
    once forward (gate-saving) and once backward.

    ``lengths``: ``frame_len [B, C]``, ``word_len [B, S]``, ``clip_len
    [B]``, ``sent_len [B]`` (zero on padding rows), padded to the batch's
    bucket ``frames`` x ``words``."""
    fl, wl = lengths["frame_len"], lengths["word_len"]
    cl, sl = lengths["clip_len"], lengths["sent_len"]
    b, c = fl.shape
    s = wl.shape[1]
    calls = [(b * c, lengths["frames"], int(fl.sum()), False),
             (b * s, lengths["words"], int(wl.sum()), False)]
    if model.get("hierarchical", True):
        calls += [(b, c, int(cl.sum()), False), (b, s, int(sl.sum()), False)]
    if model.get("reconstruction"):
        calls += [(b, c, int(cl.sum()), True), (b, s, int(sl.sum()), True)]
    return calls


def gru_step_bounds(lengths: dict, model: dict) -> tuple[float, float]:
    """(forward, backward) least seconds of one step's GRU kernels."""
    h = model["rnn_hidden"]
    fwd = bwd = 0.0
    for rows, steps, live, seeded in gru_calls(lengths, model):
        fwd += gru_bound_s(rows, steps, h, live, gates=True, seeded=seeded)
        bwd += gru_bound_s(rows, steps, h, live, seeded=seeded,
                           backward=True)
    return fwd, bwd


def _gru_flops(live: int, d: int, h: int) -> float:
    """Input projection and recurrent product over live row-steps."""
    return 2.0 * live * 3 * h * (d + h)


def _pool_flops(live: int, h: int) -> float:
    return live * (2.0 * h * ATTN_DIM + 2.0 * ATTN_DIM)


def encode_text_flops(word_len: np.ndarray, sent_len: np.ndarray,
                      model: dict) -> float:
    """Forward FLOPs of the text encoder over live steps: words ->
    sentences -> paragraphs."""
    e, h, w = model["embed_size"], model["rnn_hidden"], model["word_dim"]
    attn = bool(model.get("attention_pool"))
    lw, ls = int(np.sum(word_len)), int(np.sum(sent_len))
    f = _gru_flops(lw, w, h) + (_pool_flops(lw, h) if attn else 0.0)
    if model.get("hierarchical", True):
        f += _gru_flops(ls, e, h) + (_pool_flops(ls, h) if attn else 0.0)
    return f


def encode_video_flops(frame_len: np.ndarray, clip_len: np.ndarray,
                       model: dict) -> float:
    e, h, d = model["embed_size"], model["rnn_hidden"], model["feat_dim"]
    attn = bool(model.get("attention_pool"))
    lf, lc = int(np.sum(frame_len)), int(np.sum(clip_len))
    f = _gru_flops(lf, d, h) + (_pool_flops(lf, h) if attn else 0.0)
    if model.get("hierarchical", True):
        f += _gru_flops(lc, e, h) + (_pool_flops(lc, h) if attn else 0.0)
    return f


def train_step_flops(lengths: dict, model: dict) -> float:
    """Model FLOPs of one training step: the forward's matrix products over
    live steps (encoders, attention pools, decoders, both ranking
    products), times 3 for the backward."""
    e, h = model["embed_size"], model["rnn_hidden"]
    fl, wl = lengths["frame_len"], lengths["word_len"]
    cl, sl = lengths["clip_len"], lengths["sent_len"]
    valid = int(np.count_nonzero(lengths["valid"]))
    f = (encode_video_flops(fl, cl, model)
         + encode_text_flops(wl, sl, model))
    if model.get("reconstruction"):
        for live in (int(cl.sum()), int(sl.sum())):
            f += 2.0 * valid * e * h  # init
            f += _gru_flops(live, e, h) + 2.0 * live * h * e  # GRU, out
    f += 2.0 * valid * valid * e  # video x paragraph similarities
    c = fl.shape[1]
    slots = np.arange(c)[None, :]
    low = int(np.count_nonzero((slots < cl[:, None]) & (slots < sl[:, None])))
    f += 2.0 * low * low * e  # clip x sentence similarities
    return 3.0 * f


def padded_steps(lengths: dict) -> tuple[int, int]:
    """(padded frame- and word-steps of the batch, those that carry
    data)."""
    fl, wl = lengths["frame_len"], lengths["word_len"]
    total = fl.size * lengths["frames"] + wl.size * lengths["words"]
    return int(total), int(fl.sum() + wl.sum())

