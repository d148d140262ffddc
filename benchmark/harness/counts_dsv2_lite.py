"""The yardstick's arithmetic for CMHSE with a DeepSeek-V2 decoder stack as
its sentence encoder: the forward FLOPs of the matrix products, counted over
live tokens (padded slots count nothing), and the routed experts' least
time.

The stack, a live token of each layer: MLA's four projections (``W_q``,
``W_kva``, ``W_kvb``, ``W_o``), then the dense SwiGLU MLP (the first
``first_k_dense_replace`` layers) or the router and the shared experts'
MLP. Attention's two products, over each sentence's causal live pairs
(``len (len + 1) / 2`` a head). Each assignment of a live token to a held
expert: that expert's MLP, ``6 D I`` (gate and up, then down); how many
there are is the program's ``moe.assignments`` counter, since routing
decides it. The readout: the attention pool over live tokens and the
projection of each live sentence. The rest of CMHSE as ``harness/counts.py``
counts it, less ``text_low``'s GRU and pool, which the stack replaces.
Training is three times the forward.
"""

from __future__ import annotations

import numpy as np

from harness import counts


def expert_flops(t: dict) -> float:
    """Forward FLOPs of one routed expert on one token."""
    return 6.0 * t["hidden_size"] * t["moe_intermediate_size"]


def _attention_proj_flops(t: dict) -> float:
    d, h = t["hidden_size"], t["num_attention_heads"]
    nope, rope, vd = (t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                      t["v_head_dim"])
    rank = t["kv_lora_rank"]
    return 2.0 * (d * h * (nope + rope) + d * (rank + rope)
                  + rank * h * (nope + vd) + h * vd * d)


def tower_token_flops(t: dict) -> float:
    """Forward FLOPs a live token takes in the stack's products other than
    attention's core and the routed experts."""
    d = t["hidden_size"]
    dense = t["first_k_dense_replace"]
    moe = t["num_hidden_layers"] - dense
    per_dense = _attention_proj_flops(t) + 6.0 * d * t["intermediate_size"]
    per_moe = (_attention_proj_flops(t) + 2.0 * d * t["routed_experts"]
               + 6.0 * d * t["moe_intermediate_size"] * t["n_shared_experts"])
    return dense * per_dense + moe * per_moe


def attention_flops(t: dict, word_len: np.ndarray) -> float:
    """Forward FLOPs of attention's two products over the causal live pairs
    of every sentence, all layers."""
    lens = np.asarray(word_len, np.float64).reshape(-1)
    pairs = float(np.sum(lens * (lens + 1) / 2))
    h = t["num_attention_heads"]
    per_pair = 2.0 * h * (t["qk_nope_head_dim"] + t["qk_rope_head_dim"]
                          + t["v_head_dim"])
    return t["num_hidden_layers"] * pairs * per_pair


def step_flops(lengths: dict, model: dict, t: dict) -> float:
    """Training FLOPs of one step without the routed experts: the stack's
    token products, attention, the readout and the rest of CMHSE, forward
    times 3."""
    wl = np.asarray(lengths["word_len"])
    live = int(wl.sum())
    d, e = t["hidden_size"], model["embed_size"]
    attn = t["attn_dim"]
    f = live * tower_token_flops(t) + attention_flops(t, wl)
    f += live * (2.0 * d * attn + 2.0 * attn)  # the readout pool
    f += int(np.count_nonzero(wl)) * 2.0 * d * e  # the projection
    rest = counts.train_step_flops(lengths, model) / 3.0
    rest -= counts._gru_flops(live, model["word_dim"], model["rnn_hidden"])
    if model.get("attention_pool"):
        rest -= counts._pool_flops(live, model["rnn_hidden"])
    return 3.0 * (f + rest)


def routed_flops(t: dict, assignments: int) -> float:
    """Training FLOPs of the routed experts over ``assignments``."""
    return 3.0 * assignments * expert_flops(t)


def routed_bound_s(t: dict, assignments: int, steps: int) -> float:
    """Least time of the routed experts' grouped products over ``steps``
    training steps with ``assignments`` in all: their FLOPs at the f32 peak,
    or the bytes at the memory's bandwidth (each held expert's weights read
    in the forward and the backward and its gradient written, a step; each
    assignment's rows written and read once: the token's row in, the
    gate/up rows out and back, the output row out, and the same backward)."""
    d, width = t["hidden_size"], t["moe_intermediate_size"]
    layers = t["num_hidden_layers"] - t["first_k_dense_replace"]
    weights = layers * t["experts_held"] * 3.0 * d * width
    rows = 2.0 * (2.0 * d + 3.0 * width)
    nbytes = 4.0 * (3.0 * weights * steps + assignments * rows)
    return counts.bound_s(routed_flops(t, assignments), nbytes)
