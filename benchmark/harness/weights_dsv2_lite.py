"""The weights of CMHSE with a DeepSeek-V2 decoder stack as its sentence
encoder, made by the benchmark from the seed: one draw on the device for
all of them, scaled leaf by leaf, as ``harness/weights.py`` makes CMHSE's.
The same seed gives the same weights on the same device; the program and
the reference are both handed these tensors.

The stack: every kernel and the embedding uniform with standard deviation
``initializer_range`` (0.02: half-width 0.02 * sqrt(3)), RMSNorm weights
one. The rest of CMHSE (the video side, ``text_high``, the decoders, the
stack's readout pool and projection) follows ``harness/weights.py``'s
rules; the GRU sentence encoder and its word table are not there.
"""

from __future__ import annotations

import math

import torch

from harness import weights as cmhse_weights

ONES = None  # an RMSNorm weight: ones, no draw


# the port's TextTowerConfig fields that the published config names alike
SAME_KEYS = ("hidden_size", "num_hidden_layers", "first_k_dense_replace",
             "intermediate_size", "num_attention_heads", "kv_lora_rank",
             "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
             "num_experts_per_tok", "moe_intermediate_size",
             "n_shared_experts", "routed_scaling_factor", "norm_topk_prob",
             "rms_norm_eps", "rope_theta", "initializer_range")


def tower_settings(config: dict) -> dict:
    """The port's ``TextTowerConfig`` fields, made from the configuration's
    top-level keys (the published config's, with the cuts ``reduced``
    names): ``n_routed_experts`` counts the experts held here, from
    ``expert_offset``; the router's width is the published count."""
    rs = config["rope_scaling"]
    out = {k: config[k] for k in SAME_KEYS}
    out.update(routed_experts=config["published"]["n_routed_experts"],
               experts_held=config["n_routed_experts"],
               expert_offset=config["expert_offset"],
               rope_factor=rs["factor"], rope_mscale=rs["mscale"],
               rope_mscale_all_dim=rs["mscale_all_dim"],
               rope_beta_fast=rs["beta_fast"], rope_beta_slow=rs["beta_slow"],
               rope_original_max_position=rs[
                   "original_max_position_embeddings"],
               attn_dim=config["attn_dim"])
    return out


def tower_shapes(t: dict, vocab_size: int, embed_size: int) -> dict:
    """name -> (shape, half-width of its uniform draw, or ONES) of the
    stack and its readout."""
    d, std = t["hidden_size"], t["initializer_range"]
    half = std * math.sqrt(3.0)
    h = t["num_attention_heads"]
    nope, rope, vd = (t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                      t["v_head_dim"])
    rank = t["kv_lora_rank"]
    out = {"text_tower.embed": ((vocab_size, d), half),
           "text_tower.norm": ((d,), ONES)}
    for i in range(t["num_hidden_layers"]):
        pre = f"text_tower.layers.{i}."
        out[f"{pre}attn_norm"] = ((d,), ONES)
        out[f"{pre}ffn_norm"] = ((d,), ONES)
        out[f"{pre}attn.w_q"] = ((d, h * (nope + rope)), half)
        out[f"{pre}attn.w_kva"] = ((d, rank + rope), half)
        out[f"{pre}attn.kv_norm"] = ((rank,), ONES)
        out[f"{pre}attn.w_kvb"] = ((rank, h * (nope + vd)), half)
        out[f"{pre}attn.w_o"] = ((h * vd, d), half)
        if i < t["first_k_dense_replace"]:
            width = t["intermediate_size"]
            out[f"{pre}ffn.w_gu"] = ((d, 2 * width), half)
            out[f"{pre}ffn.w_down"] = ((width, d), half)
            continue
        width = t["moe_intermediate_size"]
        shared = width * t["n_shared_experts"]
        held = t["experts_held"]
        out[f"{pre}ffn.router"] = ((d, t["routed_experts"]), half)
        out[f"{pre}ffn.shared.w_gu"] = ((d, 2 * shared), half)
        out[f"{pre}ffn.shared.w_down"] = ((shared, d), half)
        out[f"{pre}ffn.experts_gu"] = ((held, d, 2 * width), half)
        out[f"{pre}ffn.experts_down"] = ((held, width, d), half)
    attn = t["attn_dim"]  # the readout pool's width, as CMHSE's
    out["text_tower.pool.proj.weight"] = ((attn, d), math.sqrt(3.0 / d))
    out["text_tower.pool.proj.bias"] = ((attn,), 0.0)
    out["text_tower.pool.score.weight"] = ((1, attn), math.sqrt(3.0 / attn))
    out["text_tower.proj.weight"] = ((embed_size, d), math.sqrt(3.0 / d))
    out["text_tower.proj.bias"] = ((embed_size,), 0.0)
    return out


def parameter_shapes(config: dict) -> dict:
    """Every parameter of the model: CMHSE's without ``word_embedding`` and
    ``text_low``, and the stack's (``config["text_tower"]``, the settings
    :func:`tower_settings` gives, which the runner lays over the file's)."""
    model, vocab = config["model"], config["data"]["vocab_size"]
    out = {k: v for k, v in
           cmhse_weights.parameter_shapes(model, vocab).items()
           if not k.startswith(("word_embedding.", "text_low."))}
    out.update(tower_shapes(config["text_tower"], vocab,
                            model["embed_size"]))
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """The weights as float32 tensors on ``device``, from ``seed``."""
    shapes = parameter_shapes(config)
    drawn = {k: v for k, v in shapes.items() if v[1] is not ONES}
    total = sum(math.prod(s) for s, _ in drawn.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, (shape, half) in shapes.items():
        if half is ONES:
            out[name] = torch.ones(shape, device=device)
            continue
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * half).reshape(shape)
        at += n
    del flat
    return out
