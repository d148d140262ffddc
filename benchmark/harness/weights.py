"""The model's weights, made by the benchmark from the seed: one draw on
the device for all of them, scaled leaf by leaf. The same seed gives the
same weights on the same device; both the program and the reference are
handed these tensors."""

from __future__ import annotations

import math

import torch


def parameter_shapes(model: dict, vocab_size: int) -> dict:
    """name -> (shape, half-width of its uniform draw, or 0 for zeros), from
    the configuration's sizes: GRUs ``U(+-1/sqrt(H))``, dense kernels with
    variance ``1/fan_in``, dense biases zero, the word table ``U(+-0.1)``."""
    e, h, w = model["embed_size"], model["rnn_hidden"], model["word_dim"]
    attn = bool(model.get("attention_pool"))
    if model.get("bidirectional"):
        raise ValueError("the benchmark's configurations are one-directional")
    out = {"word_embedding.embedding": ((vocab_size, w), 0.1)}

    def gru(prefix, d):
        g = 1.0 / math.sqrt(h)
        out[f"{prefix}w_i"] = ((d, 3 * h), g)
        out[f"{prefix}w_h"] = ((h, 3 * h), g)
        out[f"{prefix}b_i"] = ((3 * h,), g)
        out[f"{prefix}b_h"] = ((3 * h,), g)

    def dense(prefix, d_in, d_out, bias=True):
        out[f"{prefix}.weight"] = ((d_out, d_in), math.sqrt(3.0 / d_in))
        if bias:
            out[f"{prefix}.bias"] = ((d_out,), 0.0)

    def stage(prefix, d):
        gru(f"{prefix}.gru.fwd_", d)
        if attn:
            dense(f"{prefix}.attn_pool.proj", h, 256)
            dense(f"{prefix}.attn_pool.score", 256, 1, bias=False)
        if h != e:
            dense(f"{prefix}.proj", h, e)

    stage("video_low", model["feat_dim"])
    stage("text_low", w)
    if model.get("hierarchical", True):
        stage("video_high", e)
        stage("text_high", e)
    if model.get("reconstruction"):
        for side in ("video_decoder", "text_decoder"):
            gru(f"{side}.", e)
            dense(f"{side}.init", e, h)
            dense(f"{side}.out", h, e)
    return out


def make_weights(model: dict, vocab_size: int, seed: int,
                 device) -> dict:
    """The weights as float32 tensors on ``device``, from ``seed``."""
    shapes = parameter_shapes(model, vocab_size)
    total = sum(math.prod(s) for s, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, (shape, half) in shapes.items():
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * half).reshape(shape)
        at += n
    return out
