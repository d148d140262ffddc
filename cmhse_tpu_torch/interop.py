"""Move weights between the JAX package's ``CMHSE``, the reference's PyTorch
checkpoints and the port.

The port names its submodules and parameters after the JAX params tree
(``word_embedding.embedding``, ``video_low.gru.fwd_w_i``,
``video_low.attn_pool.proj``, ``video_decoder.init``, ...), so the only
change between a JAX tree and the port's ``state_dict`` is one transpose per
Dense kernel: flax stores ``kernel [in, out]``, ``nn.Linear`` stores
``weight [out, in]`` (:func:`params_from_jax`, :func:`params_to_jax_tree`).
GRU weights, the decoders' ``w_i``/``w_h``/``b_i``/``b_h`` included, keep
the JAX layout as they are.

The reference saved ``torch.save({'model': state_dict, ...})`` files whose
tensors follow torch's layouts: fused GRU weights ``weight_ih_l0`` /
``weight_hh_l0`` of shape ``[3H, D]`` with gate order (r, z, n) (the JAX
``w_i``/``w_h`` are their transposes, same gate order) and ``nn.Linear``
weights ``[out, in]``. The functions from :func:`gru_params_from_torch` to
:func:`state_dict_from_model_params` are the port's numpy copies of
``cmhse_tpu/interop.py``'s: a reference state dict -> a JAX-layout tree of
numpy arrays -> :func:`params_from_jax`, and back. Transposes only, so a
round trip returns every tensor bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def refuse_text_tower(names) -> None:
    """Raise for a model whose sentence encoder is a text tower: the JAX
    package and the reference's layout have no such encoder."""
    if any(str(n).split(".")[0] == "text_tower" for n in names):
        raise NotImplementedError(
            "a model with a text tower (text_tower.*) has no JAX or "
            "reference-layout counterpart: export, import and serving take "
            "the GRU sentence encoder only")


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``CMHSE`` params tree -> the port's ``state_dict``, every module
    included (the reconstruction decoders too).

    ``params``: the tree flax ``init`` returns (``variables["params"]``),
    leaves converted with ``np.asarray``.
    """
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            key = f"{prefix}{name}"
            if isinstance(value, Mapping):
                walk(value, key + ".")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(
                    np.array(arr.T, order="C"))
            else:
                out[key] = torch.from_numpy(np.array(arr))

    walk(params, "")
    return out


def params_to_jax_tree(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_jax`: the port's ``state_dict`` ->
    a nested JAX-layout tree of float32 numpy arrays (every ``weight`` back
    to a ``kernel`` by transpose). A text tower's model is refused."""
    refuse_text_tower(state_dict)
    tree: dict = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        arr = value.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node[name] = np.array(arr)
    return tree


def gru_params_from_torch(
    weight_ih: np.ndarray,
    weight_hh: np.ndarray,
    bias_ih: np.ndarray,
    bias_hh: np.ndarray,
    direction: str = "fwd",
) -> dict:
    """Torch fused GRU tensors -> a masked GRU's param dict.

    ``weight_ih``/``weight_hh``: ``[3H, D]`` / ``[3H, H]`` (gate order r,z,n).
    ``direction``: "fwd" or "bwd" (bidirectional reverse weights).
    """
    return {
        f"{direction}_w_i": np.ascontiguousarray(weight_ih.T),
        f"{direction}_w_h": np.ascontiguousarray(weight_hh.T),
        f"{direction}_b_i": np.asarray(bias_ih),
        f"{direction}_b_h": np.asarray(bias_hh),
    }


def dense_params_from_torch(
    weight: np.ndarray, bias: np.ndarray | None = None
) -> dict:
    """Torch ``nn.Linear`` (weight ``[out, in]``) -> Dense params."""
    out = {"kernel": np.ascontiguousarray(weight.T)}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def embedding_params_from_torch(weight: np.ndarray) -> dict:
    """Torch ``nn.Embedding`` -> word-embedding params (same layout)."""
    return {"embedding": np.asarray(weight)}


def sequence_encoder_params_from_torch(
    gru_tensors: dict,
    proj: tuple[np.ndarray, np.ndarray] | None = None,
    attn_proj: tuple[np.ndarray, np.ndarray] | None = None,
    attn_score: np.ndarray | None = None,
) -> dict:
    """Assemble one sequence encoder's params from torch tensors.

    ``gru_tensors``: the keys an ``nn.GRU`` contributes to a state_dict,
    ``weight_ih_l0``/``weight_hh_l0``/``bias_ih_l0``/``bias_hh_l0`` (plus
    ``*_reverse`` when bidirectional). ``proj``: (weight, bias) of the
    joint-space Linear, present only when rnn_hidden != embed_size.
    ``attn_proj``/``attn_score``: attention-pool tensors.
    """
    gru = gru_params_from_torch(
        gru_tensors["weight_ih_l0"], gru_tensors["weight_hh_l0"],
        gru_tensors["bias_ih_l0"], gru_tensors["bias_hh_l0"],
    )
    if "weight_ih_l0_reverse" in gru_tensors:
        gru.update(gru_params_from_torch(
            gru_tensors["weight_ih_l0_reverse"],
            gru_tensors["weight_hh_l0_reverse"],
            gru_tensors["bias_ih_l0_reverse"],
            gru_tensors["bias_hh_l0_reverse"],
            direction="bwd",
        ))
    params: dict = {"gru": gru}
    if proj is not None:
        params["proj"] = dense_params_from_torch(*proj)
    if attn_proj is not None:
        params["attn_pool"] = {
            "proj": dense_params_from_torch(*attn_proj),
            "score": dense_params_from_torch(attn_score),
        }
    return params


def recon_decoder_params_from_torch(
    init: tuple[np.ndarray, np.ndarray],
    gru_tensors: dict,
    out: tuple[np.ndarray, np.ndarray],
) -> dict:
    """Assemble a reconstruction decoder's params from torch tensors
    (``init`` Linear, teacher-forcing GRU, ``out`` Linear)."""
    flat = gru_params_from_torch(
        gru_tensors["weight_ih_l0"], gru_tensors["weight_hh_l0"],
        gru_tensors["bias_ih_l0"], gru_tensors["bias_hh_l0"],
    )
    return {
        "init": dense_params_from_torch(*init),
        "w_i": flat["fwd_w_i"],
        "w_h": flat["fwd_w_h"],
        "b_i": flat["fwd_b_i"],
        "b_h": flat["fwd_b_h"],
        "out": dense_params_from_torch(*out),
    }


def _pop_required(sd: dict, key: str, module: str):
    """``sd.pop`` with an error naming the module's actual keys, so a
    checkpoint with other module names fails with guidance."""
    try:
        return sd.pop(key)
    except KeyError:
        near = sorted(k for k in sd if k.startswith(module + "."))
        raise ValueError(
            f"state_dict is missing required tensor {key!r}; keys present "
            f"under {module!r}: {near or '(none)'} — check --prefix_map "
            "against the documented replica naming (MIGRATION.md)"
        ) from None


def _encoder_from_flat(sd: dict, prefix: str) -> dict:
    """One sequence encoder's params from flat ``{prefix}.gru.*`` /
    ``{prefix}.proj.*`` / ``{prefix}.attn_*`` state_dict keys."""
    base = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")
    gru = {k: _pop_required(sd, f"{prefix}.gru.{k}", prefix) for k in base}
    if f"{prefix}.gru.weight_ih_l0_reverse" in sd:
        gru.update({
            k: _pop_required(sd, f"{prefix}.gru.{k}", prefix)
            for k in ("weight_ih_l0_reverse", "weight_hh_l0_reverse",
                      "bias_ih_l0_reverse", "bias_hh_l0_reverse")
        })
    proj = None
    if f"{prefix}.proj.weight" in sd:
        proj = (sd.pop(f"{prefix}.proj.weight"),
                _pop_required(sd, f"{prefix}.proj.bias", prefix))
    attn_proj = attn_score = None
    if f"{prefix}.attn_proj.weight" in sd:
        attn_proj = (sd.pop(f"{prefix}.attn_proj.weight"),
                     _pop_required(sd, f"{prefix}.attn_proj.bias", prefix))
        attn_score = _pop_required(sd, f"{prefix}.attn_score.weight", prefix)
    return sequence_encoder_params_from_torch(gru, proj, attn_proj,
                                              attn_score)


def _decoder_from_flat(sd: dict, prefix: str) -> dict:
    gru = {k: _pop_required(sd, f"{prefix}.gru.{k}", prefix)
           for k in ("weight_ih_l0", "weight_hh_l0",
                     "bias_ih_l0", "bias_hh_l0")}
    return recon_decoder_params_from_torch(
        (_pop_required(sd, f"{prefix}.init.weight", prefix),
         _pop_required(sd, f"{prefix}.init.bias", prefix)),
        gru,
        (_pop_required(sd, f"{prefix}.out.weight", prefix),
         _pop_required(sd, f"{prefix}.out.bias", prefix)),
    )


# component -> the torch module prefix it loads from, the naming of
# tests/torch_replica.py and MIGRATION.md; ``prefix_map`` overrides it
DEFAULT_PREFIX_MAP = {
    "word_embedding": "embedding",
    "video_low": "video_low",
    "text_low": "text_low",
    "video_high": "video_high",
    "text_high": "text_high",
    "video_decoder": "video_decoder",
    "text_decoder": "text_decoder",
}


def _prefixes(prefix_map: dict | None) -> dict:
    pm = dict(DEFAULT_PREFIX_MAP)
    if prefix_map:
        pm.update(prefix_map)
    return pm


def infer_model_structure(state_dict: dict,
                          prefix_map: dict | None = None) -> dict:
    """The model hyperparameters a state_dict implies: ``vocab_size`` plus
    the matching ModelConfig fields. vocab/word_dim come from the embedding
    table, feat_dim and rnn_hidden from the low video GRU's ``[3H, D]``
    input weights, embed_size from the joint projection (without one: the
    GRU's output width, 2H when bidirectional), the structure flags from
    which keys exist. The GRU readout ('last' or 'mean') has no parameters
    and cannot be inferred."""
    refuse_text_tower(state_dict)
    pm = _prefixes(prefix_map)
    emb = _pop_required(dict(state_dict), f"{pm['word_embedding']}.weight",
                        pm["word_embedding"])
    w_ih = _pop_required(dict(state_dict),
                         f"{pm['video_low']}.gru.weight_ih_l0",
                         pm["video_low"])
    hidden, feat_dim = w_ih.shape[0] // 3, w_ih.shape[1]
    bidirectional = (
        f"{pm['video_low']}.gru.weight_ih_l0_reverse" in state_dict
    )
    proj_key = f"{pm['video_low']}.proj.weight"
    if proj_key in state_dict:
        embed = state_dict[proj_key].shape[0]
    else:
        embed = hidden * (2 if bidirectional else 1)
    return {
        "vocab_size": int(emb.shape[0]),
        "word_dim": int(emb.shape[1]),
        "feat_dim": int(feat_dim),
        "rnn_hidden": int(hidden),
        "embed_size": int(embed),
        "hierarchical": f"{pm['video_high']}.gru.weight_ih_l0" in state_dict,
        "attention_pool": f"{pm['video_low']}.attn_proj.weight" in state_dict,
        "reconstruction": f"{pm['video_decoder']}.gru.weight_ih_l0"
                          in state_dict,
        "bidirectional": bidirectional,
    }


def model_params_from_state_dict(
    state_dict: dict,
    hierarchical: bool = True,
    reconstruction: bool = False,
    prefix_map: dict | None = None,
    strict: bool = True,
) -> dict:
    """A reference-style flat ``state_dict`` (dotted names -> numpy arrays)
    -> a JAX-layout params tree of numpy arrays. ``hierarchical`` /
    ``reconstruction``: which submodules to expect (attention-pool tensors
    are found from the keys). ``strict``: raise if a checkpoint tensor goes
    unconsumed, which catches a misspelled prefix."""
    pm = _prefixes(prefix_map)
    sd = dict(state_dict)  # consumed to track leftovers
    params: dict = {
        "word_embedding": embedding_params_from_torch(
            _pop_required(sd, f"{pm['word_embedding']}.weight",
                          pm["word_embedding"])
        ),
        "video_low": _encoder_from_flat(sd, pm["video_low"]),
        "text_low": _encoder_from_flat(sd, pm["text_low"]),
    }
    if hierarchical:
        params["video_high"] = _encoder_from_flat(sd, pm["video_high"])
        params["text_high"] = _encoder_from_flat(sd, pm["text_high"])
    if reconstruction:
        params["video_decoder"] = _decoder_from_flat(sd, pm["video_decoder"])
        params["text_decoder"] = _decoder_from_flat(sd, pm["text_decoder"])
    if strict and sd:
        raise ValueError(
            f"{len(sd)} checkpoint tensors not consumed by the import "
            f"(wrong prefix_map or model flags?): {sorted(sd)[:8]}..."
        )
    return params


def _f32(a) -> np.ndarray:
    arr = np.asarray(a)
    return arr.astype(np.float32) if np.issubdtype(arr.dtype,
                                                   np.floating) else arr


def _gru_to_torch(gru: dict) -> dict:
    """Inverse of :func:`gru_params_from_torch` (both directions present)."""
    out = {}
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        if f"{direction}_w_i" not in gru:
            continue
        out[f"weight_ih_l0{suffix}"] = np.ascontiguousarray(
            _f32(gru[f"{direction}_w_i"]).T)
        out[f"weight_hh_l0{suffix}"] = np.ascontiguousarray(
            _f32(gru[f"{direction}_w_h"]).T)
        out[f"bias_ih_l0{suffix}"] = _f32(gru[f"{direction}_b_i"])
        out[f"bias_hh_l0{suffix}"] = _f32(gru[f"{direction}_b_h"])
    return out


def _dense_to_torch(dense: dict) -> dict:
    """Inverse of :func:`dense_params_from_torch`."""
    out = {"weight": np.ascontiguousarray(_f32(dense["kernel"]).T)}
    if "bias" in dense:
        out["bias"] = _f32(dense["bias"])
    return out


def _encoder_to_flat(enc: dict, prefix: str, out: dict) -> None:
    """Inverse of :func:`_encoder_from_flat`."""
    for k, v in _gru_to_torch(enc["gru"]).items():
        out[f"{prefix}.gru.{k}"] = v
    if "proj" in enc:
        for k, v in _dense_to_torch(enc["proj"]).items():
            out[f"{prefix}.proj.{k}"] = v
    if "attn_pool" in enc:
        for k, v in _dense_to_torch(enc["attn_pool"]["proj"]).items():
            out[f"{prefix}.attn_proj.{k}"] = v
        for k, v in _dense_to_torch(enc["attn_pool"]["score"]).items():
            out[f"{prefix}.attn_score.{k}"] = v


def _decoder_to_flat(dec: dict, prefix: str, out: dict) -> None:
    """Inverse of :func:`_decoder_from_flat`."""
    for k, v in _dense_to_torch(dec["init"]).items():
        out[f"{prefix}.init.{k}"] = v
    gru = {"fwd_w_i": dec["w_i"], "fwd_w_h": dec["w_h"],
           "fwd_b_i": dec["b_i"], "fwd_b_h": dec["b_h"]}
    for k, v in _gru_to_torch(gru).items():
        out[f"{prefix}.gru.{k}"] = v
    for k, v in _dense_to_torch(dec["out"]).items():
        out[f"{prefix}.out.{k}"] = v


def state_dict_from_model_params(
    params: dict, prefix_map: dict | None = None
) -> dict:
    """A JAX-layout params tree -> a flat reference-style state_dict of
    contiguous float32 numpy arrays, the exact inverse of
    :func:`model_params_from_state_dict`. Which submodules exist is read
    off the tree (``video_high``: hierarchical; ``video_decoder``:
    reconstruction; a ``bwd_w_i``: ``*_reverse`` keys)."""
    pm = _prefixes(prefix_map)
    sd: dict = {
        f"{pm['word_embedding']}.weight":
            _f32(params["word_embedding"]["embedding"]),
    }
    _encoder_to_flat(params["video_low"], pm["video_low"], sd)
    _encoder_to_flat(params["text_low"], pm["text_low"], sd)
    if "video_high" in params:
        _encoder_to_flat(params["video_high"], pm["video_high"], sd)
        _encoder_to_flat(params["text_high"], pm["text_high"], sd)
    if "video_decoder" in params:
        _decoder_to_flat(params["video_decoder"], pm["video_decoder"], sd)
        _decoder_to_flat(params["text_decoder"], pm["text_decoder"], sd)
    return sd
