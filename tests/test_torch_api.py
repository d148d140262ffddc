"""The port's package-level names against the JAX package's: code that swaps
``cmhse_tpu`` for ``cmhse_tpu_torch`` in an import finds every name the JAX
package exports, less a JAX-only list, and each shared callable takes the
same parameters, less a list of deliberate differences. A name or a
difference that neither list names fails, and so does a listed one that is
no longer so. A JAX-style positional call that would bind to another
meaning raises ``TypeError``."""

import importlib
import inspect

import pytest
import torch

from cmhse_tpu_torch.eval import evalrank
from cmhse_tpu_torch.ops import should_stream_topk

torch.set_num_threads(2)

PACKAGES = ["", "data", "eval", "models", "ops", "parallel", "train",
            "utils", "native"]

# JAX names the port does not export, each with its reason
JAX_ONLY = {
    "parallel.batch_sharding": "a jax NamedSharding helper: the port places "
                               "tensors with parallel.place_batch",
    "parallel.replicated": "a jax NamedSharding helper: the port places "
                           "state with parallel.place_state",
    "native.available": "the JAX packer falls back to numpy; the port's "
                        "build raises, so there is nothing to ask",
}

_MODULE = ("the port's model is an nn.Module that holds its weights, so no "
           "`params`; no `use_pallas_gru`: a CUDA tensor takes the kernel")
_FLAX = ("a flax module's fields (`parent`, `name`, `param_dtype`, "
         "`use_pallas*`) against an nn.Module's constructor, which takes its "
         "input width and a `generator` for its weights")

# shared callables whose parameters differ from JAX's: the port's
# parameters, then the reason
DIFFERENCES = {
    "eval.encode_data": ("model, batches, return_low_level", _MODULE),
    "eval.encode_gallery_device": ("model, batches, return_ids", _MODULE),
    "eval.validate_metrics": (
        "model, batches, ks, streaming, return_ranks, mesh, mode", _MODULE),
    "eval.Retriever": ("model, mesh, quantize, rescore_m", _MODULE),
    "eval.evalrank": (
        "checkpoint_path, data_path, split, ks, *, streaming, dump_ranks, "
        "device, mesh, mode",
        "keyword-only after `ks`: JAX's fifth is `mesh`, and `device` picks "
        "the card or the CPU"),
    "models.MaskedGRU": ("in_dim, features, bidirectional, generator, dtype",
                         _FLAX),
    "models.SequenceEncoder": (
        "in_dim, embed_size, rnn_hidden, readout, bidirectional, generator, "
        "dtype", _FLAX + "; the projection and l2norm are always on"),
    "models.AttentionPool": ("width, attn_dim, generator, dtype", _FLAX),
    "models.WordEmbedding": ("vocab_size, word_dim, generator", _FLAX),
    "models.CMHSE": ("cfg, vocab_size, device, generator, text_tower",
                     _FLAX + "; `text_tower`: a DeepSeek-V2 decoder stack as "
                     "the sentence encoder, which the JAX package lacks"),
    "models.ReconstructionDecoder": (
        "embed_size, rnn_hidden, generator, dtype", _FLAX),
    "models.gru_sequence": ("x, lengths, w_i, w_h, b_i, b_h, h0",
                            "no `unroll`: a lax.scan setting"),
    "ops.l2norm": ("x, dim, eps", "torch's `dim` for numpy's `axis`"),
    "ops.prepare_topk_gallery": (
        "gallery, valid, chunk, quantize",
        "no `convert`: JAX's device-put hook; the port keeps the gallery's "
        "device"),
    "ops.append_to_prepared": (
        "pg, new_rows, n_existing, valid",
        "no `convert`: JAX's device-put hook; the port keeps the gallery's "
        "device"),
    "ops.should_stream_topk": (
        "n_queries, *, n_gallery",
        "a memory rule measured on the H100 (the dense [Q, N] block's "
        "bytes); JAX's size rule is ops.topk.should_prepare_topk. "
        "`n_gallery` keyword-only, so JAX's (n_gallery, force) raises"),
    "parallel.make_mesh": (
        "shape, axis_names, device, devices",
        "`device` is this rank's device on torch.distributed; `devices`, a "
        "list, makes a local mesh (a list passed as `device` raises)"),
    "train.TrainState": (
        "model, optimizer, grad_clip, step, graphs, graph_replays, "
        "graph_refused",
        "the port's state holds the nn.Module, its torch optimizer and its "
        "captured CUDA graphs, not a pytree"),
    "train.create_train_state": (
        "cfg, model",
        "the model already holds its weights: no `rng` or `sample_batch`"),
    "train.train_step": ("state, batch, loss_cfg, mesh",
                         "`mesh`: the data-parallel all-reduce; JAX's is in "
                         "the shardings"),
    "train.train_steps": ("state, stacked, loss_cfg, mesh",
                          "`mesh`: the data-parallel all-reduce; JAX's is in "
                          "the shardings"),
    "native.pack_batch_native": (
        "examples, spec, *, pinned",
        "keyword-only `pinned`: frames packed into page-locked memory for "
        "a copy to the card; JAX's device_put takes numpy"),
}


def _modules(pkg: str):
    suffix = f".{pkg}" if pkg else ""
    return (importlib.import_module("cmhse_tpu" + suffix),
            importlib.import_module("cmhse_tpu_torch" + suffix))


def _exported(mod) -> list[str]:
    """``__all__``, or, for a module without one, its public functions."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and inspect.isfunction(v)
            and v.__module__ == mod.__name__]


def _params(fn) -> str:
    """Parameter names in order, ``*`` before the keyword-only ones."""
    out, star = [], False
    for p in inspect.signature(fn).parameters.values():
        if p.kind is p.VAR_POSITIONAL:
            out.append("*" + p.name)
            star = True
            continue
        if p.kind is p.VAR_KEYWORD:
            out.append("**" + p.name)
            continue
        if p.kind is p.KEYWORD_ONLY and not star:
            out.append("*")
            star = True
        out.append(p.name)
    return ", ".join(out)


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "root")
def test_port_exports_the_jax_names_with_their_parameters(pkg):
    jax_mod, port_mod = _modules(pkg)
    prefix = f"{pkg}." if pkg else ""
    jax_names = _exported(jax_mod)
    only = {k for k in JAX_ONLY if k.startswith(prefix)
            and "." not in k[len(prefix):]}
    for key in only:  # a JAX-only entry names a JAX name the port lacks
        assert key[len(prefix):] in jax_names, f"{key}: not a JAX name"
        assert not hasattr(port_mod, key[len(prefix):]), \
            f"{key}: the port has it now; take it off JAX_ONLY"
    if hasattr(jax_mod, "__all__"):
        assert hasattr(port_mod, "__all__"), f"cmhse_tpu_torch.{pkg}"
        missing = set(jax_names) - set(port_mod.__all__) - {
            k[len(prefix):] for k in only}
        assert not missing, f"not in the port's __all__: {sorted(missing)}"
        for name in port_mod.__all__:
            assert hasattr(port_mod, name), f"__all__ names {name}"
    shared = [n for n in jax_names if prefix + n not in only]
    for name in shared:
        assert hasattr(port_mod, name), f"cmhse_tpu_torch.{prefix}{name}"
        jax_obj, port_obj = getattr(jax_mod, name), getattr(port_mod, name)
        if not callable(jax_obj):
            continue
        got, want = _params(port_obj), _params(jax_obj)
        key = prefix + name
        if key in DIFFERENCES:
            listed, reason = DIFFERENCES[key]
            assert reason
            assert got == listed, f"{key}: ({got}) drifted from the listed " \
                                  f"({listed})"
            assert got != want, f"{key}: equal to JAX's now; unlist it"
        else:
            assert got == want, f"{key}: port ({got}) vs JAX ({want})"
    # every listed difference names a shared callable of this package
    for key in DIFFERENCES:
        if key.startswith(prefix) and "." not in key[len(prefix):]:
            assert key[len(prefix):] in shared, f"{key}: not shared"


def test_root_names_carry_the_same_values():
    import cmhse_tpu
    import cmhse_tpu_torch

    assert cmhse_tpu_torch.__version__ == cmhse_tpu.__version__
    assert sorted(cmhse_tpu_torch.PRESETS) == sorted(cmhse_tpu.PRESETS)
    for name in cmhse_tpu.PRESETS:
        assert (cmhse_tpu_torch.PRESETS[name]().to_json()
                == cmhse_tpu.PRESETS[name]().to_json()), name


def test_every_listed_name_is_a_package():
    listed = {k.rsplit(".", 1)[0] for k in (*JAX_ONLY, *DIFFERENCES)}
    assert listed <= set(PACKAGES)


@pytest.mark.parametrize("call", [
    # JAX: should_stream_topk(n_gallery, force)
    lambda: should_stream_topk(40_000, True),
    # JAX: evalrank(checkpoint, data, split, ks, mesh)
    lambda: evalrank("ckpt", "data", "val", (1, 5), object()),
], ids=["should_stream_topk", "evalrank"])
def test_jax_positional_call_raises_instead_of_binding_elsewhere(call):
    with pytest.raises(TypeError):
        call()
