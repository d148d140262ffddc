"""The JAX package's training presets on the port, on the CPU, against the
JAX package at golden widths (E = H = 32): ``didemo``'s bucketed,
length-grouped ``fit`` (tests/test_didemo_stress.py's config) step for step
against JAX's ``fit``; validation ranks of bucketed and fixed-shape batches
against each other and against JAX's; one ``train_step`` of each of
``flat_anet_subset``, ``hier_anet`` and ``didemo`` from carried weights,
everything but the widths the preset's."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmhse_tpu.train.loop as jax_loop_mod
import cmhse_tpu_torch.train.loop as loop_mod
from cmhse_tpu.config import DataConfig as JaxDataConfig
from cmhse_tpu.config import ExperimentConfig as JaxExperimentConfig
from cmhse_tpu.config import LossConfig as JaxLossConfig
from cmhse_tpu.config import ModelConfig as JaxModelConfig
from cmhse_tpu.config import TrainConfig as JaxTrainConfig
from cmhse_tpu.config import get_preset as jax_get_preset
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu.eval.retrieval import validate_metrics as jax_validate
from cmhse_tpu.models import CMHSE as JaxCMHSE
from cmhse_tpu.train import train_step as jax_train_step
from cmhse_tpu.train.state import TrainState as JaxTrainState
from cmhse_tpu.train.state import make_optimizer as jax_make_optimizer
from cmhse_tpu.train.loop import fit as jax_fit
from cmhse_tpu.train.objective import total_loss as jax_total_loss
from cmhse_tpu_torch.config import ExperimentConfig, get_preset
from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.eval import validate_metrics
from cmhse_tpu_torch.interop import params_from_jax
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.train import create_train_state, total_loss, train_step

torch.set_num_threads(2)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)  # the JAX package's own GRU-grad band
# the golden widths every preset is shrunk to; the rest is the preset's
WIDTHS = dict(embed_size=32, word_dim=16, feat_dim=20, rnn_hidden=32)
VOCAB = 64


def _stress_cfg(run_dir="unused"):
    """tests/test_didemo_stress.py's config, bucketed and length-grouped,
    one epoch logging every step into ``run_dir``."""
    return JaxExperimentConfig(
        name="didemo_stress",
        data=JaxDataConfig(batch_size=8, feat_dim=16, vocab_size=64,
                           max_clips=4, max_frames=24, max_sentences=4,
                           max_words=12, frame_buckets=(6, 12, 24),
                           word_buckets=(4, 8, 12), fixed_shape=False,
                           group_by_length=True),
        model=JaxModelConfig(embed_size=24, word_dim=12, feat_dim=16,
                             rnn_hidden=24, hierarchical=True,
                             attention_pool=True),
        loss=JaxLossConfig(),
        train=JaxTrainConfig(num_epochs=1, val_step=0, log_step=1,
                             checkpoint_dir=str(run_dir)))


STRESS_DS = dict(feat_dim=16, vocab_size=64, max_clips=4, max_frames=24,
                 max_words=12)
# 48 videos of that generator from this seed: the shortest length group
# fits the 12-frame bucket, the others take 24 (from seed 9, as
# tests/test_didemo_stress.py draws them, every batch takes 24)
STRESS_SEED = 1


def _events(run_dir, name):
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == name]


def _shapes_seen(monkeypatch, module, attr):
    """Record the (frames, words) shapes of every batch ``module.attr`` (a
    train step) is called with."""
    real, seen = getattr(module, attr), []

    def recording(state, batch, loss_cfg):
        seen.append((tuple(batch.frames.shape), tuple(batch.words.shape)))
        return real(state, batch, loss_cfg)

    monkeypatch.setattr(module, attr, recording)
    return seen


def _carried_model(params):
    """``loop.build_model``'s stand-in: the JAX run's initial weights."""
    def build(cfg, device, text_tower=None):
        m = CMHSE(cfg.model, cfg.data.vocab_size, device=device)
        m.load_jax_params(jax.tree.map(np.asarray, params))
        return m
    return build


def test_bucketed_fit_matches_jax_fit(tmp_path, monkeypatch):
    """``didemo``'s batching (``fixed_shape=False``, ``group_by_length``)
    through both packages' ``fit`` from the same weights: the same bucket
    shapes in the same order, per-step losses within ``fit``'s band (rtol
    1e-4) and final parameters within the gradient band."""
    jcfg = _stress_cfg(tmp_path / "jax")
    ds_args = dict(num_videos=48, seed=STRESS_SEED, **STRESS_DS)
    jax_seen = _shapes_seen(monkeypatch, jax_loop_mod, "train_step")
    jstate, _ = jax_fit(jcfg, JaxDataset(**ds_args), None, use_mesh=False)
    sample = next(iter(jax_batches(JaxDataset(**ds_args), jcfg.data,
                                   shuffle=False)))
    jm = JaxCMHSE(cfg=jcfg.model, vocab_size=jcfg.data.vocab_size)
    params0 = jax.jit(jm.init)(jax.random.PRNGKey(jcfg.train.seed),
                               sample)["params"]  # fit's initial weights

    monkeypatch.setattr(loop_mod, "build_model", _carried_model(params0))
    seen = _shapes_seen(monkeypatch, loop_mod, "train_step")
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "port")))
    state, _ = loop_mod.fit(cfg, SyntheticHierarchicalDataset(**ds_args),
                            None, device="cpu")

    assert state.step == 6 and len(set(seen)) >= 2, seen
    assert seen == jax_seen
    got = _events(cfg.train.checkpoint_dir, "train_step")
    want = _events(jcfg.train.checkpoint_dir, "train_step")
    assert [e["step"] for e in got] == [e["step"] for e in want] == \
        list(range(1, 7))
    for key in ("loss", "loss_high", "loss_low", "grad_norm"):
        np.testing.assert_allclose([e[key] for e in got],
                                   [e[key] for e in want], rtol=1e-4,
                                   err_msg=key)
    want_params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_params[k].numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_bucketed_and_fixed_validation_ranks_equal_jax():
    """Bucket choice changes only the padding: the port's validation ranks
    (both directions) are equal under bucketed and fixed-shape batches, and
    equal to the JAX package's (tests/test_didemo_stress.py's ranks check).
    Both batchings group by length, unshuffled, so the rows come in one
    order and the shortest group takes the smaller bucket."""
    jcfg = _stress_cfg()
    ds_args = dict(num_videos=48, seed=STRESS_SEED, **STRESS_DS)
    jb0 = next(iter(jax_batches(JaxDataset(**ds_args), jcfg.data,
                                shuffle=False)))
    jm = JaxCMHSE(cfg=jcfg.model, vocab_size=jcfg.data.vocab_size)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jb0)["params"]
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    model = _carried_model(params)(cfg, "cpu")

    ranks, widths = {}, {}
    for fixed in (True, False):
        load = dict(shuffle=False, fixed_shape=fixed, group_by_length=True)
        batches = list(batches_from_dataset(
            SyntheticHierarchicalDataset(**ds_args), cfg.data, **load))
        widths[fixed] = sorted({b.frames.shape[2] for b in batches})
        _, ranks[fixed] = validate_metrics(model, batches, ks=(1, 5),
                                           return_ranks=True)
        _, ranks["jax", fixed] = jax_validate(
            jm, params, jax_batches(JaxDataset(**ds_args), jcfg.data,
                                    **load),
            ks=(1, 5), return_ranks=True)
    assert widths == {True: [24], False: [12, 24]}, widths
    for key in ("v2p_ranks", "p2v_ranks"):
        np.testing.assert_array_equal(ranks[False][key], ranks[True][key],
                                      err_msg=key)
        for fixed in (True, False):
            np.testing.assert_array_equal(ranks[fixed][key],
                                          ranks["jax", fixed][key],
                                          err_msg=key)


def _shrunk(name):
    """The preset ``name`` in both packages at the golden widths, with its
    own batch size, caps, buckets, batching, readouts and loss weights."""
    jp = jax_get_preset(name)
    jcfg = dataclasses.replace(
        jp, data=dataclasses.replace(jp.data, feat_dim=WIDTHS["feat_dim"],
                                     vocab_size=VOCAB),
        model=dataclasses.replace(jp.model, **WIDTHS))
    return jcfg, ExperimentConfig.from_json(jcfg.to_json())


def _preset_dataset(cls, cfg, seed):
    d = cfg.data
    return cls(num_videos=d.batch_size, feat_dim=d.feat_dim,
               vocab_size=d.vocab_size, max_clips=d.max_clips,
               max_frames=d.max_frames, max_words=d.max_words, seed=seed)


@pytest.mark.parametrize("name", ["flat_anet_subset", "hier_anet", "didemo"])
def test_preset_train_step_matches_jax(name):
    """One step of the preset from carried weights on its first batch (the
    preset's batch size and loader mode): loss and metrics within rtol
    2e-5, every parameter gradient within the gradient band, and the same
    metric keys and values as JAX's ``train_step``."""
    jcfg, cfg = _shrunk(name)
    port = get_preset(name)  # the port's preset, but for the widths
    assert cfg == port.replace(
        data=dataclasses.replace(port.data, feat_dim=WIDTHS["feat_dim"],
                                 vocab_size=VOCAB),
        model=dataclasses.replace(port.model, **WIDTHS))
    load = dict(shuffle=True, seed=0, fixed_shape=jcfg.data.fixed_shape,
                group_by_length=jcfg.data.group_by_length)
    jb = next(iter(jax_batches(_preset_dataset(JaxDataset, jcfg, 3),
                               jcfg.data, **load)))
    pb = next(batches_from_dataset(
        _preset_dataset(SyntheticHierarchicalDataset, cfg, 3), cfg.data,
        **load))
    for f in dataclasses.fields(pb):
        np.testing.assert_array_equal(getattr(pb, f.name),
                                      np.asarray(getattr(jb, f.name)))

    # jitted, the batch an argument: eager flax at these lengths takes
    # tens of seconds on the CPU
    jm = JaxCMHSE(cfg=jcfg.model, vocab_size=VOCAB)
    params = jax.jit(jm.init)(jax.random.PRNGKey(11), jb)["params"]
    carried = jax.tree.map(np.asarray, params)

    def loss_fn(p, b):
        return jax_total_loss(jm.apply({"params": p}, b), b, jcfg.loss)

    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jb)
    tx = jax_make_optimizer(jcfg)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), apply_fn=jm.apply,
                           tx=tx)  # create_train_state's, from these params
    _, jstep = jax_train_step(jstate, jb, jcfg.loss)

    model = _carried_model(carried)(cfg, "cpu")
    b = pb.to("cpu")
    loss, metrics = total_loss(model(b), b, cfg.loss)
    loss.backward()
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(jmetrics[k]),
                                   rtol=2e-5, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **GRAD_TOL,
                                   err_msg=k)

    model.zero_grad()
    _, step_metrics = train_step(create_train_state(cfg, model), pb,
                                 cfg.loss)
    assert set(step_metrics) == set(jstep)
    for k, v in step_metrics.items():
        np.testing.assert_allclose(float(v), float(jstep[k]), rtol=2e-5,
                                   err_msg=k)
