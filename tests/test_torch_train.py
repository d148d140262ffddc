"""The port's training step against the JAX package's, on the CPU: one
step's loss, metrics and every parameter gradient of ``full`` (decoders on),
``hier``, ``flat`` (flat_anet_subset's one-level loss) and ``didemo``
(attention pools, no decoders) against ``jax.value_and_grad`` on carried
params; the 8-step
``train_curve`` golden of tests/make_goldens.py; optax's clip rule and Adam
against the port's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmhse_tpu.config import LossConfig as JaxLossConfig
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu.models import CMHSE as JaxCMHSE
from cmhse_tpu.train.objective import total_loss as jax_total_loss
from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig, LossConfig,
                                    ModelConfig, TrainConfig)
from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.interop import params_from_jax
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.train import (clip_by_global_norm_, create_train_state,
                                   global_norm, make_optimizer,
                                   set_learning_rate, total_loss, train_step)
from tests.make_goldens import CONFIGS, DATA, DATA_FLAT, GOLDEN_PATH

torch.set_num_threads(2)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)  # the JAX package's own GRU-grad band


def _jax_batch(data=DATA):
    ds = JaxDataset(num_videos=8, feat_dim=20, vocab_size=64,
                    max_clips=data.max_clips, max_frames=6, max_words=5,
                    seed=7)
    return next(iter(jax_batches(ds, data, shuffle=False)))


# name -> (model, data, loss): ``full`` (decoders on), ``hier``, the flat
# model with flat_anet_subset's loss (one ranking level: one K3 pair a
# step) and didemo's model (attention pools, no decoders)
ONE_STEP_CASES = {
    "full": (CONFIGS["full"], DATA, JaxLossConfig(recon_weight=5e-4)),
    "hier": (CONFIGS["hier"], DATA, JaxLossConfig(recon_weight=0.0)),
    "flat": (CONFIGS["flat"], DATA_FLAT,
             JaxLossConfig(low_weight=0.0, recon_weight=0.0)),
    "didemo": (dataclasses.replace(CONFIGS["hier"], attention_pool=True),
               DATA, JaxLossConfig(recon_weight=0.0)),
}


def _port_model(mcfg, params):
    pm = CMHSE(ModelConfig(**dataclasses.asdict(mcfg)), DATA.vocab_size,
               device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, params))
    return pm


def _port_batch(batch):
    from cmhse_tpu_torch.data import Batch

    return Batch(**{f.name: np.asarray(getattr(batch, f.name))
                    for f in dataclasses.fields(Batch)}).to("cpu")


@pytest.mark.parametrize("name", list(ONE_STEP_CASES))
def test_one_step_loss_and_grads_match_jax(name):
    mcfg, data, jcfg = ONE_STEP_CASES[name]
    batch = _jax_batch(data)
    jm = JaxCMHSE(cfg=mcfg, vocab_size=DATA.vocab_size)
    params = jm.init(jax.random.PRNGKey(123), batch)["params"]

    def loss_fn(p):
        return jax_total_loss(jm.apply({"params": p}, batch), batch, jcfg)

    (jloss, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)

    pm = _port_model(mcfg, params)
    pb = _port_batch(batch)
    outputs = pm(pb)
    assert (outputs.video_recon is not None) == (name == "full")
    loss, metrics = total_loss(outputs, pb,
                               LossConfig(**dataclasses.asdict(jcfg)))
    loss.backward()
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(jmetrics[k]),
                                   rtol=2e-5, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **GRAD_TOL,
                                   err_msg=k)


def test_train_curve_golden_reproduced():
    """tests/make_goldens.py::compute_train_curve on the port: the flat
    model, JAX params at PRNGKey(7) carried across, the same batches, 8
    steps of clip + Adam, within the JAX golden test's own tolerance."""
    from cmhse_tpu.config import ExperimentConfig as JaxExperimentConfig
    from cmhse_tpu.config import TrainConfig as JaxTrainConfig
    from cmhse_tpu.train import create_train_state as jax_create_state

    goldens = np.load(GOLDEN_PATH)["train_curve"]
    jcfg = JaxExperimentConfig(
        name="golden_curve", data=DATA_FLAT, model=CONFIGS["flat"],
        loss=JaxLossConfig(low_weight=0.0, recon_weight=0.0),
        train=JaxTrainConfig(lr=1e-3, seed=0))
    jds = JaxDataset(num_videos=16, feat_dim=20, vocab_size=64, max_clips=1,
                     max_frames=6, max_words=5, seed=11)
    jb = list(jax_batches(jds, DATA_FLAT, shuffle=False))
    params = jax_create_state(jcfg, jax.random.PRNGKey(7), jb[0]).params

    cfg = ExperimentConfig.from_json(jcfg.to_json())
    ds = SyntheticHierarchicalDataset(num_videos=16, feat_dim=20,
                                      vocab_size=64, max_clips=1,
                                      max_frames=6, max_words=5, seed=11)
    batches = list(batches_from_dataset(ds, cfg.data, shuffle=False))
    pm = _port_model(CONFIGS["flat"], params)
    state = create_train_state(cfg, pm)
    losses = []
    for _ in range(4):
        for b in batches:
            state, m = train_step(state, b, cfg.loss)
            losses.append(float(m["loss"]))
    assert state.step == 8
    np.testing.assert_allclose(losses, goldens, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])  # below and above the limit
def test_clip_and_adam_match_optax(scale):
    rng = np.random.RandomState(int(scale * 10))
    shapes = [(3, 4), (5,), (2, 2, 2)]
    grads_np = [[(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
                for _ in range(3)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]

    tx = optax.chain(optax.clip_by_global_norm(2.0),
                     optax.inject_hyperparams(optax.adam)(learning_rate=1e-3))
    jparams = [jnp.asarray(p) for p in init]
    opt_state = tx.init(jparams)
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init])
    opt = make_optimizer(module, ExperimentConfig(train=TrainConfig(lr=1e-3)))
    for step_grads in grads_np:
        jg = [jnp.asarray(g) for g in step_grads]
        clipped, _ = optax.clip_by_global_norm(2.0).update(jg, None)
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

        grads = [torch.from_numpy(g.copy()) for g in step_grads]
        norm = global_norm(grads)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        clip_by_global_norm_(grads, 2.0, norm)
        for g, want in zip(grads, clipped):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        if scale < 1:  # under the limit: untouched, bit for bit
            for g, raw in zip(grads, step_grads):
                np.testing.assert_array_equal(g.numpy(), raw)
        for p, g in zip(module, grads):
            p.grad = g
        opt.step()
    for p, want in zip(module, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_set_learning_rate_and_step_count():
    mcfg = ModelConfig(**dataclasses.asdict(CONFIGS["hier"]))
    cfg = ExperimentConfig(data=DataConfig(**dataclasses.asdict(DATA)),
                           model=mcfg)
    pm = CMHSE(mcfg, DATA.vocab_size, device="cpu")
    state = set_learning_rate(create_train_state(cfg, pm), 1e-5)
    assert all(g["lr"] == 1e-5 for g in state.optimizer.param_groups)
    ds = SyntheticHierarchicalDataset(num_videos=8, feat_dim=20,
                                      vocab_size=64, max_clips=3,
                                      max_frames=6, max_words=5, seed=7)
    b = next(iter(batches_from_dataset(ds, cfg.data, shuffle=False)))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state, metrics = train_step(state, b, cfg.loss)
    assert state.step == 1
    assert set(metrics) == {"loss_high", "loss_low", "loss", "grad_norm"}
    assert all(torch.isfinite(v) for v in metrics.values())
    moved = [k for k, v in pm.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved  # the step updated the weights in place


def test_low_level_loss_needs_aligned_slots():
    pm = CMHSE(ModelConfig(**dataclasses.asdict(CONFIGS["hier"])), 64,
               device="cpu")
    rng = np.random.RandomState(0)
    from cmhse_tpu_torch.data import Batch

    b = Batch(frames=rng.randn(2, 3, 4, 20).astype(np.float32),
              frame_len=np.full((2, 3), 4, np.int32),
              clip_len=np.full(2, 3, np.int32),
              words=rng.randint(0, 64, (2, 2, 5)).astype(np.int32),
              word_len=np.full((2, 2), 5, np.int32),
              sent_len=np.full(2, 2, np.int32),
              video_ids=np.arange(2, dtype=np.int32),
              valid=np.ones(2, bool)).to("cpu")
    with pytest.raises(ValueError, match="Cmax=3 Smax=2"):
        total_loss(pm(b), b, LossConfig())
