"""The port's training loop (``cmhse_tpu_torch.train.loop.fit``) on the CPU,
modelled on tests/test_snapshot.py and tests/test_e2e.py: the same run as
the JAX package's ``fit`` (per-step losses, final parameters, validation
rsums), kill-and-resume bitwise equal to the uninterrupted run (one and
two steps a dispatch), SIGTERM, and the rest of ``fit``'s behaviour."""

import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from cmhse_tpu.config import DataConfig as JaxDataConfig
from cmhse_tpu.config import ExperimentConfig as JaxExperimentConfig
from cmhse_tpu.config import ModelConfig as JaxModelConfig
from cmhse_tpu.config import TrainConfig as JaxTrainConfig
from cmhse_tpu.data import CorrelatedSyntheticDataset as JaxCorrelated
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu.train import create_train_state as jax_create_state
from cmhse_tpu.train.loop import adjust_learning_rate as jax_adjust_lr
from cmhse_tpu.train.loop import fit as jax_fit
import cmhse_tpu_torch.train.loop as loop_mod
from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig, LossConfig,
                                    ModelConfig, TrainConfig)
from cmhse_tpu_torch.data import (CorrelatedSyntheticDataset,
                                  SyntheticHierarchicalDataset, Vocabulary)
from cmhse_tpu_torch.interop import params_from_jax
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.train.checkpoint import (CheckpointManager,
                                              restore_for_eval)
from cmhse_tpu_torch.train.loop import adjust_learning_rate, fit
from tests.reference_layout import write_word2vec_bin

torch.set_num_threads(2)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


class Preempted(RuntimeError):
    """Simulated preemption: the process dies mid-epoch, with no chance to
    run the end-of-epoch save."""


def _cfg(ckpt_dir, **train_overrides):
    train = dict(num_epochs=2, lr=1e-3, lr_update=1, val_step=0, log_step=100,
                 checkpoint_dir=str(ckpt_dir))
    train.update(train_overrides)
    return ExperimentConfig(
        name="loop",
        data=DataConfig(batch_size=8, feat_dim=16, vocab_size=64,
                        max_clips=2, max_frames=6, max_sentences=2,
                        max_words=6),
        model=ModelConfig(embed_size=24, word_dim=12, feat_dim=16,
                          rnn_hidden=24, hierarchical=True),
        loss=LossConfig(),
        train=TrainConfig(**train),
    )


def _ds(n=24, seed=0):
    return SyntheticHierarchicalDataset(num_videos=n, feat_dim=16,
                                        vocab_size=64, max_clips=2,
                                        max_frames=6, max_words=6, seed=seed)


def _fit(cfg, train, val=None, **kw):
    return fit(cfg, train, val, device="cpu", **kw)


def _resumed(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume=cfg.train.checkpoint_dir))


def _events(cfg, name):
    path = os.path.join(cfg.train.checkpoint_dir, "log.jsonl")
    return [e for e in map(json.loads, open(path)) if e["event"] == name]


def _assert_states_identical(a, b):
    assert a.step == b.step > 0
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    assert oa.keys() == ob.keys()
    for i, st in oa.items():
        for k, v in st.items():
            assert torch.equal(v, ob[i][k]), (i, k)


def _kill_after(monkeypatch, attr, n_calls):
    """Patch the loop module's ``attr`` (train_step / train_steps) to raise
    Preempted before its (n_calls + 1)-th call."""
    real = getattr(loop_mod, attr)
    count = {"n": 0}

    def killer(state, batch, loss_cfg):
        if count["n"] >= n_calls:
            raise Preempted()
        count["n"] += 1
        return real(state, batch, loss_cfg)

    monkeypatch.setattr(loop_mod, attr, killer)


# ---- parity with the JAX package's fit ------------------------------------

def test_fit_matches_jax_fit(tmp_path, monkeypatch):
    """Two epochs with lr decay and a validation at each epoch's end on
    correlated synthetic data, from the JAX run's initial weights: per-step
    losses (log.jsonl) within rtol 1e-4, final parameters within the
    gradient band, validation rsums equal."""
    data = dict(batch_size=8, feat_dim=16, vocab_size=64, max_clips=3,
                max_frames=6, max_sentences=3, max_words=6)
    model = dict(embed_size=24, word_dim=12, feat_dim=16, rnn_hidden=24,
                 hierarchical=True, attention_pool=True, reconstruction=True)
    train = dict(num_epochs=2, lr=1e-3, lr_update=1, val_step=0, log_step=1,
                 seed=5)
    jcfg = JaxExperimentConfig(
        name="parity", data=JaxDataConfig(**data),
        model=JaxModelConfig(**model),
        train=JaxTrainConfig(checkpoint_dir=str(tmp_path / "jax"), **train))
    ds_args = dict(feat_dim=16, vocab_size=64, max_clips=3, max_frames=6,
                   max_words=6)
    jstate, jbest = jax_fit(jcfg, JaxCorrelated(24, seed=0, **ds_args),
                            JaxCorrelated(8, seed=1, **ds_args),
                            use_mesh=False)
    sample = next(iter(jax_batches(JaxCorrelated(24, seed=0, **ds_args),
                                   jcfg.data, shuffle=False,
                                   fixed_shape=True)))
    params0 = jax_create_state(jcfg, jax.random.PRNGKey(train["seed"]),
                               sample).params

    def from_jax(cfg, device, text_tower=None):
        m = CMHSE(cfg.model, cfg.data.vocab_size, device=device)
        m.load_jax_params(jax.tree.map(np.asarray, params0))
        return m

    monkeypatch.setattr(loop_mod, "build_model", from_jax)
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "port")))
    state, best = _fit(cfg, CorrelatedSyntheticDataset(24, seed=0, **ds_args),
                       CorrelatedSyntheticDataset(8, seed=1, **ds_args))

    got = _events(cfg, "train_step")
    want = _events(jcfg, "train_step")
    assert [e["step"] for e in got] == [e["step"] for e in want] == \
        list(range(1, 7))
    assert [e["lr"] for e in got] == [e["lr"] for e in want]
    np.testing.assert_allclose([e["loss"] for e in got],
                               [e["loss"] for e in want], rtol=1e-4)
    want_params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_params[k].numpy(),
                                   **GRAD_TOL, err_msg=k)
    rsums = [e["rsum"] for e in _events(cfg, "validate")]
    assert rsums == [e["rsum"] for e in _events(jcfg, "validate")]
    assert len(rsums) == 2 and best == jbest


def test_adjust_learning_rate_matches_jax(tmp_path):
    for lr_update in (1, 3, 15):
        cfg = _cfg(tmp_path, lr_update=lr_update)
        jcfg = JaxExperimentConfig.from_json(cfg.to_json())
        for epoch in range(0, 40, 3):
            assert adjust_learning_rate(cfg, epoch) == \
                jax_adjust_lr(jcfg, epoch)


# ---- kill and resume --------------------------------------------------------

# didemo's batching: bucketed and length-grouped, at edges that give these
# batches more than one shape
BUCKETED = dict(fixed_shape=False, group_by_length=True,
                frame_buckets=(4, 5, 6), word_buckets=(4, 6))


@pytest.mark.parametrize("spd,attr,kill_after,position,data", [
    # 24 videos / batch 8 = 3 steps an epoch: killed after step 4, in
    # epoch 1 with one group done
    pytest.param(1, "train_step", 4, (1, 1), {},
                 id="1-train_step-4-position0"),
    # two steps a dispatch: groups of [2, 1] steps; killed after 3 of 4
    # dispatches, in epoch 1 with one group done
    pytest.param(2, "train_steps", 3, (1, 1), {},
                 id="2-train_steps-3-position1"),
    # bucketed, length-grouped batches (one step a dispatch): the resumed
    # epoch must skip the same length group the killed run trained
    pytest.param(1, "train_step", 4, (1, 1), BUCKETED, id="bucketed"),
])
def test_kill_and_resume_matches_uninterrupted_run(tmp_path, monkeypatch,
                                                   spd, attr, kill_after,
                                                   position, data):
    """A run killed mid-epoch and resumed from its last snapshot ends
    bitwise equal (parameters, Adam state, step) to the run that was never
    interrupted."""
    over = dict(snapshot_step=1, steps_per_dispatch=spd)

    def cfg_at(name):
        cfg = _cfg(tmp_path / name, **over)
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                 **data))

    shapes = []
    real = loop_mod.train_step

    def recording(state, batch, loss_cfg):
        shapes.append(tuple(batch.frames.shape))
        return real(state, batch, loss_cfg)

    monkeypatch.setattr(loop_mod, "train_step", recording)
    state_a, _ = _fit(cfg_at("a"), _ds())
    monkeypatch.undo()
    if data:
        assert len(set(shapes)) > 1, shapes

    cfg_b = cfg_at("b")
    _kill_after(monkeypatch, attr, kill_after)
    with pytest.raises(Preempted):
        _fit(cfg_b, _ds())
    monkeypatch.undo()

    probe = loop_mod.build_model(cfg_b, torch.device("cpu"))
    from cmhse_tpu_torch.train import create_train_state

    _, epoch, _, groups_done = CheckpointManager(
        cfg_b.train.checkpoint_dir).restore(create_train_state(cfg_b, probe))
    assert (epoch, groups_done) == position

    state_b, _ = _fit(_resumed(cfg_b), _ds())
    _assert_states_identical(state_a, state_b)
    resumes = _events(cfg_b, "resume_mid_epoch")
    assert resumes and resumes[-1]["groups"] == 1


def test_sigterm_snapshots_and_exits_cleanly(tmp_path, monkeypatch):
    """With snapshots on, SIGTERM mid-epoch makes fit() finish the
    in-flight group, write a snapshot and return; the previous handler is
    restored, and the resumed run matches the uninterrupted one."""
    state_a, _ = _fit(_cfg(tmp_path / "a", snapshot_step=100), _ds())
    real = loop_mod.train_step
    count = {"n": 0}

    def sender(state, batch, loss_cfg):
        count["n"] += 1
        if count["n"] == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(state, batch, loss_cfg)

    monkeypatch.setattr(loop_mod, "train_step", sender)
    before = signal.getsignal(signal.SIGTERM)
    cfg_b = _cfg(tmp_path / "b", snapshot_step=100)
    state_mid, _ = _fit(cfg_b, _ds())
    monkeypatch.undo()
    assert state_mid.step == 4
    assert signal.getsignal(signal.SIGTERM) is before
    pre = _events(cfg_b, "preempt_exit")
    assert pre and pre[-1]["groups_done"] == 1 and pre[-1]["epoch"] == 1
    state_b, _ = _fit(_resumed(cfg_b), _ds())
    _assert_states_identical(state_a, state_b)


def test_epoch_end_save_overwrites_same_step_snapshot(tmp_path):
    cfg = _cfg(tmp_path / "run", snapshot_step=1, num_epochs=1)
    _fit(cfg, _ds())
    from cmhse_tpu_torch.train import create_train_state

    probe = create_train_state(cfg, loop_mod.build_model(
        cfg, torch.device("cpu")))
    restored, epoch, _, groups_done = CheckpointManager(
        cfg.train.checkpoint_dir).restore(probe)
    assert restored.step == 3
    assert (epoch, groups_done) == (1, 0)
    assert [e["step"] for e in _events(cfg, "snapshot")] == [1, 2, 3]


# ---- the rest of fit's behaviour -------------------------------------------

def test_fit_validates_keeps_best_and_resumes(tmp_path):
    cfg = _cfg(tmp_path / "run", num_epochs=2)
    state, best = _fit(cfg, _ds(16), _ds(8, seed=1))
    assert np.isfinite(best) and state.step == 4
    run = cfg.train.checkpoint_dir
    for name in ("config.json", "best", "log.jsonl"):
        assert os.path.exists(os.path.join(run, name)), name
    assert [e["epoch"] for e in _events(cfg, "epoch_end")] == [0, 1]

    cfg2 = dataclasses.replace(_resumed(cfg), train=dataclasses.replace(
        _resumed(cfg).train, num_epochs=3))
    state2, _ = _fit(cfg2, _ds(16), _ds(8, seed=1))
    assert state2.step == 6

    model, cfg_back = restore_for_eval(run, device="cpu")
    assert cfg_back.model.embed_size == 24
    model_b, _ = restore_for_eval(os.path.join(run, "best"), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, model_b.state_dict()[k]), k
    from cmhse_tpu_torch.data import batches_from_dataset
    from cmhse_tpu_torch.eval import validate_metrics

    m = validate_metrics(model, batches_from_dataset(
        _ds(8, seed=1), cfg.data, shuffle=False), ks=(1, 5))
    assert np.isfinite(m["rsum"])


def test_fit_log_step_zero_means_disabled(tmp_path):
    cfg = _cfg(tmp_path / "run", num_epochs=1, log_step=0)
    state, _ = _fit(cfg, _ds(16))
    assert state.step == 2 and _events(cfg, "train_step") == []


def test_fit_skips_duplicate_end_of_epoch_validation(tmp_path, monkeypatch):
    """When the val_step boundary lands on the epoch's final group, the
    end-of-epoch pass does not validate the same parameters again (it still
    writes the epoch + 1 resume marker)."""
    calls = []
    real = loop_mod.validate_metrics

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(loop_mod, "validate_metrics", counting)
    cfg = _cfg(tmp_path / "run", num_epochs=2, val_step=2)
    state, best = _fit(cfg, _ds(16), _ds(8, seed=1))
    assert len(calls) == 2 and np.isfinite(best)
    from cmhse_tpu_torch.train import create_train_state

    _, epoch, _, _ = CheckpointManager(cfg.train.checkpoint_dir).restore(
        create_train_state(cfg, loop_mod.build_model(
            cfg, torch.device("cpu"))))
    assert epoch == 2


def test_validate_nan_rsum_never_poisons_best(tmp_path, monkeypatch):
    seq = iter([float("nan"), 100.0, 50.0])

    def fake_metrics(*a, **kw):
        return {"rsum": next(seq), "v2p_r1": 0.0, "p2v_r1": 0.0}

    monkeypatch.setattr(loop_mod, "validate_metrics", fake_metrics)
    monkeypatch.setattr(loop_mod, "format_table", lambda m: str(m))
    cfg = _cfg(tmp_path / "run", num_epochs=3)
    _, best = _fit(cfg, _ds(16), _ds(8, seed=1))
    assert best == 100.0
    payload = torch.load(os.path.join(cfg.train.checkpoint_dir, "best"),
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["best_rsum"] == 100.0


def test_fit_rejects_oversized_vocab_early(tmp_path):
    vocab = Vocabulary()
    for i in range(70):  # 4 specials + 70 words > vocab_size=64
        vocab.add_word(f"w{i}")
    with pytest.raises(ValueError, match="vocab_size"):
        _fit(_cfg(tmp_path / "run"), _ds(16), vocab=vocab)
    assert not os.path.exists(tmp_path / "run")


def test_fit_applies_word2vec_init_before_resume(tmp_path):
    """Pretrained rows from a word2vec binary replace the table's rows
    before training; a resume still wins over them."""
    vocab = Vocabulary()
    for w in ("dog", "runs", "fast", "cat"):
        vocab.add_word(w)
    vecs_path = str(tmp_path / "vectors.bin")
    write_word2vec_bin(vecs_path, ["dog", "fast", "zebra"], dim=12, seed=3)
    from cmhse_tpu_torch.data.word_vectors import load_word_vectors

    known = load_word_vectors(vecs_path)
    cfg = _cfg(tmp_path / "run", num_epochs=1)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, word2vec_path=vecs_path))
    with pytest.raises(ValueError, match="vocab"):
        _fit(cfg, _ds(8))  # word2vec_path set but no vocab passed
    state, _ = _fit(cfg, _ds(8), vocab=vocab)
    table = state.model.word_embedding.embedding.detach().numpy()
    for w in ("dog", "fast"):  # one Adam step moves a row by ~lr
        assert np.abs(table[vocab(w)] - known[w]).max() < 0.05
    assert np.abs(table[vocab("runs")]).max() < 0.2  # random init kept
    w2v = _events(cfg, "word2vec_init")
    assert w2v and w2v[0]["hits"] == 2

    resumed, _ = _fit(_resumed(cfg), _ds(8), vocab=vocab)
    assert torch.equal(resumed.model.word_embedding.embedding,
                       state.model.word_embedding.embedding)


def test_steps_per_dispatch_bucketed_runs_one_step_a_dispatch(
        tmp_path, capsys, monkeypatch):
    calls = {"train_steps": 0}
    monkeypatch.setattr(loop_mod, "train_steps", lambda *a: calls.update(
        train_steps=1))
    cfg = _cfg(tmp_path / "run", num_epochs=1, steps_per_dispatch=4,
               log_step=1)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, fixed_shape=False, group_by_length=True))
    state, _ = _fit(cfg, _ds(16))
    assert state.step == 2 and calls["train_steps"] == 0
    assert [e["step"] for e in _events(cfg, "train_step")] == [1, 2]
    assert "requires fixed_shape" in capsys.readouterr().out


def test_steps_per_dispatch_matches_single_step(tmp_path):
    """K steps a dispatch are exactly K train_steps: bitwise equal runs,
    with a short last group (3 steps an epoch at K = 2)."""
    state1, _ = _fit(_cfg(tmp_path / "a"), _ds(24))
    state2, _ = _fit(_cfg(tmp_path / "b", steps_per_dispatch=2), _ds(24))
    _assert_states_identical(state1, state2)
