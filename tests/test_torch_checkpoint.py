"""The port's checkpoints (``cmhse_tpu_torch.train.checkpoint``), on the
CPU: the round trip of a train state (model, Adam, step, epoch, best rsum,
position), same-step replacement, the newest-three policy, a checkpoint
without ``groups_done``, a save killed half-way, ``config.json`` read by
the JAX package, and ``restore_for_eval`` from ``best`` or the latest
checkpoint."""

import os

import numpy as np
import pytest
import torch

from cmhse_tpu.config import ExperimentConfig as JaxExperimentConfig
from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig, LossConfig,
                                    ModelConfig, TrainConfig)
from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.train import create_train_state, train_step
from cmhse_tpu_torch.train import checkpoint as ckpt_mod
from cmhse_tpu_torch.train.checkpoint import (CheckpointManager,
                                              eval_payload, restore_for_eval,
                                              write_best_dir)

torch.set_num_threads(2)


def _cfg(ckpt_dir):
    return ExperimentConfig(
        name="ckpt",
        data=DataConfig(batch_size=8, feat_dim=16, vocab_size=64,
                        max_clips=2, max_frames=6, max_sentences=2,
                        max_words=6),
        model=ModelConfig(embed_size=24, word_dim=12, feat_dim=16,
                          rnn_hidden=24, hierarchical=True),
        loss=LossConfig(),
        train=TrainConfig(lr=1e-3, checkpoint_dir=str(ckpt_dir)),
    )


def _state(cfg, seed, steps=0):
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    state = create_train_state(cfg, model)
    ds = SyntheticHierarchicalDataset(num_videos=8, feat_dim=16,
                                      vocab_size=64, max_clips=2,
                                      max_frames=6, max_words=6, seed=0)
    batch = next(batches_from_dataset(ds, cfg.data, shuffle=False))
    for _ in range(steps):
        state, _ = train_step(state, batch, cfg.loss)
    return state


def _assert_same_state(a, b):
    assert a.step == b.step
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_roundtrip_restores_model_adam_and_position(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg, seed=0, steps=2)
    mgr = CheckpointManager(str(tmp_path / "run"), cfg)
    mgr.save(state, epoch=3, best_rsum=42.5, is_best=True, groups_done=5)
    fresh = _state(cfg, seed=1)
    restored, epoch, best_rsum, groups_done = mgr.restore(fresh)
    assert (epoch, best_rsum, groups_done) == (3, 42.5, 5)
    _assert_same_state(restored, state)
    # restored Adam continues exactly as the original does
    ds = SyntheticHierarchicalDataset(num_videos=8, feat_dim=16,
                                      vocab_size=64, max_clips=2,
                                      max_frames=6, max_words=6, seed=2)
    batch = next(batches_from_dataset(ds, cfg.data, shuffle=False))
    train_step(state, batch, cfg.loss)
    train_step(restored, batch, cfg.loss)
    _assert_same_state(restored, state)
    assert os.path.exists(tmp_path / "run" / "best")
    mgr.close()


def test_same_step_save_replaces_and_newest_three_kept(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg, seed=0)
    mgr = CheckpointManager(str(tmp_path / "run"), cfg)
    for step in range(1, 6):
        state.step = step
        mgr.save(state, epoch=0, best_rsum=0.0, groups_done=step)
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    mgr.save(state, epoch=1, best_rsum=2.0, groups_done=0)  # step 5 again
    _, epoch, best, groups = mgr.restore(_state(cfg, seed=1))
    assert (epoch, best, groups) == (1, 2.0, 0)
    _, epoch, _, groups = mgr.restore(_state(cfg, seed=1), step=4)
    assert (epoch, groups) == (0, 4)
    assert sorted(os.listdir(mgr.ckpt_dir)) == ["3", "4", "5"]


def test_restore_accepts_checkpoint_without_groups_done(tmp_path):
    cfg = _cfg(tmp_path)
    state = _state(cfg, seed=0, steps=1)
    mgr = CheckpointManager(str(tmp_path / "run"), cfg)
    sd = state.state_dict()
    torch.save({"model": sd["model"], "optimizer": sd["optimizer"],
                "step": 7, "epoch": 2, "best_rsum": 1.5},
               os.path.join(mgr.ckpt_dir, "7"))
    restored, epoch, best_rsum, groups_done = mgr.restore(_state(cfg, 1))
    assert (epoch, best_rsum, groups_done) == (2, 1.5, 0)
    assert restored.step == 7


def test_killed_save_leaves_previous_checkpoint_whole(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    state = _state(cfg, seed=0, steps=1)
    mgr = CheckpointManager(str(tmp_path / "run"), cfg)
    mgr.save(state, epoch=0, best_rsum=1.0, is_best=True)
    real_save = torch.save

    def dies_half_way(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt_mod.torch, "save", dies_half_way)
    state.step = 2
    with pytest.raises(KeyboardInterrupt):
        mgr.save(state, epoch=1, best_rsum=2.0, is_best=True)
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    assert mgr.all_steps() == [1]
    restored, epoch, best, _ = mgr.restore(_state(cfg, seed=1))
    assert (restored.step, epoch, best) == (1, 0, 1.0)
    model, _ = restore_for_eval(str(tmp_path / "run"), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k


def test_config_json_reads_in_both_packages(tmp_path):
    cfg = _cfg(tmp_path / "run")
    CheckpointManager(str(tmp_path / "run"), cfg)
    text = (tmp_path / "run" / "config.json").read_text()
    assert ExperimentConfig.from_json(text) == cfg
    assert JaxExperimentConfig.from_json(text).to_json() == cfg.to_json()


def test_restore_for_eval_best_latest_and_best_path(tmp_path):
    cfg = _cfg(tmp_path)
    run = tmp_path / "run"
    mgr = CheckpointManager(str(run), cfg)
    older = _state(cfg, seed=0, steps=1)
    mgr.save(older, epoch=1, best_rsum=3.0, is_best=True)
    newer = _state(cfg, seed=0, steps=2)
    mgr.save(newer, epoch=2, best_rsum=3.0, is_best=False)

    def weights(model):
        return {k: v.clone() for k, v in model.state_dict().items()}

    best, cfg_back = restore_for_eval(str(run), device="cpu")
    assert cfg_back == cfg
    via_best, _ = restore_for_eval(str(run / "best"), device="cpu")
    for k, v in weights(older.model).items():
        assert torch.equal(weights(best)[k], v), k
        assert torch.equal(weights(via_best)[k], v), k
    os.remove(run / "best")
    latest, _ = restore_for_eval(str(run), device="cpu")
    for k, v in weights(newer.model).items():
        assert torch.equal(weights(latest)[k], v), k


def test_eval_payload_schema_and_best_dir(tmp_path):
    cfg = _cfg(tmp_path)
    CheckpointManager(str(tmp_path / "run"), cfg)
    state = _state(cfg, seed=4)
    payload = eval_payload(state.model.state_dict(), step=9, epoch=2,
                           best_rsum=7.5)
    assert set(payload) == {"model", "step", "epoch", "best_rsum"}
    write_best_dir(str(tmp_path / "run"), payload)
    back = torch.load(tmp_path / "run" / "best", weights_only=True)
    assert (back["step"], back["epoch"], back["best_rsum"]) == (9, 2, 7.5)
    model, _ = restore_for_eval(str(tmp_path / "run"), device="cpu")
    np.testing.assert_array_equal(
        model.word_embedding.embedding.detach().numpy(),
        state.model.word_embedding.embedding.detach().numpy())
