"""The step's CUDA-graph path (``cmhse_tpu_torch.train.state._dispatch``)
as far as the CPU sees it: a CPU step stays eager and captures nothing,
the key a graph is captured under tells batch shapes and dtypes apart and
nothing else, ``train_steps`` is K eager steps, and what a graph reads
keeps its storage where the port writes a state in place (the model's
``load_state_dict``, as ``load_jax_params`` uses it) or drops the graphs
where it replaces Adam's tensors (``TrainState.load_state_dict``). The
card's side is in ``tests/test_torch_gpu.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from cmhse_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
from cmhse_tpu_torch.data import (Batch, SyntheticHierarchicalDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.train import create_train_state, train_step, train_steps
from cmhse_tpu_torch.train import state as state_mod

torch.set_num_threads(2)

FIELDS = [f.name for f in dataclasses.fields(Batch)]


def _cfg():
    return ExperimentConfig(
        data=DataConfig(batch_size=8, feat_dim=20, vocab_size=64,
                        max_clips=3, max_frames=7, max_sentences=3,
                        max_words=5),
        model=ModelConfig(embed_size=32, word_dim=16, feat_dim=20,
                          rnn_hidden=32, hierarchical=True,
                          attention_pool=True, reconstruction=True))


def _batches(cfg, n=20):
    # 20 videos at batch 8: the last batch is short, its padding rows
    # flagged invalid
    ds = SyntheticHierarchicalDataset(num_videos=n, feat_dim=20,
                                      vocab_size=64, max_clips=3,
                                      max_frames=7, max_words=5, seed=2)
    return list(batches_from_dataset(ds, cfg.data, shuffle=False))


def _state(cfg):
    model = CMHSE(cfg.model, 64, device="cpu",
                  generator=torch.Generator().manual_seed(1))
    return create_train_state(cfg, model)


def _assert_same(a, b):
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key]), key


def test_cpu_step_stays_eager_and_captures_nothing():
    """On the CPU ``train_step`` is the eager update, bit for bit, and
    leaves no graph, pool or stream behind; each step's gradients stay on
    the parameters, as they always did."""
    cfg = _cfg()
    host = _batches(cfg)
    assert not host[-1].valid.all()
    stepped, eager = _state(cfg), _state(cfg)
    for b in host + host[:1]:
        stepped, m = train_step(stepped, b, cfg.loss)
        want = state_mod._update(eager, b.to("cpu"), cfg.loss)
        eager.step += 1
        assert m.keys() == want.keys()
        for k in m:
            assert torch.equal(m[k], want[k]), k
        assert all(p.grad is not None for p in stepped.model.parameters())
    assert stepped.step == eager.step == len(host) + 1
    assert stepped.graphs == {} and stepped.graph_replays == 0
    assert stepped.graph_pool is None and stepped.graph_stream is None
    _assert_same(stepped, eager)


def test_train_steps_on_cpu_is_k_eager_steps():
    """K steps a call on the CPU: the K ``train_step``s in order, bit for
    bit, metrics stacked ``[K]``, the step count advanced by K, no
    graph."""
    cfg = _cfg()
    host = _batches(cfg, n=24)
    stacked = Batch(**{n: np.stack([getattr(b, n) for b in host])
                       for n in FIELDS})
    grouped, single = _state(cfg), _state(cfg)
    grouped, ms = train_steps(grouped, stacked, cfg.loss)
    losses = []
    for b in host:
        single, m = train_step(single, b, cfg.loss)
        losses.append(m["loss"])
    assert grouped.step == single.step == 3
    assert all(v.shape == (3,) for v in ms.values())
    assert torch.equal(ms["loss"], torch.stack(losses))
    assert grouped.graphs == {} and grouped.graph_replays == 0
    _assert_same(grouped, single)


def _key_batch(**change):
    """A small batch on the CPU; ``change`` maps a field to ``"shape"``
    (one more entry along its last axis), ``"dtype"`` (another dtype) or
    ``"data"`` (other values, same shape and dtype)."""
    rng = np.random.RandomState(0)
    fields = dict(
        frames=torch.from_numpy(rng.randn(4, 3, 6, 5).astype(np.float32)),
        frame_len=torch.full((4, 3), 6, dtype=torch.int32),
        clip_len=torch.full((4,), 3, dtype=torch.int32),
        words=torch.from_numpy(rng.randint(0, 64, (4, 2, 5)).astype(
            np.int32)),
        word_len=torch.full((4, 2), 5, dtype=torch.int32),
        sent_len=torch.full((4,), 2, dtype=torch.int32),
        video_ids=torch.arange(4, dtype=torch.int32),
        valid=torch.ones(4, dtype=torch.bool))
    for name, how in change.items():
        t = fields[name]
        if how == "shape":
            pad = torch.zeros(t.shape[:-1] + (1,), dtype=t.dtype)
            fields[name] = torch.cat([t, pad], dim=-1)
        elif how == "dtype":
            other = torch.bfloat16 if t.is_floating_point() else (
                torch.int64 if t.dtype != torch.int64 else torch.int32)
            fields[name] = t.to(other)
        else:
            fields[name] = (~t if t.dtype == torch.bool else t + 1)
    return Batch(**fields)


@pytest.mark.parametrize("how", ["shape", "dtype"])
@pytest.mark.parametrize("name", FIELDS)
def test_shape_key_tells_apart_any_field_shape_or_dtype(name, how):
    assert state_mod._shape_key(_key_batch(**{name: how})) != \
        state_mod._shape_key(_key_batch())


def test_shape_key_matches_batches_that_differ_only_in_data():
    assert state_mod._shape_key(_key_batch(**{n: "data" for n in FIELDS})) \
        == state_mod._shape_key(_key_batch())


def test_model_load_state_dict_keeps_every_parameter_in_place():
    """``CMHSE.load_jax_params`` goes through the module's
    ``load_state_dict``, which copies into the parameters' storage: a
    captured graph, which reads them by address, stays valid."""
    cfg = _cfg()
    state = _state(cfg)
    state, _ = train_step(state, _batches(cfg)[0], cfg.loss)
    ptrs = [p.data_ptr() for p in state.model.parameters()]
    adam = [state.optimizer.state[p]["exp_avg"].data_ptr()
            for p in state.model.parameters()]
    other = CMHSE(cfg.model, 64, device="cpu",
                  generator=torch.Generator().manual_seed(9))
    state.model.load_state_dict(other.state_dict())
    assert [p.data_ptr() for p in state.model.parameters()] == ptrs
    assert [state.optimizer.state[p]["exp_avg"].data_ptr()
            for p in state.model.parameters()] == adam
    for (k, v), w in zip(state.model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(v, w), k


def test_train_state_load_state_dict_drops_graphs_and_pool():
    """Restoring Adam's state replaces the tensors a graph reads, so the
    graphs and their pool go (a checkpoint restore goes through here)."""
    cfg = _cfg()
    state = _state(cfg)
    state, _ = train_step(state, _batches(cfg)[0], cfg.loss)
    saved = state.state_dict()
    state.graphs["stale"] = object()
    state.graph_pool = (0, 1)
    state.load_state_dict(saved)
    assert state.graphs == {} and state.graph_pool is None
    assert state.step == 1
