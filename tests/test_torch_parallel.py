"""The port's ``parallel`` package in one process: the mesh's rules and
errors, ``maybe_initialize_distributed``'s gating, the loader's process
slices, the data-parallel step at world 1 (a gloo group from a
``FileStore``) bit for bit against the plain step, and the sharded ranks
and top-k against the JAX package's sharded functions on its 8-device CPU
mesh, exactly, on the same numpy inputs (tests/test_sharded_eval.py's
cases). 2 ranks: tests/test_torch_parallel_spawn.py."""

import dataclasses
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cmhse_tpu.ops.ranking import retrieval_ranks as jax_retrieval_ranks
from cmhse_tpu.parallel.eval_sharded import (
    prepare_sharded_topk_gallery as jax_prepare,
    sharded_ranks as jax_sharded_ranks,
    sharded_retrieval_metrics as jax_sharded_metrics,
    sharded_sim_topk as jax_sharded_topk,
    sharded_sim_topk_prepared as jax_topk_prepared)
from cmhse_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig,
                                    ModelConfig)
from cmhse_tpu_torch.data import (Batch, SyntheticHierarchicalDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.eval.retrieval import validate_metrics
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.parallel import (local_rows, make_mesh,
                                      maybe_initialize_distributed,
                                      place_state,
                                      prepare_sharded_topk_gallery,
                                      sharded_ranks,
                                      sharded_retrieval_metrics,
                                      sharded_sim_topk,
                                      sharded_sim_topk_prepared)
from cmhse_tpu_torch.parallel import mesh as mesh_mod
from cmhse_tpu_torch.train import create_train_state, train_step, train_steps
from cmhse_tpu_torch.train import state as state_mod

torch.set_num_threads(2)


@pytest.fixture
def group(tmp_path):
    """A gloo process group of world 1, destroyed at teardown."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh((-1,), ("data",))


# ---- the mesh ---------------------------------------------------------------

def test_make_mesh_rules_without_a_group():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.group is None
    assert (mesh.rank, mesh.world, mesh.data_index) == (0, 1, 0)
    assert make_mesh((1, -1), ("data", "model"), device="cpu").shape == {
        "data": 1, "model": 1}
    with pytest.raises(ValueError, match="at most one -1"):
        make_mesh((-1, -1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        make_mesh((3, -1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        make_mesh((8,), ("data",), device="cpu")  # large_gallery_eval's
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((1,), ("data", "model"), device="cpu")


def test_make_mesh_on_a_group_and_its_coordinates(group):
    mesh = make_mesh((-1,), ("data",), device="cpu")
    assert mesh.group is dist.group.WORLD and mesh.data_size == 1
    idle = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert idle.coord("model") == 0 and idle.group is not None
    # row-major coordinates, the JAX mesh's device order
    m = mesh_mod.Mesh(shape={"data": 2, "model": 3}, device=mesh.device,
                      rank=4, world=6)
    assert (m.coord("data"), m.coord("model")) == (1, 1)
    with pytest.raises(ValueError, match="'data' axis only"):
        m.check_axis("model")


def test_maybe_initialize_distributed_gating(monkeypatch):
    """No torchrun environment: a no-op. The full environment: a gloo
    group for the CPU, started once (a second call is a no-op)."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not maybe_initialize_distributed("cpu")  # no rendezvous address
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    try:
        assert maybe_initialize_distributed("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert maybe_initialize_distributed("cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_maybe_initialize_distributed_needs_a_card_unless_asked_for_cpu(
        monkeypatch):
    """The card is the default device: with no card and no ``cpu`` asked
    for it raises, and never starts a CPU group in its place."""
    for var, val in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(var, val)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maybe_initialize_distributed()
    assert not dist.is_initialized()


# ---- the loader's process slices (tests/test_multihost.py:38-75) ------------

CFG = DataConfig(batch_size=8, feat_dim=8, vocab_size=32, max_clips=2,
                 max_frames=4, max_sentences=2, max_words=4)


def _ds(n):
    return SyntheticHierarchicalDataset(num_videos=n, feat_dim=8,
                                        vocab_size=32, max_clips=2,
                                        max_frames=4, max_words=4, seed=3)


@pytest.mark.parametrize("n_videos", [32, 30])  # 30: ragged final batch
def test_process_slices_reassemble_to_global_batches(n_videos):
    pc = 4
    ds = _ds(n_videos)
    global_batches = list(batches_from_dataset(ds, CFG, shuffle=True, seed=7))
    per_proc = [list(batches_from_dataset(ds, CFG, shuffle=True, seed=7,
                                          process_index=pi, process_count=pc))
                for pi in range(pc)]
    assert all(len(b) == len(global_batches) for b in per_proc)
    for bi, gb in enumerate(global_batches):
        locals_ = [per_proc[pi][bi] for pi in range(pc)]
        assert all(lb.frames.shape[0] == CFG.batch_size // pc
                   for lb in locals_)
        for f in dataclasses.fields(Batch):
            got = np.concatenate([np.asarray(getattr(lb, f.name))
                                  for lb in locals_])
            np.testing.assert_array_equal(got, np.asarray(getattr(gb, f.name)),
                                          err_msg=f"batch {bi} {f.name}")
            # local_rows cuts the same slice out of a global batch
            for pi in range(pc):
                mesh = mesh_mod.Mesh(shape={"data": pc}, device=torch.device(
                    "cpu"), rank=pi, world=pc)
                np.testing.assert_array_equal(
                    np.asarray(getattr(local_rows(gb, mesh), f.name)),
                    np.asarray(getattr(per_proc[pi][bi], f.name)))


def test_process_count_must_divide_batch():
    with pytest.raises(ValueError, match="divide"):
        next(iter(batches_from_dataset(_ds(16), CFG, process_index=0,
                                       process_count=3)))


# ---- the data-parallel step at world 1 --------------------------------------

def _tiny():
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=8, feat_dim=24, vocab_size=128,
                        max_clips=3, max_frames=6, max_sentences=3,
                        max_words=6),
        model=ModelConfig(embed_size=32, word_dim=16, feat_dim=24,
                          rnn_hidden=32, hierarchical=True,
                          attention_pool=True, reconstruction=True))
    ds = SyntheticHierarchicalDataset(num_videos=24, feat_dim=24,
                                      vocab_size=128, max_clips=3,
                                      max_frames=6, max_words=6, seed=5)
    return cfg, list(batches_from_dataset(ds, cfg.data, shuffle=False))


def _state(cfg, seed=0):
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    return create_train_state(cfg, model)


def test_dp_step_at_world_1_equals_train_step_bitwise(group):
    """Gather, global loss and the flat all-reduce change no bit:
    parameters, Adam's moments and every metric."""
    cfg, batches = _tiny()
    mesh = make_mesh(device="cpu")
    plain, dp = _state(cfg), place_state(_state(cfg), mesh)
    for b in batches:
        plain, m1 = train_step(plain, b, cfg.loss)
        dp, m2 = train_step(dp, b, cfg.loss, mesh=mesh)
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    for (name, a), b in zip(plain.model.state_dict().items(),
                            dp.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(plain.model.parameters(), dp.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(plain.optimizer.state[p][key],
                               dp.optimizer.state[q][key])
    # K steps a call (the card's CUDA graph; eager here) under the mesh
    stacked = Batch(**{f.name: np.stack([getattr(b, f.name)
                                         for b in batches[:2]])
                       for f in dataclasses.fields(Batch)})
    s1, k1 = train_steps(_state(cfg), stacked, cfg.loss)
    s2, k2 = train_steps(place_state(_state(cfg), mesh), stacked, cfg.loss,
                         mesh=mesh)
    for k in k1:
        assert torch.equal(k1[k], k2[k]), k
    assert s1.step == s2.step == 2


@pytest.mark.parametrize("message,refused", [
    ("CUDA error: operation not permitted when stream is capturing", True),
    ("gru_fwd failed: CUDA error 901 (operation failed due to an "
     "invalidated stream capture)", True),
    ("gru_fwd failed: CUDA error 720 (too many blocks in cooperative "
     "launch)", False),
    ("NCCL error: remote process exited or there was a network error",
     False),
])
def test_capture_refusal_is_told_from_a_failed_step(message, refused):
    """Under a mesh, ``train_steps`` runs one step a dispatch only when
    the card refused the capture; a failed launch or collective is
    raised."""
    assert state_mod._capture_refused(RuntimeError(message)) is refused


def test_place_state_broadcasts_rank_0(group):
    """At world 1 rank 0 is every rank: the state is unchanged, on resume
    (Adam's moments present) too."""
    cfg, batches = _tiny()
    mesh = make_mesh(device="cpu")
    state, _ = train_step(_state(cfg), batches[0], cfg.loss)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert place_state(state, mesh) is state and state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_validate_metrics_under_a_mesh_equals_single_device(group):
    """Each rank encodes its rows; gathered and ranked sharded in both
    modes, dense and streaming: the single device's metrics and ranks."""
    cfg, _ = _tiny()
    ds = SyntheticHierarchicalDataset(num_videos=20, feat_dim=24,
                                      vocab_size=128, max_clips=3,
                                      max_frames=6, max_words=6, seed=6)
    model = _state(cfg).model
    mesh = make_mesh(device="cpu")

    def mk():
        return batches_from_dataset(ds, cfg.data, shuffle=False)

    want, want_r = validate_metrics(model, mk(), ks=(1, 5), streaming=False,
                                    return_ranks=True)
    for mode in ("query", "gallery"):
        for stream in (False, True):
            got, got_r = validate_metrics(model, mk(), ks=(1, 5),
                                          streaming=stream,
                                          return_ranks=True, mesh=mesh,
                                          mode=mode)
            assert got == pytest.approx(want, rel=1e-6)
            for k in want_r:
                np.testing.assert_array_equal(got_r[k], want_r[k])


# ---- sharded ranks and top-k against the JAX package's ----------------------

def _embs(n, d, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, d).astype(np.float32)
    p = rng.randn(n, d).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return v, p


def _exact_embs(n, seed):
    """tests/test_sharded_eval.py's exact-arithmetic rows (one-hot against
    a 1/64 grid)."""
    rng = np.random.RandomState(seed)
    return (np.eye(n, dtype=np.float32),
            (np.round(rng.randn(n, n) * 8) / 64.0).astype(np.float32))


@pytest.mark.parametrize("mode", ["query", "gallery"])
@pytest.mark.parametrize("n", [64, 100])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("data", ["random", "exact"])
def test_sharded_ranks_equal_jax(group, jax_mesh, mode, n, stream, data):
    v, p = _embs(n, 32, seed=0) if data == "random" else _exact_embs(n, 4)
    want = np.asarray(jax_sharded_ranks(jnp.asarray(v), jnp.asarray(p),
                                        jax_mesh, mode=mode,
                                        streaming=stream))
    if data == "exact":
        np.testing.assert_array_equal(
            want, np.asarray(jax_retrieval_ranks(jnp.dot(v, p.T))))
    mesh = make_mesh(device="cpu")
    got = sharded_ranks(torch.from_numpy(v), torch.from_numpy(p), mesh,
                        mode=mode, streaming=stream)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_ranks_nan_and_valid_equal_jax(group, jax_mesh):
    v, p = _exact_embs(40, seed=5)
    v[7] = np.nan
    valid = np.arange(40) % 9 != 0
    mesh = make_mesh(device="cpu")
    for mode in ("query", "gallery"):
        for stream in (False, True):
            want = np.asarray(jax_sharded_ranks(
                jnp.asarray(v), jnp.asarray(p), jax_mesh, mode=mode,
                valid=jnp.asarray(valid), streaming=stream))
            got = sharded_ranks(torch.from_numpy(v), torch.from_numpy(p),
                                mesh, mode=mode,
                                valid=torch.from_numpy(valid),
                                streaming=stream)
            np.testing.assert_array_equal(got.numpy(), want)
    assert got[7] == int(valid.sum())


@pytest.mark.parametrize("mode", ["query", "gallery"])
def test_sharded_metrics_equal_jax(group, jax_mesh, mode):
    v, p = _exact_embs(96, seed=7)
    valid = np.ones(96, bool)
    valid[[5, 31, 64]] = False
    want = jax_sharded_metrics(jnp.asarray(v), jnp.asarray(p), jax_mesh,
                               ks=(1, 5, 10), mode=mode,
                               valid=jnp.asarray(valid), return_ranks=True)
    got = sharded_retrieval_metrics(torch.from_numpy(v), torch.from_numpy(p),
                                    make_mesh(device="cpu"), ks=(1, 5, 10),
                                    mode=mode, valid=torch.from_numpy(valid),
                                    return_ranks=True)
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_ranks"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("n,k", [(100, 5), (24, 3)])  # 24: 3 rows a device
def test_sharded_topk_equals_jax(group, jax_mesh, stream, n, k):
    rng = np.random.RandomState(2)
    q = rng.randn(10, 16).astype(np.float32)
    g = rng.randn(n, 16).astype(np.float32)
    g[4] = g[2]  # a tie: the lower index first
    valid = np.ones(n, bool)
    valid[[0, n - 1]] = False
    ws, wi = jax_sharded_topk(jnp.asarray(q), jnp.asarray(g), k, jax_mesh,
                              valid=jnp.asarray(valid), streaming=stream)
    gs, gi = sharded_sim_topk(torch.from_numpy(q), torch.from_numpy(g), k,
                              make_mesh(device="cpu"),
                              valid=torch.from_numpy(valid),
                              streaming=stream)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("quantize", [False, True])
def test_sharded_prepared_topk_equals_jax(group, jax_mesh, quantize):
    """tests/test_sharded_eval.py::test_sharded_prepared_topk_matches_dense
    for both packages: exact and int8 prepared shards, N % 8 != 0, invalid
    rows of large norm that never surface."""
    rng = np.random.RandomState(21)
    n, k = 203, 7
    g = rng.randn(n, 16).astype(np.float32)
    valid = np.ones(n, bool)
    valid[[0, 50, 202]] = False
    g[~valid] *= 50.0
    q = rng.randn(5, 16).astype(np.float32)
    jprep, jrows = jax_prepare(jnp.asarray(g), jax_mesh,
                               valid=jnp.asarray(valid), quantize=quantize)
    ws, wi = jax_topk_prepared(jnp.asarray(q), jprep, k, jax_mesh,
                               shard_rows=jrows, quantized=quantize)
    mesh = make_mesh(device="cpu")
    prep, rows = prepare_sharded_topk_gallery(
        torch.from_numpy(g), mesh, valid=torch.from_numpy(valid),
        quantize=quantize)
    assert rows == n and len(prep) == 1  # this rank's one shard
    gs, gi = sharded_sim_topk_prepared(torch.from_numpy(q), prep, k, mesh,
                                       shard_rows=rows, quantized=quantize)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-6)


def test_sharded_prepared_requires_quantized_prep(group):
    g = torch.from_numpy(np.random.RandomState(3).randn(64, 8)
                         .astype(np.float32))
    mesh = make_mesh(device="cpu")
    prep, rows = prepare_sharded_topk_gallery(g, mesh)
    assert mesh.local_shards() == [(0, mesh.device)] and len(prep) == 1
    with pytest.raises(ValueError, match="quantize=True"):
        sharded_sim_topk_prepared(torch.ones(2, 8), prep, 3, mesh,
                                  shard_rows=rows, quantized=True)
    with pytest.raises(ValueError, match="unknown mode"):
        sharded_ranks(g, g, mesh, mode="rows")
