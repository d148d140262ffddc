"""The port's data parallelism over 2 gloo ranks (CPU processes), against
one rank and against the JAX package's 8-device mesh.

One spawn of two ranks (``tests/torch_dist_worker.py``) runs every check,
since starting the processes is most of the cost:

* the data-parallel step at golden width, with weights carried from JAX,
  against JAX's 8-device DP step (``tests/test_train_dp.py``'s band), and
  the two ranks' parameters bit-equal;
* the idle ``model`` axis, mesh (1, 2), against one rank;
* sharded ranks, metrics and top-k (exact and int8 prepared) in both
  modes, dense and streaming, equal to one rank's exactly, ties included;
* ``Retriever(mesh=)``, a shard a rank, below the size rule and held
  prepared (exact and int8), after a build, a remove and a compaction:
  the single process's indices, and its scores within rtol 1e-5;
* ``fit`` over 2 ranks against 1 (``tests/test_multihost.py``'s
  two-process fit): losses within rtol 1e-5, rsum within 1e-6, one
  ``log.jsonl`` without duplicate records, rank 0 alone writing the
  checkpoints and ``best``, and ``best`` restoring to the same parameters;
* the GRU wrappers called while all-reduces across the ranks are in
  flight, equal to a quiet run.

``scripts/multi_gpu_check.py`` runs the same worker over NCCL, a card a
rank, at full width.

Every join has a timeout; each rank's faulthandler watchdog fires just
before it.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from cmhse_tpu.config import (DataConfig as JaxDataConfig,
                              ExperimentConfig as JaxExperimentConfig,
                              LossConfig as JaxLossConfig,
                              ModelConfig as JaxModelConfig)
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cmhse_tpu.parallel.train_dp import place_batch, place_state
from cmhse_tpu.train import create_train_state as jax_create_train_state
from cmhse_tpu.train import train_step as jax_train_step
from cmhse_tpu_torch.config import ExperimentConfig
from cmhse_tpu_torch.data import Batch, SyntheticHierarchicalDataset
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.parallel import make_mesh
from cmhse_tpu_torch.train import create_train_state, train_step
from cmhse_tpu_torch.train.checkpoint import restore_for_eval
from cmhse_tpu_torch.train.loop import fit
from tests import torch_dist_worker

torch.set_num_threads(2)
WORLD = 2
JOIN_S = 110
DP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_train_dp.py's band


def _jax_cfg():
    """tests/test_train_dp.py's tiny config (E = H = 32)."""
    return JaxExperimentConfig(
        name="tiny",
        data=JaxDataConfig(batch_size=16, feat_dim=24, vocab_size=128,
                           max_clips=3, max_frames=6, max_sentences=3,
                           max_words=6),
        model=JaxModelConfig(embed_size=32, word_dim=16, feat_dim=24,
                             rnn_hidden=32, hierarchical=True),
        loss=JaxLossConfig(),
    )


def _fit_cfg(run_dir):
    """The port's fit config: golden widths, 2 epochs of 2 steps, a
    validation at every epoch's end and one mid-epoch."""
    cfg = ExperimentConfig.from_json(_jax_cfg().to_json())
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=8), train=dataclasses.replace(
        cfg.train, num_epochs=2, checkpoint_dir=run_dir, log_step=1,
        val_step=3, lr=1e-3))


def _exact_embs(n, seed):
    """One-hot queries against a 1/64 grid, as tests/test_sharded_eval.py
    makes them: every similarity exact in f32, and many tie."""
    rng = np.random.RandomState(seed)
    v = np.eye(n, dtype=np.float32)
    p = (np.round(rng.randn(n, n) * 8) / 64.0).astype(np.float32)
    return torch.from_numpy(v), torch.from_numpy(p)


def _busy_inputs(rng, b, t, h):
    """GRU operands for the worker's ``_busy``: a ragged batch with an
    empty row, and the all-reduced buffers' length."""
    lengths = rng.randint(0, t + 1, b).astype(np.int32)
    lengths[0] = 0

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32))

    return {"xw": f32(b, t, 3 * h), "w_h": f32(h, 3 * h, scale=h ** -0.5),
            "b_h": f32(3 * h, scale=0.1), "lengths": torch.from_numpy(lengths),
            "douts": f32(b, t, h), "floats": 1 << 12}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Inputs written, 2 ranks run, their results and the inputs back."""
    workdir = tmp_path_factory.mktemp("dist")
    jcfg = _jax_cfg()
    ds = JaxDataset(num_videos=32, feat_dim=24, vocab_size=128, max_clips=3,
                    max_frames=6, max_words=6)
    batches = list(jax_batches(ds, jcfg.data, shuffle=False))
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(0), batches[0])
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu")
    model.load_jax_params(jax.tree.map(np.asarray, jstate.params))
    v, p = _exact_embs(60, seed=4)
    v_nan = v.clone()
    v_nan[7] = float("nan")
    rng = np.random.RandomState(21)
    g = np.round(rng.randn(203, 16) * 8) / 64.0
    g[[3, 9]] = g[[4, 10]]  # duplicate rows: tied scores
    gvalid = np.ones(203, bool)
    gvalid[[0, 50, 202]] = False
    inputs = {
        "cfg": cfg.to_json(),
        "init": model.state_dict(),
        "batches": [{f.name: torch.as_tensor(np.asarray(getattr(b, f.name)))
                     for f in dataclasses.fields(Batch)} for b in batches],
        "v": v, "p": p, "v_nan": v_nan,
        "valid": torch.from_numpy(np.arange(60) % 9 != 0),
        "q": torch.from_numpy((np.round(rng.randn(5, 16) * 8) / 64.0)
                              .astype(np.float32)),
        "g": torch.from_numpy(g.astype(np.float32)),
        "gvalid": torch.from_numpy(gvalid), "k": 7,
        "fit_cfg": _fit_cfg(str(workdir / "run")).to_json(),
        "fit_train": (32, 0), "fit_val": (16, 1),
        "busy": _busy_inputs(rng, b=6, t=5, h=8),
    }
    torch.save(inputs, workdir / "inputs.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, WORLD, str(workdir))) for r in range(WORLD)]
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(JOIN_S)
    finally:
        hung = [proc for proc in procs if proc.is_alive()]
        for proc in hung:
            proc.kill()
            proc.join(5)
    codes = [proc.exitcode for proc in procs]
    assert not hung and codes == [0] * WORLD, f"rank exit codes {codes}"
    results = [torch.load(workdir / f"result_{r}.pt", weights_only=False)
               for r in range(WORLD)]
    return {"results": results, "inputs": inputs, "batches": batches,
            "jcfg": jcfg, "workdir": workdir}


def test_dp_step_over_2_ranks_matches_jax_8_device_dp(spawned):
    """tests/test_train_dp.py::test_dp_step_matches_single_device's JAX run
    against the port's over 2 gloo ranks from the same weights."""
    jcfg, batches = spawned["jcfg"], spawned["batches"]
    mesh = jax_make_mesh((-1,), ("data",))
    s8 = place_state(jax_create_train_state(jcfg, jax.random.PRNGKey(0),
                                            batches[0]), mesh)
    for b in batches:
        s8, _ = jax_train_step(s8, place_batch(b, mesh), jcfg.loss)
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    want = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu")
    want.load_jax_params(jax.tree.map(np.asarray, s8.params))
    r0, r1 = (r["dp"][0] for r in spawned["results"])
    for name, w in want.state_dict().items():
        assert torch.equal(r0[name], r1[name]), name  # replicas agree
        np.testing.assert_allclose(r0[name].numpy(), w.numpy(), **DP_TOL,
                                   err_msg=name)


def test_idle_model_axis_matches_one_rank(spawned):
    """Mesh (1, 2): the batch over ``data`` (one shard), replicas along
    ``model``; the same parameters as one rank's steps (the JAX 2-D mesh
    test's band) and the same losses."""
    inputs = spawned["inputs"]
    cfg = ExperimentConfig.from_json(inputs["cfg"])
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu")
    model.load_state_dict(inputs["init"])
    state = create_train_state(cfg, model)
    losses = []
    for b in inputs["batches"]:
        state, m = train_step(state, Batch(**b), cfg.loss)
        losses.append(float(m["loss"]))
    for r in spawned["results"]:
        params, got_losses, _ = r["idle"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-6)
        for name, w in model.state_dict().items():
            np.testing.assert_allclose(params[name].numpy(), w.numpy(),
                                       **DP_TOL, err_msg=name)


def _one_rank_eval(inputs):
    mesh = make_mesh(device="cpu")
    assert mesh.group is None and mesh.shape == {"data": 1}
    return torch_dist_worker._sharded_eval(inputs, mesh)


def test_sharded_eval_over_2_ranks_equals_one_rank(spawned):
    """Ranks (both modes, dense and streaming, NaN positive and validity),
    the metrics and every top-k's indices: exactly one rank's, ties
    included, on both ranks."""
    want = _one_rank_eval(spawned["inputs"])
    for r in spawned["results"]:
        assert torch_dist_worker.eval_differences(r["eval"], want) == []
    masked = want["ranks_masked/query/False"]
    assert int(masked[7]) == int(spawned["inputs"]["valid"].sum())


def test_retriever_mesh_over_2_ranks_equals_one_process(spawned):
    want = torch_dist_worker._retriever(spawned["inputs"],
                                        torch.device("cpu"))
    for r in spawned["results"]:
        assert torch_dist_worker.retriever_differences(
            r["retriever"], want) == []


def _read_log(run_dir):
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_fit_over_2_ranks_matches_one_rank(spawned, tmp_path):
    """tests/test_multihost.py's two-process fit, for the port: the same
    loss and rsum trajectory as one rank, one log.jsonl with no duplicate
    record, rank 0 the only writer, and ``best`` restoring to the same
    parameters."""
    inputs, results = spawned["inputs"], spawned["results"]
    mp_run = ExperimentConfig.from_json(inputs["fit_cfg"]).train \
        .checkpoint_dir
    sp_cfg = _fit_cfg(str(tmp_path / "sp_run"))

    def ds(n, seed):
        return SyntheticHierarchicalDataset(
            num_videos=n, feat_dim=sp_cfg.data.feat_dim,
            vocab_size=sp_cfg.data.vocab_size,
            max_clips=sp_cfg.data.max_clips,
            max_frames=sp_cfg.data.max_frames,
            max_words=sp_cfg.data.max_words, seed=seed)

    _, sp_best = fit(sp_cfg, ds(*inputs["fit_train"]), ds(*inputs["fit_val"]),
                     device="cpu")
    assert results[1]["fit"]["writes"] == []
    assert "best" in results[0]["fit"]["writes"]
    for r in results:
        assert r["fit"]["best_rsum"] == pytest.approx(sp_best, rel=1e-6)
    for name, w in results[0]["fit"]["params"].items():
        assert torch.equal(results[1]["fit"]["params"][name], w), name

    mp_log, sp_log = _read_log(mp_run), _read_log(sp_cfg.train.checkpoint_dir)
    mp_steps = [r for r in mp_log if r["event"] == "train_step"]
    sp_steps = [r for r in sp_log if r["event"] == "train_step"]
    assert len(mp_steps) == len(sp_steps) == 8
    keys = [(r["epoch"], r["step"]) for r in mp_steps]
    assert len(set(keys)) == len(keys), f"duplicate records: {keys}"
    np.testing.assert_allclose([r["loss"] for r in mp_steps],
                               [r["loss"] for r in sp_steps], rtol=1e-5)
    mp_val = [r["rsum"] for r in mp_log if r["event"] == "validate"]
    sp_val = [r["rsum"] for r in sp_log if r["event"] == "validate"]
    assert len(mp_val) == len(sp_val) >= 3
    np.testing.assert_allclose(mp_val, sp_val, rtol=1e-6)

    mp_model, _ = restore_for_eval(mp_run, device="cpu")
    sp_model, _ = restore_for_eval(sp_cfg.train.checkpoint_dir, device="cpu")
    for (name, a), b in zip(mp_model.state_dict().items(),
                            sp_model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_gru_beside_in_flight_all_reduces_equals_quiet_run(spawned):
    """K1's two forwards and K2 (their plain versions on the CPU) enqueued
    while three asynchronous all-reduces run: the quiet run's bits, and
    every buffer summed over both ranks."""
    for r in spawned["results"]:
        assert r["busy"]["equal"]
        assert r["busy"]["reduced"] == [float(WORLD)] * 3
