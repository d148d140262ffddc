"""The port's Retriever over a mesh, against the JAX package's.

The port's local mesh (one process, shard i on ``devices[i]``; here 8 CPU
shards) holds a gallery the way the JAX ``Retriever(mesh=)`` does on
conftest's 8-device CPU mesh. On the same numpy-seeded weights (carried
through ``load_jax_params``) and the same batches, ``retrieve`` returns
the same indices and scores within rtol 1e-5 / atol 1e-6 after a build, an
add in two parts, a remove and a compaction, exact and int8
(``tests/test_sharded_eval.py::test_retriever_mesh_prepared_paths``). Then
the mesh's own rules: the local form's shape rules and shards, a gallery
smaller than k a shard, the compaction's ``shard_rows`` with a raced
remove replayed a shard, and the refusals of the paths that keep one card
a process (sharded ranks, validation, the data-parallel step)."""

import jax
import numpy as np
import pytest
import torch

import cmhse_tpu.eval.serve as jax_serve
from cmhse_tpu.config import DataConfig as JaxDataConfig
from cmhse_tpu.config import ExperimentConfig as JaxExperimentConfig
from cmhse_tpu.config import ModelConfig as JaxModelConfig
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu.models import CMHSE as JaxCMHSE
from cmhse_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cmhse_tpu.train import create_train_state as jax_create_train_state
import cmhse_tpu_torch.eval.serve as port_serve
from cmhse_tpu_torch.config import ExperimentConfig
from cmhse_tpu_torch.data import (SyntheticHierarchicalDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.eval import Retriever, validate_metrics
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.ops.topk import dense_sim_topk
from cmhse_tpu_torch.parallel import (local_devices, local_rows, make_mesh,
                                      place_batch, place_state,
                                      prepare_sharded_topk_gallery,
                                      sharded_ranks,
                                      sharded_retrieval_metrics,
                                      sharded_sim_topk,
                                      sharded_sim_topk_prepared)
from cmhse_tpu_torch.parallel import mesh as mesh_mod
from cmhse_tpu_torch.parallel import train_dp
from cmhse_tpu_torch.train import create_train_state

torch.set_num_threads(2)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
K = 6


def _cfg():
    """tests/test_sharded_eval.py::test_retriever_mesh_prepared_paths's."""
    return JaxExperimentConfig(
        data=JaxDataConfig(batch_size=8, feat_dim=8, vocab_size=64,
                           max_clips=2, max_frames=4, max_sentences=2,
                           max_words=4),
        model=JaxModelConfig(embed_size=16, word_dim=8, feat_dim=8,
                             rnn_hidden=16))


DS = dict(num_videos=13, feat_dim=8, vocab_size=64, max_clips=2,
          max_frames=4, max_words=4)


@pytest.fixture(scope="module")
def setup():
    """JAX model, params and batches; the port's model on the same weights
    and its batches of the same dataset."""
    jcfg = _cfg()
    jbatches = list(jax_batches(JaxDataset(**DS), jcfg.data, shuffle=False))
    params = jax_create_train_state(jcfg, jax.random.PRNGKey(0),
                                    jbatches[0]).params
    jm = JaxCMHSE(cfg=jcfg.model, vocab_size=jcfg.data.vocab_size)
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    pm = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, params))
    pbatches = list(batches_from_dataset(SyntheticHierarchicalDataset(**DS),
                                         cfg.data, shuffle=False))
    for jb, pb in zip(jbatches, pbatches):
        np.testing.assert_array_equal(np.asarray(pb.words),
                                      np.asarray(jb.words))
    return {"jm": jm, "params": params, "jb": jbatches, "pm": pm,
            "pb": pbatches, "jmesh": jax_make_mesh((-1,), ("data",)),
            "mesh": make_mesh(devices=local_devices("cpu"))}


def _query(setup):
    b = setup["jb"][0]
    return np.asarray(b.words), np.asarray(b.word_len), np.asarray(b.sent_len)


def _same(jr, pr, setup, k=K):
    js, ji = jr.retrieve(*_query(setup), k=k)
    ps, pi = pr.retrieve(*_query(setup), k=k)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(ps, np.asarray(js), **SCORE_TOL)
    return pi


FORMS = {
    # (prepared: both packages' size rules forced, quantize)
    "sharded": (False, False),
    "prepared": (True, False),
    "quantized": (True, True),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_retriever_mesh_matches_jax(setup, monkeypatch, form):
    """Build at once, add in two parts, remove (the per-shard masks
    updated in place, removed keys never surface), compact: the JAX
    ``Retriever(mesh=)``'s indices and scores at each stage."""
    prepared, quantize = FORMS[form]
    if prepared:
        monkeypatch.setattr(jax_serve, "should_stream_topk",
                            lambda n, force=None: True)
        monkeypatch.setattr(port_serve, "should_prepare_topk", lambda n: True)
    jm, params, mesh = setup["jm"], setup["params"], setup["mesh"]

    def both():
        return (jax_serve.Retriever(jm, params, mesh=setup["jmesh"],
                                    quantize=quantize),
                Retriever(setup["pm"], mesh=mesh, quantize=quantize))

    jr, pr = both()
    jr.build_gallery(setup["jb"])
    pr.build_gallery(setup["pb"])
    if prepared:
        assert len(pr._prepared) == mesh.data_size == 8
        assert pr._prepared_shard_rows == jr._prepared_shard_rows
        assert all((p.int8_chunks is not None) == quantize
                   for p in pr._prepared)
    else:
        assert pr._prepared is None and jr._prepared is None
    ref = _same(jr, pr, setup)

    # continuous ingest: two adds serve as the gallery built at once
    jg, pg = both()
    for part in (slice(0, 1), slice(1, None)):
        jg.add_to_gallery(setup["jb"][part])
        pg.add_to_gallery(setup["pb"][part])
    assert pg.gallery_keys == jg.gallery_keys
    np.testing.assert_array_equal(_same(jg, pg, setup), ref)

    # tombstones: the per-shard masks change, not the chunks
    top_keys = {pg.gallery_keys[int(j)] for j in ref[:, 0]}
    chunks = [p.chunks for p in pg._prepared] if prepared else None
    assert pg.remove_from_gallery(top_keys) == len(top_keys)
    assert jg.remove_from_gallery(top_keys) == len(top_keys)
    if prepared:
        assert all(p.chunks is c for p, c in zip(pg._prepared, chunks))
    after = _same(jg, pg, setup)
    gone = {int(j) for j in ref[:, 0]}
    assert not set(int(x) for x in after.ravel()) & gone

    # compaction: the same map, and the same answers from the new shards
    np.testing.assert_array_equal(pg.compact(), jg.compact())
    assert pg.gallery_keys == jg.gallery_keys
    assert pg._prepared_shard_rows == jg._prepared_shard_rows
    _same(jg, pg, setup)


def test_compaction_plan_carries_shard_rows_and_replays_a_raced_remove(
        setup, monkeypatch):
    """plan -> a remove during the build -> apply: the plan holds the new
    shards' row count, and the raced row is tombstoned again in its own
    shard of the new forms (JAX's answers after the same sequence)."""
    monkeypatch.setattr(jax_serve, "should_stream_topk",
                        lambda n, force=None: True)
    monkeypatch.setattr(port_serve, "should_prepare_topk", lambda n: True)
    jr = jax_serve.Retriever(setup["jm"], setup["params"],
                             mesh=setup["jmesh"])
    pr = Retriever(setup["pm"], mesh=setup["mesh"])
    jr.build_gallery(setup["jb"])
    pr.build_gallery(setup["pb"])
    keys = [k for k in pr.gallery_keys if k is not None]
    for r in (jr, pr):
        r.remove_from_gallery(keys[:2])
    jplan, pplan = jr.plan_compaction(), pr.plan_compaction()
    assert pplan.shard_rows == jplan.shard_rows
    assert pplan.shard_rows == -(-pplan.gallery.shape[0] // 8)
    ref = _same(jr, pr, setup)
    raced = pr.gallery_keys[int(ref[0, 0])]
    for r in (jr, pr):
        assert r.remove_from_gallery([raced]) == 1
    np.testing.assert_array_equal(pr.apply_compaction(pplan),
                                  jr.apply_compaction(jplan))
    assert pr._prepared_shard_rows == pplan.shard_rows
    new_row = pr.gallery_keys.index(raced)
    shard, slot = divmod(new_row, pplan.shard_rows)
    assert not bool(pr._prepared[shard].valid.reshape(-1)[slot])
    assert pr.n_valid == jr.n_valid
    after = _same(jr, pr, setup)
    assert new_row not in set(int(x) for x in after.ravel())


# ---- the local mesh's rules -------------------------------------------------

def test_local_mesh_rules():
    cpu = local_devices("cpu")
    assert cpu == [torch.device("cpu")] * mesh_mod.CPU_SHARDS
    assert len(local_devices("cpu", n=3)) == 3
    mesh = make_mesh(devices=cpu[:4])
    assert mesh.shape == {"data": 4} and mesh.group is None
    assert mesh.is_local and mesh.data_size == 4
    assert mesh.local_shards() == list(enumerate(cpu[:4]))
    one = make_mesh(devices=cpu[:1])
    assert not one.is_local and one.local_shards() == [(0, cpu[0])]
    with pytest.raises(ValueError, match="do not divide"):
        make_mesh((3, -1), ("data", "model"), devices=cpu[:4])
    with pytest.raises(ValueError, match="'data' only"):
        make_mesh((2, 2), ("data", "model"), devices=cpu[:4])
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh((8,), ("data",), devices=cpu[:4])
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh(devices=[])
    # the shards' rows, gathered in shard order onto devices[0]
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    got = mesh_mod.gather_shards(parts, mesh)
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  [0, 0, 1, 1, 2, 2, 3, 3])


def test_local_devices_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_devices("gpu")


def test_local_mesh_refused_under_a_group_of_two(monkeypatch):
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        make_mesh(devices=local_devices("cpu", n=2))


@pytest.mark.parametrize("n,k", [(24, 5), (5, 3), (13, 4)])
@pytest.mark.parametrize("prepared", [False, True])
def test_gallery_smaller_than_k_per_shard(n, k, prepared):
    """``tests/test_sharded_eval.py::
    test_sharded_topk_gallery_smaller_than_k_per_shard``: 8 shards of 3,
    1 and 2 rows (padding) against k = 5, 3, 4; the dense top-k's indices,
    tie order included, and its scores."""
    rng = np.random.RandomState(n + k)
    q = torch.from_numpy(rng.randn(7, 16).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, 16).astype(np.float32))
    g[2] = g[1]  # a tie: the lower index first
    valid = torch.ones(n, dtype=torch.bool)
    valid[0] = False
    mesh = make_mesh(devices=local_devices("cpu"))
    ws, wi = dense_sim_topk(q, g, valid, k)
    if prepared:
        prep, rows = prepare_sharded_topk_gallery(g, mesh, valid=valid)
        assert len(prep) == 8 and rows == -(-n // 8)
        gs, gi = sharded_sim_topk_prepared(q, prep, k, mesh, rows)
    else:
        gs, gi = sharded_sim_topk(q, g, k, mesh, valid=valid)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_allclose(gs.numpy(), ws.numpy(), **SCORE_TOL)


def test_prepared_shards_must_match_the_mesh():
    mesh = make_mesh(devices=local_devices("cpu", n=4))
    g = torch.from_numpy(np.random.RandomState(3).randn(40, 8)
                         .astype(np.float32))
    prep, rows = prepare_sharded_topk_gallery(g, mesh)
    with pytest.raises(ValueError, match="3 prepared shards for the 4"):
        sharded_sim_topk_prepared(g[:2], prep[:3], 3, mesh, rows)
    with pytest.raises(ValueError, match="quantize=True"):
        sharded_sim_topk_prepared(g[:2], prep, 3, mesh, rows, quantized=True)


def test_one_card_a_process_paths_refuse_a_local_mesh():
    """Sharded ranks, validation and the data-parallel step keep one card
    a process: a local mesh of several devices is a ValueError there,
    never a wrong answer."""
    mesh = make_mesh(devices=local_devices("cpu", n=2))
    v = torch.eye(8)
    with pytest.raises(ValueError, match="one card a process"):
        sharded_ranks(v, v, mesh)
    with pytest.raises(ValueError, match="one card a process"):
        sharded_retrieval_metrics(v, v, mesh)
    cfg = ExperimentConfig.from_json(_cfg().to_json())
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu")
    batches = list(batches_from_dataset(SyntheticHierarchicalDataset(**DS),
                                        cfg.data, shuffle=False))
    with pytest.raises(ValueError, match="one card a process"):
        validate_metrics(model, iter(batches), mesh=mesh)
    state = create_train_state(cfg, model)
    for call in (lambda: place_state(state, mesh),
                 lambda: local_rows(batches[0], mesh),
                 lambda: place_batch(batches[0], mesh),
                 lambda: train_dp.all_reduce_gradients([v], mesh)):
        with pytest.raises(ValueError, match="one card a process"):
            call()
    from cmhse_tpu_torch.train import train_step

    with pytest.raises(ValueError, match="one card a process"):
        train_step(state, batches[0], cfg.loss, mesh=mesh)


def test_sharded_serving_is_refused_under_torchrun(monkeypatch):
    """``--sharded`` serves from one process over the local devices:
    under torchrun with more than one rank (each would hold every shard)
    the commands refuse, before loading anything."""
    from cmhse_tpu_torch.cli import retrieve, serve_daemon, sharded_mesh

    assert sharded_mesh("cpu").data_size == mesh_mod.CPU_SHARDS
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="without torchrun"):
        sharded_mesh("cpu")
    with pytest.raises(SystemExit, match="without torchrun"):
        retrieve.main(["no_such_run", "--query", "x", "--sharded",
                       "--platform", "cpu"])
    with pytest.raises(SystemExit, match="without torchrun"):
        serve_daemon.build_context("no_such_run", None, "val", sharded=True,
                                   device="cpu")
