"""The port's serving lifecycle against the JAX package's ``Retriever``:
build -> add -> remove -> retrieve -> compact -> retrieve, and an online
compaction (plan, a raced remove, apply), on the same embeddings handed in
through ``encoded=`` with the same keys, the query side encoded by the same
weights. Dense, streaming, with the prepared form forced by the size rule,
and int8. Indices, ``old_to_new`` maps, ``gallery_keys``, ``n_valid`` and
``invalid_fraction`` equal; scores within 1e-5; the prepared forms' masks
and int8 rows bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmhse_tpu.eval.serve as jax_serve
from cmhse_tpu.config import DataConfig as JaxDataConfig
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu.models import CMHSE as JaxCMHSE
import cmhse_tpu_torch.eval.serve as port_serve
from cmhse_tpu_torch.config import ModelConfig
from cmhse_tpu_torch.eval import Retriever, encode_gallery_device
from cmhse_tpu_torch.eval.serve import CompactionPlan
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.data import SyntheticHierarchicalDataset, batches_from_dataset
from cmhse_tpu_torch.config import DataConfig
from tests.make_goldens import CONFIGS

torch.set_num_threads(2)
VOCAB = 64
DS = dict(num_videos=9, feat_dim=20, vocab_size=VOCAB, max_clips=3,
          max_frames=6, max_words=5, seed=3)
DATA = dict(batch_size=4, feat_dim=20, vocab_size=VOCAB, max_clips=3,
            max_frames=6, max_sentences=3, max_words=5)
K = 7


@pytest.fixture(scope="module")
def models():
    mcfg = CONFIGS["full"]
    jm = JaxCMHSE(cfg=mcfg, vocab_size=VOCAB)
    jb = next(iter(jax_batches(JaxDataset(**DS), JaxDataConfig(**DATA),
                               shuffle=False)))
    params = jm.init(jax.random.PRNGKey(9), jb)["params"]
    pm = CMHSE(ModelConfig(**dataclasses.asdict(mcfg)), VOCAB, device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, pm, mcfg.embed_size


def _segment(rng, n, e, pad, start):
    """``n`` unit rows and ``pad`` invalid tail rows, keys v<start...>; two
    rows copy others (exact ties)."""
    v = rng.randn(n + pad, e).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[n - 1] = v[0]
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    ids = np.arange(start, start + n + pad)
    keys = [f"v{start + i:04d}" for i in range(n)]
    return v, valid, ids, keys


def _encoded(seg):
    v, valid, ids, _ = seg
    return ((jnp.asarray(v), jnp.asarray(v), jnp.asarray(valid), ids),
            (torch.from_numpy(v), torch.from_numpy(v),
             torch.from_numpy(valid), ids))


def _queries():
    rng = np.random.RandomState(17)
    words = rng.randint(4, VOCAB, (5, 3, 5)).astype(np.int32)
    word_len = np.array([[5, 0, 0], [3, 0, 0], [4, 0, 0], [1, 0, 0],
                         [5, 0, 0]], np.int32)
    return words, word_len, np.ones(5, np.int32)


def _same_state(jr, pr, forms=True):
    """``forms``: the two hold prepared forms alike (not so where only the
    port's per-request rule streams: JAX's one rule also prepares)."""
    assert pr.gallery_keys == jr.gallery_keys
    assert pr.n_valid == jr.n_valid
    assert pr.invalid_fraction == jr.invalid_fraction
    np.testing.assert_array_equal(pr.gallery_valid.numpy(),
                                  np.asarray(jr.gallery_valid))
    if not forms:
        return
    assert (pr._prepared is None) == (jr._prepared is None)
    if jr._prepared is not None:
        for name in ("valid", "int8_chunks", "int8_scale"):
            want, got = getattr(jr._prepared, name), getattr(pr._prepared,
                                                             name)
            assert (got is None) == (want is None), name
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=name)
        assert pr._prepared.chunks.shape == jr._prepared.chunks.shape


def _same_answers(jr, pr, k=K):
    words, word_len, sent_len = _queries()
    js, ji = jr.retrieve(jnp.asarray(words), jnp.asarray(word_len),
                         jnp.asarray(sent_len), k=k)
    ps, pi = pr.retrieve(words, word_len, sent_len, k=k)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-5, atol=1e-5)
    return pi


MODES = {
    # (jax should_stream_topk, port should_prepare_topk, port
    # should_stream_topk, quantize): None leaves a rule as it is
    "dense": (None, None, None, False),
    "streaming": (True, None, True, False),
    "prepared": (True, True, None, False),
    "prepared_streaming": (True, True, True, False),
    "quantized": (True, True, None, True),
}


def _patch(monkeypatch, mode):
    jax_stream, port_prepare, port_stream, quantize = MODES[mode]
    if jax_stream is not None:
        monkeypatch.setattr(jax_serve, "should_stream_topk",
                            lambda n, force=None: jax_stream)
    if port_prepare is not None:
        monkeypatch.setattr(port_serve, "should_prepare_topk",
                            lambda n: port_prepare)
    if port_stream is not None:
        monkeypatch.setattr(port_serve, "should_stream_topk",
                            lambda n_queries, n_gallery: port_stream)
    return quantize


@pytest.mark.parametrize("mode", list(MODES))
def test_lifecycle_matches_jax(models, monkeypatch, mode):
    jm, params, pm, e = models
    quantize = _patch(monkeypatch, mode)
    forms = mode != "streaming"
    rng = np.random.RandomState(1)
    seg0 = _segment(rng, 300, e, 20, 0)
    seg1 = _segment(rng, 40, e, 4, 320)     # appended in place
    seg2 = _segment(rng, 800, e, 0, 364)    # passes 2x the chunk count
    jr = jax_serve.Retriever(jm, params, quantize=quantize, rescore_m=8)
    pr = Retriever(pm, quantize=quantize, rescore_m=8)
    j0, p0 = _encoded(seg0)
    jr.build_gallery(keys=seg0[3], encoded=j0)
    pr.build_gallery(keys=seg0[3], encoded=p0)
    _same_state(jr, pr, forms)
    _same_answers(jr, pr)
    for seg in (seg1, seg2):
        js, ps = _encoded(seg)
        jr.add_to_gallery(keys=seg[3], encoded=js)
        pr.add_to_gallery(keys=seg[3], encoded=ps)
        _same_state(jr, pr, forms)
        _same_answers(jr, pr)
    _same_answers(jr, pr, k=5000)  # clamped to the valid rows

    # remove: unknown keys ignored, a key on a tombstoned row and a live row
    top = list(_same_answers(jr, pr)[:, 0])
    victims = [jr.gallery_keys[i] for i in top] + ["nope", "v0003"]
    assert pr.remove_from_gallery(victims) == jr.remove_from_gallery(victims)
    _same_state(jr, pr, forms)
    again = seg1[:3] + (["v0003"] + seg1[3][1:],)  # re-add v0003, new rows
    js, ps = _encoded(again)
    jr.add_to_gallery(keys=again[3], encoded=js)
    pr.add_to_gallery(keys=again[3], encoded=ps)
    assert pr.remove_from_gallery(["v0003", "v0005"]) == \
        jr.remove_from_gallery(["v0003", "v0005"]) == 2
    assert pr.remove_from_gallery(["v0003"]) == 0
    _same_state(jr, pr, forms)
    before = _same_answers(jr, pr)

    old_to_new = pr.compact()
    np.testing.assert_array_equal(old_to_new, jr.compact())
    assert pr.invalid_fraction == 0.0
    _same_state(jr, pr, forms)
    after = _same_answers(jr, pr)
    np.testing.assert_array_equal(old_to_new[before], after)
    # compacting a fully valid gallery is the identity
    np.testing.assert_array_equal(pr.compact(), np.arange(pr.n_valid))


@pytest.mark.parametrize("mode", ["dense", "quantized"])
def test_online_compaction_replays_raced_removes(models, monkeypatch, mode):
    jm, params, pm, e = models
    quantize = _patch(monkeypatch, mode)
    rng = np.random.RandomState(2)
    seg = _segment(rng, 200, e, 10, 0)
    jr = jax_serve.Retriever(jm, params, quantize=quantize)
    pr = Retriever(pm, quantize=quantize)
    j0, p0 = _encoded(seg)
    jr.build_gallery(keys=seg[3], encoded=j0)
    pr.build_gallery(keys=seg[3], encoded=p0)
    for r in (jr, pr):
        r.remove_from_gallery(["v0010", "v0011"])
    jplan, pplan = jr.plan_compaction(), pr.plan_compaction()
    assert isinstance(pplan, CompactionPlan)
    np.testing.assert_array_equal(pplan.old_to_new, jplan.old_to_new)
    assert pplan.keys == jplan.keys
    # a remove that races the build is replayed onto the new forms
    assert pr.remove_from_gallery(["v0020"]) == \
        jr.remove_from_gallery(["v0020"]) == 1
    np.testing.assert_array_equal(pr.apply_compaction(pplan),
                                  jr.apply_compaction(jplan))
    _same_state(jr, pr)
    _same_answers(jr, pr)
    assert "v0020" in pr.gallery_keys and pr.n_valid == 197

    # a plan goes stale when the gallery grows before it is applied
    for r, enc in ((jr, _encoded(_segment(rng, 3, e, 0, 900))[0]),
                   (pr, _encoded(_segment(rng, 3, e, 0, 900))[1])):
        r.remove_from_gallery(["v0030"])
        plan = r.plan_compaction()
        r.add_to_gallery(keys=["x1", "x2", "x3"], encoded=enc)
        with pytest.raises(RuntimeError, match="plan is stale"):
            r.apply_compaction(plan)


@pytest.mark.parametrize("form", ["prepared", "streamed", "quantized"])
def test_mutators_after_a_streaming_query_on_inference_tensors(models,
                                                               monkeypatch,
                                                               form):
    """A gallery encoded under inference mode, queried on the streaming
    path (itself under inference mode: a gallery below the size rule is
    chunked there), then removed from, added to and compacted outside it:
    no tensor is updated in place, and the chunks made for the streaming
    request are dropped by every mutator."""
    _, _, pm, _ = models
    monkeypatch.setattr(port_serve, "should_prepare_topk",
                        lambda n: form != "streamed")
    monkeypatch.setattr(port_serve, "should_stream_topk",
                        lambda n_queries, n_gallery: True)
    batches = list(batches_from_dataset(SyntheticHierarchicalDataset(**DS),
                                        DataConfig(**DATA), shuffle=False))
    pr = Retriever(pm, quantize=form == "quantized")
    with torch.inference_mode():
        enc = encode_gallery_device(pm, batches, return_ids=True)
        pr.build_gallery(encoded=enc)
    assert pr.gallery.is_inference()
    assert (pr._prepared is None) == (form == "streamed")
    words, word_len, sent_len = _queries()
    _, first = pr.retrieve(words, word_len, sent_len, k=3)
    streamed = pr._streamed
    assert (streamed is not None) == (form == "streamed")
    pr.retrieve(words, word_len, sent_len, k=3)
    assert pr._streamed is streamed  # kept while the gallery stays
    assert pr.remove_from_gallery([int(enc[3][first[0, 0]])]) == 1
    assert pr._streamed is None
    pr.add_to_gallery(encoded=encode_gallery_device(pm, batches[:1],
                                                    return_ids=True),
                      keys=[f"new{i}" for i in range(4)])
    _, idx = pr.retrieve(words, word_len, sent_len, k=3)
    assert first[0, 0] not in idx[0]
    pr.compact()
    assert pr._streamed is None
    assert pr.invalid_fraction == 0.0 and pr.n_valid == 9 - 1 + 4
    _, idx = pr.retrieve(words, word_len, sent_len, k=3)
    assert idx.shape == (5, 3)
