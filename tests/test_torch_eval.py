"""The serving and scoring path on the CPU against the JAX package's:
``validate_metrics`` (dense and streaming) gives the same metrics and rank
vectors, and ``Retriever`` answers both directions with the same indices,
on a gallery with padding rows and JAX weights carried into the port."""

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
from cmhse_tpu.eval.encode import encode_data as jax_encode_data
from cmhse_tpu.eval.encode import encode_gallery_device as jax_encode_gallery
from cmhse_tpu.eval.retrieval import format_table as jax_format_table
from cmhse_tpu.eval.retrieval import validate_metrics as jax_validate
from cmhse_tpu.models import CMHSE as JaxCMHSE
import cmhse_tpu_torch.eval.serve as port_serve
from cmhse_tpu_torch.config import DataConfig, ModelConfig
from cmhse_tpu_torch.data import SyntheticHierarchicalDataset, batches_from_dataset
from cmhse_tpu_torch.eval import (Retriever, encode_data,
                                  encode_gallery_device, format_table,
                                  text_query_batch, validate_metrics)
from cmhse_tpu_torch.models import CMHSE
from tests.make_goldens import CONFIGS

torch.set_num_threads(2)
DS = dict(num_videos=19, feat_dim=20, vocab_size=64, max_clips=3,
          max_frames=6, max_words=5, seed=2)
DATA = dict(batch_size=8, feat_dim=20, vocab_size=64, max_clips=3,
            max_frames=6, max_sentences=3, max_words=5)


@pytest.fixture(scope="module")
def setup():
    mcfg = CONFIGS["full"]
    jm = JaxCMHSE(cfg=mcfg, vocab_size=64)
    jb = list(jax_batches(JaxDataset(**DS), JaxDataConfig(**DATA),
                          shuffle=False))
    params = jm.init(jax.random.PRNGKey(5), jb[0])["params"]
    pm = CMHSE(ModelConfig(**dataclasses.asdict(mcfg)), 64, device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, pm


def _port_batches():
    return batches_from_dataset(SyntheticHierarchicalDataset(**DS),
                                DataConfig(**DATA), shuffle=False)


def _jax_batches():
    return jax_batches(JaxDataset(**DS), JaxDataConfig(**DATA), shuffle=False)


@pytest.mark.parametrize("streaming", [False, True])
def test_validate_metrics_match_jax(setup, streaming):
    jm, params, pm = setup
    want, want_ranks = jax_validate(jm, params, _jax_batches(),
                                    streaming=streaming, return_ranks=True)
    got, got_ranks = validate_metrics(pm, _port_batches(),
                                      streaming=streaming, return_ranks=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for k in want_ranks:
        assert len(got_ranks[k]) == DS["num_videos"]
        np.testing.assert_array_equal(got_ranks[k], want_ranks[k])
    assert format_table(got) == jax_format_table(want)


def test_encode_paths_match_jax(setup):
    jm, params, pm = setup
    jv, jp, jvalid, jids = jax_encode_gallery(jm, params, _jax_batches(),
                                              return_ids=True)
    v, p, valid, ids = encode_gallery_device(pm, _port_batches(),
                                             return_ids=True)
    assert v.shape[0] == 24 and int(valid.sum()) == DS["num_videos"]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5)
    want = jax_encode_data(jm, params, _jax_batches(), return_low_level=True)
    got = encode_data(pm, _port_batches(), return_low_level=True)
    for a, b in zip(got[:3] + tuple(got[3]), want[:3] + tuple(want[3])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("streaming", [False, True])
def test_retriever_both_directions_match_jax(setup, monkeypatch, streaming):
    jm, params, pm = setup
    if streaming:  # engage the chunked path on a tiny gallery: JAX's one
        # size rule; the port's size rule (a prepared form held) and its
        # per-request memory rule
        monkeypatch.setattr(jax_serve, "should_stream_topk",
                            lambda n, force=None: True)
        monkeypatch.setattr(port_serve, "should_prepare_topk", lambda n: True)
        monkeypatch.setattr(port_serve, "should_stream_topk",
                            lambda n_queries, n_gallery: True)
    jenc = jax_encode_gallery(jm, params, _jax_batches(), return_ids=True)
    penc = encode_gallery_device(pm, _port_batches(), return_ids=True)
    q = next(_port_batches())
    for side in ("video", "text"):
        jr, pr = jax_serve.Retriever(jm, params), Retriever(pm)
        jr.build_gallery(encoded=jenc, side=side)
        pr.build_gallery(encoded=penc, side=side)
        for k in (5, 50):  # 50 > valid rows: clamped, padding never shows
            if side == "video":
                want = jr.retrieve(jnp.asarray(q.words), jnp.asarray(q.word_len),
                                   jnp.asarray(q.sent_len), k=k)
                got = pr.retrieve(q.words, q.word_len, q.sent_len, k=k)
            else:
                want = jr.retrieve_video(jnp.asarray(q.frames),
                                         jnp.asarray(q.frame_len),
                                         jnp.asarray(q.clip_len), k=k)
                got = pr.retrieve_video(q.frames, q.frame_len, q.clip_len,
                                        k=k)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
            assert got[1].shape[1] == min(k, DS["num_videos"])
        assert (pr._prepared is not None) == streaming


def test_text_query_batch_matches_jax():
    class Vocab:
        def encode(self, text):
            return [4 + len(w) for w in text.split()] + [2]

    texts = ["a man rides a horse", "", "one two three four five six seven"]
    got = text_query_batch(Vocab(), texts, 3, 5)
    want = jax_serve.text_query_batch(Vocab(), texts, 3, 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_retriever_needs_a_gallery(setup):
    _, _, pm = setup
    with pytest.raises(RuntimeError):
        Retriever(pm).retrieve(np.zeros((1, 3, 5), np.int32),
                               np.ones((1, 3), np.int32),
                               np.ones(1, np.int32))
