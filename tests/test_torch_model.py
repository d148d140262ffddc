"""The whole slice on the CPU: JAX params initialised at ``PRNGKey(123)``
(as tests/make_goldens.py does) and carried by ``params_from_jax``; the
port's ``encode_video`` / ``encode_text`` match the JAX model within 1e-5
and reproduce the stored goldens (embeddings and exact ranks) for flat,
hier and full."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cmhse_tpu.config import ModelConfig as JaxModelConfig
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu.models import CMHSE as JaxCMHSE
from cmhse_tpu_torch.config import ModelConfig
from cmhse_tpu_torch.interop import params_from_jax
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.ops.ranking import retrieval_ranks
from cmhse_tpu_torch.ops.similarity import cosine_sim, l2norm
from tests.make_goldens import CONFIGS, DATA, DATA_FLAT, GOLDEN_PATH

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
LIVE = dict(CONFIGS, bidir_mean=JaxModelConfig(
    embed_size=32, word_dim=16, feat_dim=20, rnn_hidden=32,
    hierarchical=True, bidirectional=True, readout="mean"))


def _jax_batch(name):
    flat = name == "flat"
    ds = JaxDataset(num_videos=8, feat_dim=20, vocab_size=64,
                    max_clips=1 if flat else 3, max_frames=6, max_words=5,
                    seed=7)
    return next(iter(jax_batches(ds, DATA_FLAT if flat else DATA,
                                 shuffle=False)))


def _models(name):
    mcfg = LIVE[name]
    batch = _jax_batch(name)
    jm = JaxCMHSE(cfg=mcfg, vocab_size=DATA.vocab_size)
    params = jm.init(jax.random.PRNGKey(123), batch)["params"]
    pm = CMHSE(ModelConfig(**dataclasses.asdict(mcfg)), DATA.vocab_size,
               device="cpu")
    pm.load_jax_params(jax.tree.map(np.asarray, params))
    return jm, params, pm, batch


def _port_encode(pm, batch):
    t = {k: torch.from_numpy(np.asarray(getattr(batch, k)))
         for k in ("frames", "frame_len", "clip_len", "words", "word_len",
                   "sent_len")}
    with torch.no_grad():
        v, clip = pm.encode_video(t["frames"], t["frame_len"], t["clip_len"])
        p, sent = pm.encode_text(t["words"], t["word_len"], t["sent_len"])
    return v, p, clip, sent


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(GOLDEN_PATH))


@pytest.mark.parametrize("name", ["flat", "hier", "full"])
def test_goldens_reproduced(goldens, name):
    _, _, pm, batch = _models(name)
    v, p, _, _ = _port_encode(pm, batch)
    np.testing.assert_allclose(v.numpy(), goldens[f"{name}_video_emb"], **TOL)
    np.testing.assert_allclose(p.numpy(), goldens[f"{name}_para_emb"], **TOL)
    sims = cosine_sim(v, p)
    np.testing.assert_array_equal(retrieval_ranks(sims).numpy(),
                                  goldens[f"{name}_ranks_v2p"])
    np.testing.assert_array_equal(retrieval_ranks(sims.T).numpy(),
                                  goldens[f"{name}_ranks_p2v"])


@pytest.mark.parametrize("name", sorted(LIVE))
def test_encode_matches_live_jax(name):
    jm, params, pm, batch = _models(name)
    jv, jclip = jm.apply({"params": params}, batch.frames, batch.frame_len,
                         batch.clip_len, method=JaxCMHSE.encode_video)
    jp, jsent = jm.apply({"params": params}, batch.words, batch.word_len,
                         batch.sent_len, method=JaxCMHSE.encode_text)
    for got, want in zip(_port_encode(pm, batch), (jv, jp, jclip, jsent)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_jax_keys_and_layout():
    _, params, pm, _ = _models("full")
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    for side in ("video_decoder", "text_decoder"):
        for name in ("init.weight", "init.bias", "w_i", "w_h", "b_i", "b_h",
                     "out.weight", "out.bias"):
            assert f"{side}.{name}" in sd
    assert set(sd) == set(pm.state_dict())
    np.testing.assert_array_equal(
        sd["text_decoder.init.weight"],
        np.asarray(params["text_decoder"]["init"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["video_decoder.w_h"], np.asarray(params["video_decoder"]["w_h"]))
    kernel = np.asarray(params["video_low"]["attn_pool"]["proj"]["kernel"])
    np.testing.assert_array_equal(sd["video_low.attn_pool.proj.weight"],
                                  kernel.T)
    np.testing.assert_array_equal(sd["video_low.gru.fwd_w_h"],
                                  np.asarray(params["video_low"]["gru"]
                                             ["fwd_w_h"]))


def test_flat_model_refuses_multi_clip_batches():
    pm = CMHSE(ModelConfig(**dataclasses.asdict(CONFIGS["flat"])), 64,
               device="cpu")
    with pytest.raises(ValueError):
        pm.encode_video(torch.zeros(2, 3, 4, 20), torch.ones(2, 3,
                                                             dtype=torch.int32),
                        torch.ones(2, dtype=torch.int32))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CMHSE(ModelConfig(**dataclasses.asdict(CONFIGS["hier"])), 64)


def test_seeded_init_and_l2norm():
    cfg = ModelConfig(**dataclasses.asdict(CONFIGS["full"]))
    a = CMHSE(cfg, 64, device="cpu", generator=torch.Generator().manual_seed(9))
    b = CMHSE(cfg, 64, device="cpu", generator=torch.Generator().manual_seed(9))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    z = l2norm(torch.zeros(2, 5))
    assert torch.equal(z, torch.zeros(2, 5))
    assert torch.allclose(l2norm(torch.tensor([[3.0, 4.0]])),
                          torch.tensor([[0.6, 0.8]]))
