"""The port's ``.pth.tar`` interop (``cmhse_tpu_torch.interop`` and
``cli.import_torch`` / ``cli.export_torch``) against the JAX package's: a
reference replica's state dict imported by both gives the same parameters
and embeddings within 1e-5; the port's export then import returns every
tensor bit for bit; the port's export of a JAX tree equals the JAX
package's."""

import numpy as np
import pytest
import jax
import torch

from torch_replica import TorchCMHSE

from cmhse_tpu.cli.import_torch import import_checkpoint as jax_import
from cmhse_tpu.config import ModelConfig as JaxModelConfig
from cmhse_tpu.data.bucketing import BucketSpec as JaxBucketSpec
from cmhse_tpu.data.bucketing import pad_batch as jax_pad_batch
from cmhse_tpu.data.datasets import SyntheticHierarchicalDataset
from cmhse_tpu.interop import infer_model_structure as jax_infer
from cmhse_tpu.interop import state_dict_from_model_params as jax_export_sd
from cmhse_tpu.models import CMHSE as JaxCMHSE
from cmhse_tpu_torch import interop
from cmhse_tpu_torch.cli.export_torch import export_checkpoint
from cmhse_tpu_torch.cli.export_torch import main as export_main
from cmhse_tpu_torch.cli.import_torch import (import_checkpoint,
                                              load_flat_state_dict)
from cmhse_tpu_torch.cli.import_torch import main as import_main
from cmhse_tpu_torch.train.checkpoint import restore_for_eval

torch.set_num_threads(2)

VOCAB, WORD_DIM, FEAT, HIDDEN, EMBED = 50, 12, 16, 20, 24

FLAG_SETS = {
    "hier": dict(hierarchical=True),
    "flat": dict(hierarchical=False),
    "full": dict(hierarchical=True, attention_pool=True,
                 reconstruction=True),
    "bidir": dict(hierarchical=True, bidirectional=True),
}


def _replica(tmp_path, flags, seed=0):
    torch.manual_seed(seed)
    tm = TorchCMHSE(VOCAB, WORD_DIM, FEAT, HIDDEN, EMBED, **flags)
    path = str(tmp_path / "model_best.pth.tar")
    torch.save({"model": tm.state_dict(), "epoch": 3, "best_rsum": 1.0},
               path)
    return tm, path


def _inputs(hierarchical: bool, seed: int = 1):
    rng = np.random.RandomState(seed)
    b, c, f, s, w = 4, (3 if hierarchical else 1), 5, (3 if hierarchical
                                                        else 1), 6
    frames = rng.randn(b, c, f, FEAT).astype(np.float32)
    frame_len = rng.randint(1, f + 1, size=(b, c)).astype(np.int32)
    clip_len = rng.randint(1, c + 1, size=b).astype(np.int32)
    words = rng.randint(1, VOCAB, size=(b, s, w)).astype(np.int32)
    word_len = rng.randint(1, w + 1, size=(b, s)).astype(np.int32)
    sent_len = rng.randint(1, s + 1, size=b).astype(np.int32)
    return (frames, frame_len, clip_len), (words, word_len, sent_len)


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_replica_import_matches_jax_import(tmp_path, name):
    flags = FLAG_SETS[name]
    tm, path = _replica(tmp_path, flags)
    flat_sd = load_flat_state_dict(path)
    assert interop.infer_model_structure(flat_sd) == jax_infer(flat_sd)

    state, cfg = import_checkpoint(flat_sd, str(tmp_path / "port"))
    jmodel, jparams, jcfg = jax_import(flat_sd, str(tmp_path / "jax"))
    assert cfg.to_json().replace("/port", "") == \
        jcfg.to_json().replace("/jax", "")
    # the same tensors, bit for bit, as the JAX tree carried over
    want = interop.params_from_jax(jax.tree.map(np.asarray, dict(jparams)))
    assert sorted(state) == sorted(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k

    model, rcfg = restore_for_eval(str(tmp_path / "port"), device="cpu")
    assert rcfg == cfg
    video, text = _inputs(flags["hierarchical"])
    with torch.no_grad():
        v, clip = model.encode_video(*map(torch.from_numpy, video))
        p, sent = model.encode_text(*map(torch.from_numpy, text))
        tv, _ = tm.encode_video(*video)
        tp, _ = tm.encode_text(*text)
    jv, jclip = jmodel.apply({"params": jparams}, *video,
                             method=jmodel.encode_video)
    jp, jsent = jmodel.apply({"params": jparams}, *text,
                             method=jmodel.encode_text)
    for got, ref in ((v, jv), (clip, jclip), (p, jp), (sent, jsent),
                     (v, tv), (p, tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
@pytest.mark.parametrize("fmt", [".pth.tar", ".npz"])
def test_export_then_import_is_bit_exact(tmp_path, name, fmt):
    tm, path = _replica(tmp_path, FLAG_SETS[name], seed=4)
    run = str(tmp_path / "run")
    assert import_main([path, run, "--platform", "cpu"]) == 0
    out = str(tmp_path / f"back{fmt}")
    assert export_main([run, out, "--platform", "cpu"]) == 0
    # the exported file is the replica's own state dict, and loads into it
    exported = load_flat_state_dict(out)
    ref = tm.state_dict()
    assert sorted(exported) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(exported[k], ref[k].numpy())
    again = str(tmp_path / "again")
    assert import_main([out, again, "--platform", "cpu"]) == 0
    a, _ = restore_for_eval(run, device="cpu")
    b, _ = restore_for_eval(again, device="cpu")
    for (k, x), (k2, y) in zip(a.state_dict().items(),
                               b.state_dict().items()):
        assert k == k2 and torch.equal(x, y), k


def _jax_params(flags, seed=0):
    """A JAX tree as training in the JAX package makes it: CMHSE.init."""
    h = flags.get("hierarchical", True)
    mcfg = JaxModelConfig(embed_size=EMBED, word_dim=WORD_DIM, feat_dim=FEAT,
                          rnn_hidden=HIDDEN, **flags)
    model = JaxCMHSE(cfg=mcfg, vocab_size=VOCAB)
    ds = SyntheticHierarchicalDataset(num_videos=2, feat_dim=FEAT,
                                      vocab_size=VOCAB,
                                      max_clips=3 if h else 1, max_frames=4,
                                      max_words=4, seed=seed)
    spec = JaxBucketSpec(batch_size=2, max_clips=3 if h else 1, max_frames=4,
                         max_sentences=3 if h else 1, max_words=4,
                         feat_dim=FEAT)
    batch = jax_pad_batch([ds[0], ds[1]], spec)
    params = model.init(jax.random.PRNGKey(seed), batch)["params"]
    return jax.tree.map(np.asarray, dict(params))


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_port_export_of_a_jax_tree_equals_jax_export(name):
    p = _jax_params(FLAG_SETS[name])
    state = interop.params_from_jax(p)
    tree = interop.params_to_jax_tree(state)
    assert jax.tree.structure(tree) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    ours = interop.state_dict_from_model_params(tree)
    theirs = jax_export_sd(p)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype == np.float32
        assert ours[k].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(ours[k], theirs[k])
    # and back: the import of the export is the same tree
    back = interop.model_params_from_state_dict(
        ours, hierarchical="video_high" in p,
        reconstruction="video_decoder" in p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


def test_structure_mismatch_fails_with_a_readable_diff(tmp_path):
    """A text encoder narrower than the video one cannot be this model: the
    import fails at the structure check, naming both shape maps."""
    _, path = _replica(tmp_path, FLAG_SETS["hier"])
    sd = load_flat_state_dict(path)
    sd["text_low.gru.weight_hh_l0"] = sd["text_low.gru.weight_hh_l0"][:, :4]
    with pytest.raises(ValueError, match="do not match the model "
                                         "structure") as err:
        import_checkpoint(sd, str(tmp_path / "bad"))
    assert "expected:" in str(err.value) and "imported:" in str(err.value)
    assert not (tmp_path / "bad").exists()


def test_unconsumed_or_missing_tensors_are_named(tmp_path):
    _, path = _replica(tmp_path, FLAG_SETS["hier"])
    sd = load_flat_state_dict(path)
    with pytest.raises(ValueError, match="not consumed"):
        interop.model_params_from_state_dict(
            {**sd, "mystery.weight": np.zeros((2, 2), np.float32)})
    renamed = {k.replace("video_low.gru", "video_low.rnn"): v
               for k, v in sd.items()}
    with pytest.raises(ValueError, match="prefix_map"):
        interop.model_params_from_state_dict(renamed)
    # the map names the module the checkpoint uses
    moved = {k.replace("video_low.", "vid_enc."): v for k, v in sd.items()}
    state, _ = import_checkpoint(moved, str(tmp_path / "mapped"),
                                 prefix_map={"video_low": "vid_enc"})
    want, _ = import_checkpoint(sd, str(tmp_path / "plain"))
    for k in want:
        assert torch.equal(state[k], want[k])


def test_export_checks_the_extension_before_the_restore(tmp_path):
    with pytest.raises(ValueError, match="unsupported output extension"):
        export_checkpoint(str(tmp_path / "no_such_run"),
                          str(tmp_path / "out.tar"), device="cpu")


def test_unsafe_pickles_need_the_opt_in(tmp_path):
    _, path = _replica(tmp_path, FLAG_SETS["hier"])
    blob = torch.load(path, weights_only=True)
    blob["extra"] = _Opaque()
    torch.save(blob, path)
    with pytest.raises(ValueError, match="--unsafe-load"):
        load_flat_state_dict(path)
    assert len(load_flat_state_dict(path, allow_unsafe=True)) == len(
        blob["model"])


class _Opaque:
    """A pickled object that the safe loader refuses."""
