"""The port's reference-layout fixtures (``cmhse_tpu_torch.data.fixtures``)
against the JAX package's: the same captions and feature arrays for the same
seed; the npy layout read by both packages' ``PrecompDataset`` as the h5
layout is; ``find_vocab`` resolving as the JAX one does."""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from cmhse_tpu.data import fixtures as jax_fixtures
from cmhse_tpu.data.datasets import PrecompDataset as JaxPrecompDataset
from cmhse_tpu.data.vocab import Vocabulary as JaxVocabulary
from cmhse_tpu.data.vocab import find_vocab as jax_find_vocab
from cmhse_tpu_torch.data import PrecompDataset, Vocabulary, build_vocab
from cmhse_tpu_torch.data import fixtures
from cmhse_tpu_torch.data.vocab import find_vocab

torch.set_num_threads(2)

FEAT = 6


def _h5_arrays(path: str) -> dict:
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]["c3d_features"]) for k in f}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_h5_layout_matches_jax_fixture(tmp_path, seed):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    info = fixtures.write_reference_dataset(ours, n_train=5, n_val=4,
                                            feat_dim=FEAT, seed=seed)
    want = jax_fixtures.write_reference_dataset(theirs, n_train=5, n_val=4,
                                                feat_dim=FEAT, seed=seed)
    assert info == want
    for split in ("train", "val"):
        name = f"{split}_captions.json"
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read()
        got = _h5_arrays(os.path.join(ours, f"{split}_features.h5"))
        exp = _h5_arrays(os.path.join(theirs, f"{split}_features.h5"))
        assert sorted(got) == sorted(exp) == info["keys"][split]
        for k in exp:
            np.testing.assert_array_equal(got[k], exp[k])


@pytest.mark.parametrize("ranges", [{}, {"clips": (1, 9), "rows": (4, 65)}])
def test_npy_layout_reads_as_the_h5_layout_in_both_packages(tmp_path,
                                                            ranges):
    h5_dir, npy_dir = str(tmp_path / "h5"), str(tmp_path / "npy")
    fixtures.write_reference_dataset(h5_dir, n_train=4, n_val=6,
                                     feat_dim=FEAT, seed=5, **ranges)
    fixtures.write_reference_dataset(npy_dir, n_train=4, n_val=6,
                                     feat_dim=FEAT, seed=5, features="npy",
                                     **ranges)
    assert not os.path.exists(os.path.join(npy_dir, "val_features.h5"))
    with open(os.path.join(npy_dir, "val_captions.json")) as f:
        captions = json.load(f)
    vocab = build_vocab([s for m in captions.values()
                         for s in m["sentences"]], threshold=1)
    vocab.save(os.path.join(npy_dir, "vocab.json"))
    jvocab = JaxVocabulary.load(os.path.join(npy_dir, "vocab.json"))
    lo, hi = ranges.get("clips", (1, 4))
    rlo, rhi = ranges.get("rows", (2, 5))
    for flat in (False, True):
        want = PrecompDataset(h5_dir, "val", vocab, feat_dim=FEAT, flat=flat)
        for ds in (PrecompDataset(npy_dir, "val", vocab, feat_dim=FEAT,
                                  flat=flat),
                   JaxPrecompDataset(npy_dir, "val", jvocab, feat_dim=FEAT,
                                     flat=flat)):
            assert ds.keys == want.keys
            for i in range(len(want)):
                a, b = ds[i], want[i]
                assert a.key == b.key and a.video_id == b.video_id
                assert ds.max_frame_len(i) == want.max_frame_len(i)
                assert len(a.clips) == len(b.clips)
                for x, y in zip(a.clips + a.sentences,
                                b.clips + b.sentences):
                    np.testing.assert_array_equal(x, y)
                if not flat:
                    assert lo <= len(b.clips) < hi
                    assert all(rlo <= len(c) < rhi for c in b.clips)


def test_write_word2vec_bin_matches_jax(tmp_path):
    words = ["man", "runs", "park"]
    fixtures.write_word2vec_bin(str(tmp_path / "a.bin"), words, dim=5)
    jax_fixtures.write_word2vec_bin(str(tmp_path / "b.bin"), words, dim=5)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()


def test_unknown_feature_layout_is_refused(tmp_path):
    with pytest.raises(ValueError, match="features must be"):
        fixtures.write_reference_dataset(str(tmp_path), features="hdf")


def test_find_vocab_resolution_matches_jax(tmp_path):
    """The cases of tests/test_dress_rehearsal.py::test_find_vocab_resolution,
    through both packages' find_vocab."""
    d = str(tmp_path)
    vocab = build_vocab(["a man runs"] * 2, threshold=1)
    for fn in (find_vocab, jax_find_vocab):
        with pytest.raises(FileNotFoundError, match="cmhse-vocab"):
            fn(d)
    steps = [("anet_precomp_vocab.pkl", "anet_precomp_vocab.pkl"),
             ("vocab.pkl", "/vocab.pkl"), ("vocab.json", "/vocab.json")]
    for name, suffix in steps:
        vocab.save(os.path.join(d, name))
        assert find_vocab(d) == jax_find_vocab(d)
        assert find_vocab(d).endswith(suffix)
    assert find_vocab(d, "explicit.pkl") == jax_find_vocab(
        d, "explicit.pkl") == "explicit.pkl"
    assert Vocabulary.load(find_vocab(d)).word2idx == vocab.word2idx
