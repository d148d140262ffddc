"""The port's data contract against the JAX package's: synthetic examples,
padded batches and the loader's order/grouping/slicing are array-equal for
the same seed and config; ``Batch.to`` and the validity masks."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cmhse_tpu.config import DataConfig as JaxDataConfig
from cmhse_tpu.data import SyntheticHierarchicalDataset as JaxDataset
from cmhse_tpu.data import batches_from_dataset as jax_batches
from cmhse_tpu_torch.config import DataConfig
from cmhse_tpu_torch.data import (Batch, SyntheticHierarchicalDataset,
                                  batches_from_dataset, pick_bucket)

torch.set_num_threads(2)

FIELDS = [f.name for f in dataclasses.fields(Batch)]
DS_ARGS = dict(num_videos=23, feat_dim=6, vocab_size=50, max_clips=4,
               max_frames=9, max_words=7, seed=3)
CFG = dict(batch_size=8, feat_dim=6, vocab_size=50, max_clips=3,
           max_frames=8, max_sentences=3, max_words=6,
           frame_buckets=(2, 4, 8), word_buckets=(3, 6))


def test_synthetic_examples_equal_jax():
    jds, pds = JaxDataset(**DS_ARGS), SyntheticHierarchicalDataset(**DS_ARGS)
    assert len(jds) == len(pds)
    for i in range(len(pds)):
        a, b = jds[i], pds[i]
        assert (a.video_id, a.key) == (b.video_id, b.key)
        assert len(a.clips) == len(b.clips)
        for x, y in zip(a.clips + a.sentences, b.clips + b.sentences):
            np.testing.assert_array_equal(x, y)
        assert jds.max_frame_len(i) == pds.max_frame_len(i)


@pytest.mark.parametrize("opts", [
    dict(shuffle=False),
    dict(shuffle=True, seed=4),
    dict(shuffle=True, seed=1, drop_last=True),
    dict(shuffle=True, seed=2, fixed_shape=False),
    dict(shuffle=True, seed=2, fixed_shape=False, group_by_length=True),
    dict(shuffle=True, seed=5, process_index=1, process_count=2),
])
def test_batches_equal_jax(opts):
    got = list(batches_from_dataset(SyntheticHierarchicalDataset(**DS_ARGS),
                                    DataConfig(**CFG), **opts))
    want = list(jax_batches(JaxDataset(**DS_ARGS), JaxDataConfig(**CFG),
                            **opts))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for name in FIELDS:
            a, b = getattr(g, name), np.asarray(getattr(w, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(g.clip_valid(), np.asarray(w.clip_valid()))
        np.testing.assert_array_equal(g.sent_valid(), np.asarray(w.sent_valid()))


def test_batch_to_device_keeps_values_and_masks():
    b = next(batches_from_dataset(SyntheticHierarchicalDataset(**DS_ARGS),
                                  DataConfig(**CFG), shuffle=False))
    t = b.to("cpu")
    for name in FIELDS:
        assert isinstance(getattr(t, name), torch.Tensor)
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(b, name))
    assert t.frames.dtype == torch.float32 and t.valid.dtype == torch.bool
    np.testing.assert_array_equal(t.clip_valid().numpy(), b.clip_valid())
    np.testing.assert_array_equal(t.sent_valid().numpy(), b.sent_valid())


def test_pick_bucket_clamps():
    assert [pick_bucket(v, (2, 4, 8)) for v in (1, 2, 3, 8, 99)] == \
        [2, 2, 4, 8, 8]


# ---- the training loop's data: datasets, vocabulary, word vectors ----------

CORR_ARGS = dict(num_videos=13, feat_dim=6, vocab_size=60, max_clips=4,
                 max_frames=9, max_words=7, num_topics=5, seed=2)


def _assert_examples_equal(jds, pds):
    assert len(jds) == len(pds) > 0
    for i in range(len(pds)):
        a, b = jds[i], pds[i]
        assert (a.video_id, a.key) == (b.video_id, b.key)
        assert len(a.clips) == len(b.clips) == len(b.sentences)
        for x, y in zip(a.clips + a.sentences, b.clips + b.sentences):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert jds.max_frame_len(i) == pds.max_frame_len(i)


@pytest.mark.parametrize("base_seed", [1234, 7])
def test_correlated_synthetic_equal_jax(base_seed):
    from cmhse_tpu.data import CorrelatedSyntheticDataset as JaxCorrelated
    from cmhse_tpu_torch.data import CorrelatedSyntheticDataset

    jds = JaxCorrelated(base_seed=base_seed, **CORR_ARGS)
    pds = CorrelatedSyntheticDataset(base_seed=base_seed, **CORR_ARGS)
    np.testing.assert_array_equal(jds.prototypes, pds.prototypes)
    _assert_examples_equal(jds, pds)
    cfg = dict(CFG, vocab_size=60)
    got = list(batches_from_dataset(pds, DataConfig(**cfg), seed=3))
    want = list(jax_batches(jds, JaxDataConfig(**cfg), seed=3))
    for g, w in zip(got, want):
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(g, name),
                                          np.asarray(getattr(w, name)))


def _reference_dir(tmp_path, layout):
    """write_reference_dataset's h5 layout, or the same arrays as one .npy
    a video under features/ (the layout used where h5py is absent)."""
    import h5py

    from tests.reference_layout import write_reference_dataset

    root = str(tmp_path / "data")
    info = write_reference_dataset(root, n_train=7, n_val=3, feat_dim=5,
                                   seed=4)
    if layout == "npy":
        os.makedirs(os.path.join(root, "features"))
        for split, keys in info["keys"].items():
            path = os.path.join(root, f"{split}_features.h5")
            with h5py.File(path, "r") as f:
                for k in keys:
                    np.save(os.path.join(root, "features", f"{k}.npy"),
                            np.asarray(f[k]["c3d_features"]))
            os.remove(path)
    return root


@pytest.mark.parametrize("layout", ["h5", "npy"])
@pytest.mark.parametrize("flat", [False, True])
def test_precomp_dataset_equal_jax(tmp_path, layout, flat):
    import json

    from cmhse_tpu.data.datasets import PrecompDataset as JaxPrecomp
    from cmhse_tpu.data.vocab import build_vocab as jax_build_vocab
    from cmhse_tpu_torch.data import PrecompDataset, build_vocab

    root = _reference_dir(tmp_path, layout)
    with open(os.path.join(root, "train_captions.json")) as f:
        caps = [s for v in json.load(f).values() for s in v["sentences"]]
    vocab, jvocab = build_vocab(caps, threshold=1), jax_build_vocab(
        caps, threshold=1)
    assert vocab.word2idx == jvocab.word2idx
    for split in ("train", "val"):
        jds = JaxPrecomp(root, split, jvocab, feat_dim=5, flat=flat)
        pds = PrecompDataset(root, split, vocab, feat_dim=5, flat=flat)
        assert pds.keys == jds.keys
        _assert_examples_equal(jds, pds)


@pytest.mark.parametrize("caption", [
    "A man runs in the park.",
    "the dog, quickly -- jumps; over 3 logs!",
    "Two sentences here. And a second one?",
])
def test_tokenize_and_vocab_equal_jax(caption, tmp_path):
    from cmhse_tpu.data.vocab import Vocabulary as JaxVocabulary
    from cmhse_tpu.data.vocab import build_vocab as jax_build_vocab
    from cmhse_tpu.data.vocab import tokenize as jax_tokenize
    from cmhse_tpu.data.vocab import tokenizer_backend as jax_backend
    from cmhse_tpu_torch.data import Vocabulary, build_vocab, tokenize
    from cmhse_tpu_torch.data.vocab import tokenizer_backend

    assert tokenizer_backend() == jax_backend()
    assert tokenize(caption) == jax_tokenize(caption)
    corpus = [caption, caption.upper(), "a b c"]
    vocab, jvocab = build_vocab(corpus, 1), jax_build_vocab(corpus, 1)
    assert vocab.word2idx == jvocab.word2idx
    assert vocab.encode(caption) == jvocab.encode(caption)
    assert vocab.encode("zzz unseen", add_bos_eos=False) == \
        jvocab.encode("zzz unseen", add_bos_eos=False)
    for name in ("vocab.json", "vocab.pkl"):  # files either package wrote
        jvocab.save(str(tmp_path / name))
        assert Vocabulary.load(str(tmp_path / name)).word2idx == \
            vocab.word2idx
        vocab.save(str(tmp_path / ("port_" + name)))
        assert JaxVocabulary.load(str(tmp_path / ("port_" + name))
                                  ).word2idx == vocab.word2idx


@pytest.mark.parametrize("fmt", ["bin", "txt", "npz"])
def test_word_vectors_and_embedding_table_equal_jax(tmp_path, fmt):
    from cmhse_tpu.data.vocab import Vocabulary as JaxVocabulary
    from cmhse_tpu.data.word_vectors import \
        init_embedding_table as jax_init_table
    from cmhse_tpu.data.word_vectors import load_word_vectors as jax_load
    from cmhse_tpu_torch.data import Vocabulary
    from cmhse_tpu_torch.data.word_vectors import (init_embedding_table,
                                                   load_word_vectors)
    from tests.reference_layout import write_word2vec_bin

    words = ["dog", "runs", "fast", "zebra"]
    path = str(tmp_path / f"vectors.{fmt}")
    if fmt == "bin":
        write_word2vec_bin(path, words, dim=6, seed=1)
    else:
        rng = np.random.RandomState(1)
        vecs = rng.randn(len(words), 6).astype(np.float32)
        if fmt == "npz":
            np.savez(path, words=np.array(words), vectors=vecs)
        else:
            with open(path, "w") as f:
                f.write(f"{len(words)} 6\n")
                for w, v in zip(words, vecs):
                    f.write(w + " " + " ".join(map(str, v)) + " \n")
    got, want = load_word_vectors(path), jax_load(path)
    assert got.keys() == want.keys()
    for w in got:
        np.testing.assert_array_equal(got[w], want[w])
    vocab, jvocab = Vocabulary(), JaxVocabulary()
    for w in ("dog", "fast", "cat"):
        vocab.add_word(w)
        jvocab.add_word(w)
    base = np.random.RandomState(2).randn(10, 6).astype(np.float32)
    for kw in (dict(seed=3), dict(base_table=base)):
        table, hits = init_embedding_table(vocab, got, 6, **kw)
        jtable, jhits = jax_init_table(jvocab, want, 6, **kw)
        assert hits == jhits == 2
        np.testing.assert_array_equal(table, jtable)


def test_apply_pretrained_embeddings_writes_the_port_table(tmp_path):
    from cmhse_tpu_torch.config import ModelConfig
    from cmhse_tpu_torch.data import Vocabulary
    from cmhse_tpu_torch.data.word_vectors import (
        apply_pretrained_embeddings, load_word_vectors)
    from cmhse_tpu_torch.models import CMHSE
    from tests.reference_layout import write_word2vec_bin

    path = str(tmp_path / "v.bin")
    write_word2vec_bin(path, ["dog", "cat"], dim=12, seed=5)
    vocab = Vocabulary()
    for w in ("dog", "runs"):
        vocab.add_word(w)
    model = CMHSE(ModelConfig(embed_size=16, word_dim=12, feat_dim=6,
                              rnn_hidden=16), 10, device="cpu")
    before = model.word_embedding.embedding.detach().clone()
    assert apply_pretrained_embeddings(model, vocab, path) == 1
    table = model.word_embedding.embedding.detach()
    np.testing.assert_array_equal(table[vocab("dog")].numpy(),
                                  load_word_vectors(path)["dog"])
    assert torch.equal(table[vocab("runs")], before[vocab("runs")])
    assert not table[0].any()  # <pad> zeroed, as the JAX table's is


# ---- host-to-device: Batch.to and the prefetch on the CPU ------------------

def test_batch_to_same_device_copies_nothing():
    b = next(batches_from_dataset(SyntheticHierarchicalDataset(**DS_ARGS),
                                  DataConfig(**CFG), shuffle=False))
    t = b.to("cpu")
    assert t.frames.data_ptr() == b.frames.__array_interface__["data"][0]
    again = t.to("cpu", non_blocking=True)
    for name in FIELDS:
        assert getattr(again, name) is getattr(t, name)


def test_prefetch_on_cpu_hands_batches_over_as_they_are():
    from cmhse_tpu_torch.data import Prefetcher

    batches = list(batches_from_dataset(
        SyntheticHierarchicalDataset(**DS_ARGS), DataConfig(**CFG),
        shuffle=False))
    items = [(i, b) for i, b in enumerate(batches)]
    out = list(Prefetcher("cpu")(items, batch_of=lambda it: it[1]))
    assert [it for it, _ in out] == items
    assert all(b is batches[i] for (i, _), b in out)
