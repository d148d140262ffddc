"""Datasets, counterpart of ``cmhse_tpu/data/datasets.py``: the two
synthetic generators and the reference-layout ``PrecompDataset``. For the
same seed and files each yields array-equal examples to the JAX package's
(pinned by tests/test_torch_data.py).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from cmhse_tpu_torch.data.vocab import Vocabulary


@dataclass
class RaggedExample:
    """One ragged video-paragraph pair, pre-padding."""

    video_id: int
    clips: list  # list of [n_frames, feat_dim] float32 arrays
    sentences: list  # list of [n_words] int32 token-id arrays
    key: str = ""  # dataset-level string id


class SyntheticHierarchicalDataset:
    """Deterministic ragged data for tests and the chip smoke run.

    Raggedness mimics ActivityNet Captions: 1-``max_clips`` clips per video,
    ragged frame counts per clip, sentence lengths correlated with nothing.
    """

    def __init__(
        self,
        num_videos: int = 100,
        feat_dim: int = 500,
        vocab_size: int = 1000,
        max_clips: int = 8,
        max_frames: int = 64,
        max_words: int = 32,
        seed: int = 0,
    ) -> None:
        self.num_videos = num_videos
        self.feat_dim = feat_dim
        self.vocab_size = vocab_size
        self.max_clips = max_clips
        self.max_frames = max_frames
        self.max_words = max_words
        self.seed = seed

    def __len__(self) -> int:
        return self.num_videos

    def __getitem__(self, idx: int) -> RaggedExample:
        if not 0 <= idx < self.num_videos:
            raise IndexError(idx)
        rng = np.random.RandomState(self.seed * 1_000_003 + idx)
        n_clips = int(rng.randint(1, self.max_clips + 1))
        clips, sentences = [], []
        for _ in range(n_clips):
            nf = int(rng.randint(4, self.max_frames + 1))
            clips.append(rng.randn(nf, self.feat_dim).astype(np.float32))
            nw = int(rng.randint(3, self.max_words + 1))
            sentences.append(
                rng.randint(4, self.vocab_size, size=nw).astype(np.int32)
            )
        return RaggedExample(video_id=idx, clips=clips, sentences=sentences,
                             key=f"synthetic_{idx}")

    def max_frame_len(self, idx: int) -> int:
        """Cheap length probe for length-grouped batching."""
        rng = np.random.RandomState(self.seed * 1_000_003 + idx)
        n_clips = int(rng.randint(1, self.max_clips + 1))
        best = 0
        for _ in range(n_clips):
            nf = int(rng.randint(4, self.max_frames + 1))
            rng.randn(nf, self.feat_dim)
            nw = int(rng.randint(3, self.max_words + 1))
            rng.randint(4, self.vocab_size, size=nw)
            best = max(best, nf)
        return best


class CorrelatedSyntheticDataset:
    """Learnable synthetic video-paragraph pairs with shared latent topics.

    ``SyntheticHierarchicalDataset`` draws video features and text tokens
    independently, so retrieval on it can only be memorization. This
    generator gives the two modalities SHARED structure — each clip/sentence
    pair samples a latent topic; frames are noisy copies of the topic's
    feature prototype and tokens are drawn mostly from the topic's vocabulary
    band — so a model trained on one split generalizes to held-out videos.
    The JAX package uses it for its convergence-evidence harness
    (tests/test_convergence.py, scripts/convergence_demo.py), and the port
    to drive ``fit`` at full width where real ActivityNet/DiDeMo features
    are not at hand: a model trained on it learns a cross-modal embedding,
    not just memorisation.

    Length distributions mimic ActivityNet Captions: clips per video from a
    clipped Poisson(3.65) (the dataset's mean sentences/paragraph), ragged
    frame and word counts.

    Topic prototypes depend only on ``base_seed``, so train/val splits built
    with different ``seed`` but one ``base_seed`` share the SAME underlying
    concept space with disjoint videos.
    """

    def __init__(
        self,
        num_videos: int = 100,
        feat_dim: int = 64,
        vocab_size: int = 1000,
        max_clips: int = 8,
        max_frames: int = 16,
        max_words: int = 16,
        num_topics: int = 20,
        noise: float = 0.6,
        topic_word_frac: float = 0.7,
        seed: int = 0,
        base_seed: int = 1234,
    ) -> None:
        if vocab_size < 4 + 2 * num_topics:
            raise ValueError("vocab too small for the topic bands")
        self.num_videos = num_videos
        self.feat_dim = feat_dim
        self.vocab_size = vocab_size
        self.max_clips = max_clips
        self.max_frames = max_frames
        self.max_words = max_words
        self.num_topics = num_topics
        self.noise = noise
        self.topic_word_frac = topic_word_frac
        self.seed = seed
        proto_rng = np.random.RandomState(base_seed)
        self.prototypes = proto_rng.randn(num_topics, feat_dim).astype(
            np.float32
        )
        # vocabulary layout: ids [4, 4+common) are shared filler words, the
        # rest is split into equal per-topic bands
        self.n_common = max(1, (vocab_size - 4) // 4)
        band_space = vocab_size - 4 - self.n_common
        self.band = max(1, band_space // num_topics)

    def __len__(self) -> int:
        return self.num_videos

    def _video_rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed + 7) * 2_000_003 + idx * 7919
        )

    def _sample_structure(self, rng):
        """(topics, frame_counts, word_counts) for one video."""
        n_clips = int(np.clip(rng.poisson(3.65), 1, self.max_clips))
        topics = rng.randint(0, self.num_topics, size=n_clips)
        nf = rng.randint(4, self.max_frames + 1, size=n_clips)
        nw = rng.randint(3, self.max_words + 1, size=n_clips)
        return topics, nf, nw

    def __getitem__(self, idx: int) -> RaggedExample:
        if not 0 <= idx < self.num_videos:
            raise IndexError(idx)
        rng = self._video_rng(idx)
        topics, nfs, nws = self._sample_structure(rng)
        clips, sentences = [], []
        for k, nf, nw in zip(topics, nfs, nws):
            frames = self.prototypes[k][None, :] + self.noise * rng.randn(
                int(nf), self.feat_dim
            ).astype(np.float32)
            clips.append(frames.astype(np.float32))
            band_lo = 4 + self.n_common + int(k) * self.band
            topic_words = rng.randint(band_lo, band_lo + self.band, size=nw)
            common_words = rng.randint(4, 4 + self.n_common, size=nw)
            use_topic = rng.rand(nw) < self.topic_word_frac
            sentences.append(
                np.where(use_topic, topic_words, common_words).astype(np.int32)
            )
        return RaggedExample(video_id=idx, clips=clips, sentences=sentences,
                             key=f"correlated_{idx}")

    def max_frame_len(self, idx: int) -> int:
        """Cheap length probe for length-grouped batching (no feature I/O)."""
        rng = self._video_rng(idx)
        _, nfs, _ = self._sample_structure(rng)
        return int(nfs.max())


class PrecompDataset:
    """Precomputed C3D features + tokenized captions (reference ``data.py``).

    Segments each video's frame-feature matrix by the caption timestamps, so
    clip k aligns with sentence k (the hierarchy contract the low-level loss
    relies on). Features come from ``{split}_features.h5`` (a dataset, or a
    group holding one, per video id; ``h5py`` is imported only then) or, when
    there is no such file, from ``features/{key}.npy``; captions from
    ``{split}_captions.json`` mapping id -> {"timestamps": [[s, e], ...],
    "sentences": [...], "duration": d}.
    """

    def __init__(
        self,
        data_path: str,
        split: str,
        vocab: Vocabulary,
        feat_dim: int = 500,
        flat: bool = False,
    ) -> None:
        """``flat=True`` emits ONE clip (the whole feature matrix) and ONE
        sentence (the paragraph joined) per video — the VSE-style input of
        the non-hierarchical FSE baseline (BASELINE config 1)."""
        self.data_path = data_path
        self.split = split
        self.vocab = vocab
        self.feat_dim = feat_dim
        self.flat = flat
        cap_path = os.path.join(data_path, f"{split}_captions.json")
        with open(cap_path) as f:
            self.captions: dict = json.load(f)
        self.keys = sorted(self.captions)
        # cache-coherence contract for eval.serve.key_index: ``keys`` is
        # immutable after construction; any subclass/caller that DOES
        # mutate it in place must bump this counter
        self.keys_version = 0
        self._h5 = None
        self._h5_path = os.path.join(data_path, f"{split}_features.h5")
        self._npy_dir = os.path.join(data_path, "features")

    def __len__(self) -> int:
        return len(self.keys)

    def _h5_node(self, key: str):
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self._h5_path, "r")
        node = self._h5[key]
        # the ActivityNet-challenge C3D release nests the matrix in a group
        # (e.g. f[key]['c3d_features']); take the group's first dataset
        if hasattr(node, "keys"):
            node = node[next(iter(node.keys()))]
        return node

    def _load_features(self, key: str) -> np.ndarray:
        if os.path.exists(self._h5_path):
            return np.asarray(self._h5_node(key), np.float32)
        return np.load(
            os.path.join(self._npy_dir, f"{key}.npy")
        ).astype(np.float32)

    def _feature_rows(self, key: str) -> int:
        """Row count of a video's feature matrix WITHOUT reading the data
        (h5 dataset shape / npy header via mmap)."""
        if os.path.exists(self._h5_path):
            return int(self._h5_node(key).shape[0])
        arr = np.load(
            os.path.join(self._npy_dir, f"{key}.npy"), mmap_mode="r"
        )
        return int(arr.shape[0])

    def max_frame_len(self, idx: int) -> int:
        """Cheap length probe for length-grouped batching."""
        key = self.keys[idx]
        meta = self.captions[key]
        n = self._feature_rows(key)
        if self.flat:
            return n
        duration = float(meta.get("duration", n))
        best = 1
        for start, end in meta["timestamps"]:
            s = max(0, min(n - 1, int(round(start / duration * n))))
            e = max(s + 1, min(n, int(round(end / duration * n))))
            best = max(best, e - s)
        return best

    def __getitem__(self, idx: int) -> RaggedExample:
        key = self.keys[idx]
        meta = self.captions[key]
        feats = self._load_features(key)  # [T, feat_dim]
        if self.flat:
            # Per-sentence tokenization, then concatenate ids under ONE
            # <start>/<end> frame. This is byte-identical to the reference's
            # ``word_tokenize(joined_paragraph)`` WHEN Punkt recovers the
            # original sentence boundaries (its job), and it sidesteps the
            # sentence splitter entirely — the captions json already carries
            # the ground-truth boundaries. Joining first was the one
            # remaining id-divergence path on Punkt-less images: the
            # treebank backend keeps sentence-final periods attached
            # mid-paragraph.
            ids = [self.vocab(Vocabulary.START)]
            for sent in meta["sentences"]:
                ids.extend(self.vocab.encode(sent, add_bos_eos=False))
            ids.append(self.vocab(Vocabulary.END))
            return RaggedExample(
                video_id=idx, clips=[feats],
                sentences=[np.asarray(ids, np.int32)],
                key=key,
            )
        duration = float(meta.get("duration", len(feats)))
        n = feats.shape[0]
        clips, sentences = [], []
        for (start, end), sent in zip(meta["timestamps"], meta["sentences"]):
            s = max(0, min(n - 1, int(round(start / duration * n))))
            e = max(s + 1, min(n, int(round(end / duration * n))))
            clips.append(feats[s:e])
            sentences.append(np.asarray(self.vocab.encode(sent), np.int32))
        return RaggedExample(video_id=idx, clips=clips, sentences=sentences,
                             key=key)
