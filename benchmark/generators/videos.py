"""The ``videos`` generator: a training split of ragged video-paragraph
pairs, from a traffic mix (``benchmark/traffic/<mix>.json``) whose
``"kind"`` is ``"videos"``. Each video draws a length class (``classes``,
by ``weight``), then its clip count (sentences = clips), each clip's frame
count and each sentence's word count from that class's distributions.
Features come from one draw on the device, held in host memory; token ids
from one numpy draw.

Sizes come from the mix's fixed ``shape_seed`` and the run's seed only
orders them: every seed trains the same set of video lengths, in another
order, with its own features and tokens. So a seed does not change the
amount of work, only which work.

A distribution is ``{"dist": "uniform", "min", "max"}`` (integers, both
ends included), ``{"dist": "poisson", "lam", "offset", "min", "max"}``
(``offset + Poisson(lam)``, clipped) or ``{"dist": "normal", "mean",
"sd", "min", "max"}`` (rounded, clipped).

A generator is a module of ``benchmark/generators/`` named by a mix's
``"kind"``; a runner finds it with ``common.load_module("generators",
kind)``. This one offers ``split(mix, seed, feat_dim, vocab_size, ...)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FIRST_WORD_ID = 4  # ids 0..3: <pad>, <start>, <end>, <unk>


def draw(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` integers from a distribution spec (see the module docstring)."""
    kind = spec["dist"]
    if kind == "uniform":
        out = rng.integers(spec["min"], spec["max"] + 1, size=n)
    elif kind == "poisson":
        out = spec.get("offset", 0) + rng.poisson(spec["lam"], size=n)
    elif kind == "normal":
        out = np.rint(rng.normal(spec["mean"], spec["sd"], size=n))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(out, spec["min"], spec["max"]).astype(np.int64)


def _classes(rng, mix: dict, n: int) -> np.ndarray:
    weights = np.asarray([c.get("weight", 1.0) for c in mix["classes"]],
                         np.float64)
    return rng.choice(len(weights), size=n, p=weights / weights.sum())


def shape_rng(mix: dict, *salt: int) -> np.random.Generator:
    """The generator of the mix's sizes: its ``shape_seed`` (and
    ``salt``), the same for every run."""
    return np.random.default_rng([int(mix["shape_seed"]), *salt])


def _regroup(counts: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Indices that list the items of groups ``order`` (group ``g`` holds
    ``counts[g]`` consecutive items) one group after another."""
    off = np.concatenate([[0], np.cumsum(counts)])
    return np.concatenate([np.arange(off[g], off[g + 1]) for g in order]) \
        if len(order) else np.zeros(0, np.int64)


def _per_item(rng, mix: dict, cls: np.ndarray, key: str,
              counts: np.ndarray) -> np.ndarray:
    """For each item ``i`` (of class ``cls[i]``), ``counts[i]`` draws of the
    class's ``key`` distribution, flattened in item order."""
    owner = np.repeat(np.arange(len(counts)), counts)
    out = np.empty(len(owner), np.int64)
    for c, spec in enumerate(mix["classes"]):
        sel = cls[owner] == c
        out[sel] = draw(rng, spec[key], int(sel.sum()))
    return out


@dataclasses.dataclass
class Example:
    """One ragged pair, as the program's loader takes it."""

    video_id: int
    clips: list
    sentences: list


class VideoSplit:
    """A training split held in host memory. ``__getitem__`` hands out
    views of one feature array and one token array."""

    def __init__(self, features: np.ndarray, frame_off: np.ndarray,
                 frames: np.ndarray, clip_off: np.ndarray, tokens: np.ndarray,
                 word_off: np.ndarray, words: np.ndarray) -> None:
        self.features, self.tokens = features, tokens
        self.frame_off, self.frames = frame_off, frames
        self.word_off, self.words = word_off, words
        self.clip_off = clip_off
        self._max_frames = np.maximum.reduceat(frames, clip_off[:-1])

    def __len__(self) -> int:
        return len(self.clip_off) - 1

    def max_frame_len(self, i: int) -> int:
        return int(self._max_frames[i])

    def __getitem__(self, i: int) -> Example:
        if not 0 <= i < len(self):
            raise IndexError(i)
        lo, hi = int(self.clip_off[i]), int(self.clip_off[i + 1])
        clips = [self.features[self.frame_off[c]:self.frame_off[c]
                               + self.frames[c]] for c in range(lo, hi)]
        sents = [self.tokens[self.word_off[c]:self.word_off[c]
                             + self.words[c]] for c in range(lo, hi)]
        return Example(video_id=i, clips=clips, sentences=sents)


def split(mix: dict, seed: int, feat_dim: int, vocab_size: int,
                torch=None, device=None, n_videos: int | None = None
                ) -> VideoSplit:
    """The mix's split from ``seed``: lengths from the mix's ``shape_seed``
    in an order from ``seed``, tokens from numpy, the features in one draw
    with a generator on ``device`` (numpy where ``device`` is None),
    copied to host memory once."""
    rng = np.random.default_rng(seed)
    n = int(n_videos or mix["videos"])
    srng = shape_rng(mix, n)
    cls = _classes(srng, mix, n)
    clips = np.empty(n, np.int64)
    for c, spec in enumerate(mix["classes"]):
        sel = cls == c
        clips[sel] = draw(srng, spec["clips"], int(sel.sum()))
    frames = _per_item(srng, mix, cls, "frames", clips)
    words = _per_item(srng, mix, cls, "words", clips)
    order = rng.permutation(n)
    per_clip = _regroup(clips, order)
    clips, frames, words = clips[order], frames[per_clip], words[per_clip]
    tokens = rng.integers(FIRST_WORD_ID, vocab_size, size=int(words.sum()),
                          dtype=np.int32)
    total = int(frames.sum())
    if device is None:
        features = rng.standard_normal((total, feat_dim), dtype=np.float32)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        features = np.empty((total, feat_dim), np.float32)
        step = max(1, (64 << 20) // (4 * feat_dim))
        for s in range(0, total, step):
            block = torch.randn((min(step, total - s), feat_dim),
                                generator=gen, device=device)
            features[s:s + block.shape[0]] = block.cpu().numpy()
    clip_off = np.concatenate([[0], np.cumsum(clips)])
    frame_off = np.concatenate([[0], np.cumsum(frames)[:-1]])
    word_off = np.concatenate([[0], np.cumsum(words)[:-1]])
    return VideoSplit(features, frame_off, frames, clip_off, tokens,
                      word_off, words)

