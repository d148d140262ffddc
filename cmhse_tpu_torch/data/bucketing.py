"""Length-bucketed padding: ragged examples -> fixed-shape masked batches.

Counterpart of ``cmhse_tpu/data/bucketing.py`` (numpy, host side). Shapes are
static per bucket and raggedness is carried by the length fields, so the
batches are array-equal to the JAX package's for the same examples; bf16
``frames`` are bit-equal to its ``feature_dtype="bfloat16"`` batches.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

import torch

from cmhse_tpu_torch.data.batch import Batch

FEATURE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class BucketSpec:
    """Static shape caps for one bucket.

    ``feature_dtype``: dtype of the emitted ``frames``: ``"float32"`` (a
    numpy array) or ``"bfloat16"`` (a CPU ``torch.bfloat16`` tensor, since
    numpy has no bf16 without ``ml_dtypes``), for bf16 models: half the
    bytes to copy to the card, and the same values, since such a model
    rounds its inputs to bf16 at once.
    """

    batch_size: int
    max_clips: int
    max_frames: int
    max_sentences: int
    max_words: int
    feat_dim: int
    feature_dtype: str = "float32"

    @property
    def signature(self) -> tuple:
        return (
            self.batch_size,
            self.max_clips,
            self.max_frames,
            self.max_sentences,
            self.max_words,
            self.feat_dim,
            self.feature_dtype,
        )

    def __post_init__(self):
        if self.feature_dtype not in FEATURE_DTYPES:
            raise ValueError(f"feature_dtype must be one of "
                             f"{sorted(FEATURE_DTYPES)}, got "
                             f"{self.feature_dtype!r}")


def pick_bucket(value: int, edges: tuple[int, ...]) -> int:
    """Smallest bucket edge >= value (clamps to the largest edge)."""
    i = bisect.bisect_left(edges, value)
    return edges[min(i, len(edges) - 1)]


def _to_bf16(frames: np.ndarray) -> torch.Tensor:
    """f32 -> a CPU bf16 tensor, rounded to nearest even as
    ``astype(jnp.bfloat16)`` and the native packer round. torch writes one
    NaN pattern for every NaN; a NaN here keeps its sign and top payload
    bits with the quiet bit set, as ml_dtypes (and so the JAX package)
    does, so that the bits agree with both."""
    out = torch.from_numpy(frames).to(torch.bfloat16)
    nan = np.isnan(frames)
    if nan.any():
        bits = out.view(torch.int16).numpy()  # shares out's memory
        bits[nan] = ((frames.view(np.uint32)[nan] >> 16) | 0x40).astype(
            np.uint16).view(np.int16)
    return out


def pad_batch(examples: list, spec: BucketSpec) -> Batch:
    """Pad a list of :class:`RaggedExample` into one fixed-shape Batch.

    Examples beyond the spec's caps are truncated (frames/words tails drop);
    a batch shorter than ``spec.batch_size`` is padded with invalid rows.
    """
    b = spec.batch_size
    if len(examples) > b:
        raise ValueError(f"batch of {len(examples)} > spec batch_size {b}")
    cmax, fmax = spec.max_clips, spec.max_frames
    smax, wmax = spec.max_sentences, spec.max_words

    frames = np.zeros((b, cmax, fmax, spec.feat_dim), np.float32)
    frame_len = np.zeros((b, cmax), np.int32)
    clip_len = np.zeros((b,), np.int32)
    words = np.zeros((b, smax, wmax), np.int32)
    word_len = np.zeros((b, smax), np.int32)
    sent_len = np.zeros((b,), np.int32)
    video_ids = np.full((b,), -1, np.int32)
    valid = np.zeros((b,), bool)

    for i, ex in enumerate(examples):
        nclip = min(len(ex.clips), cmax)
        clip_len[i] = nclip
        for c in range(nclip):
            feat = np.asarray(ex.clips[c], np.float32)
            nf = min(feat.shape[0], fmax)
            frames[i, c, :nf] = feat[:nf]
            frame_len[i, c] = nf
        nsent = min(len(ex.sentences), smax)
        sent_len[i] = nsent
        for s in range(nsent):
            ids = np.asarray(ex.sentences[s], np.int32)
            nw = min(ids.shape[0], wmax)
            words[i, s, :nw] = ids[:nw]
            word_len[i, s] = nw
        video_ids[i] = ex.video_id
        valid[i] = True

    if spec.feature_dtype == "bfloat16":
        frames = _to_bf16(frames)
    return Batch(
        frames=frames,
        frame_len=frame_len,
        clip_len=clip_len,
        words=words,
        word_len=word_len,
        sent_len=sent_len,
        video_ids=video_ids,
        valid=valid,
    )


def bucket_for_examples(
    examples: list,
    batch_size: int,
    feat_dim: int,
    max_clips: int,
    max_sentences: int,
    frame_buckets: tuple[int, ...],
    word_buckets: tuple[int, ...],
    feature_dtype: str = "float32",
) -> BucketSpec:
    """Choose the (frames, words) bucket for a batch from its longest members.

    Only the clips/sentences pad_batch will keep (the first max_clips /
    max_sentences) count: a long clip past the cap is truncated anyway and
    must not drag the batch into a bigger bucket."""
    fmax = max(
        (len(c) for ex in examples for c in ex.clips[:max_clips]),
        default=1,
    )
    wmax = max(
        (len(s) for ex in examples for s in ex.sentences[:max_sentences]),
        default=1,
    )
    return BucketSpec(
        batch_size=batch_size,
        max_clips=max_clips,
        max_frames=pick_bucket(fmax, frame_buckets),
        max_sentences=max_sentences,
        max_words=pick_bucket(wmax, word_buckets),
        feat_dim=feat_dim,
        feature_dtype=feature_dtype,
    )
