"""Host-side batch iteration, counterpart of ``cmhse_tpu/data/loader.py``.

Batches are packed by the native C++ packer
(:func:`cmhse_tpu_torch.native.pack_batch_native`, built with ``g++`` at
first use), as the JAX loader packs whenever its packer builds; the numpy
:func:`pad_batch` is its plain version, equal field for field. Same order,
grouping and multi-process slicing as the JAX loader, so the batches are
array-equal for the same seed. In a process that sees a CUDA device the
frames are packed straight into page-locked memory (``pinned=True``: a CPU
tensor the :class:`~cmhse_tpu_torch.data.prefetch.Prefetcher` copies to the
card as it lies); elsewhere every field is a numpy array.

With the recorder on (:mod:`cmhse_tpu_torch.utils.timing`) each batch
draws the next batch key; its ``loader.rows`` span covers gathering its
rows and choosing its bucket, and the ``loader.rows`` counter counts the
rows.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from cmhse_tpu_torch import native
from cmhse_tpu_torch.config import DataConfig
from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.data.bucketing import BucketSpec, bucket_for_examples
from cmhse_tpu_torch.utils import timing


def batches_from_dataset(
    dataset,
    cfg: DataConfig,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    fixed_shape: bool = True,
    group_by_length: bool = False,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Batch]:
    """Yield fixed-shape :class:`Batch` es from a ragged dataset: numpy
    arrays, but ``frames`` a pinned CPU tensor where CUDA is available.

    ``fixed_shape=True``: every batch uses the config's maximal caps. False:
    per-batch (frames, words) bucket edges from the batch's longest member.
    ``group_by_length``: batch together examples of similar max-frame length
    (batch order stays shuffled). ``process_index``/``process_count``: each
    process yields its contiguous slice of every global batch.
    """
    if process_count > 1 and cfg.batch_size % process_count:
        raise ValueError(
            f"batch_size {cfg.batch_size} must divide by process_count "
            f"{process_count}"
        )
    local_rows = cfg.batch_size // process_count
    lo, hi = process_index * local_rows, (process_index + 1) * local_rows
    rng = np.random.RandomState(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    if group_by_length:
        lengths = getattr(dataset, "_frame_len_cache", None)
        if lengths is None:
            if hasattr(dataset, "max_frame_len"):
                lengths = np.asarray(
                    [dataset.max_frame_len(i) for i in range(len(dataset))]
                )
            else:
                lengths = np.asarray(
                    [max((len(c) for c in dataset[i].clips), default=0)
                     for i in range(len(dataset))]
                )
            try:
                dataset._frame_len_cache = lengths
            except (AttributeError, TypeError):
                pass  # dataset forbids attributes; probe again next epoch
        max_frames = lengths[order]
        order = order[np.argsort(max_frames, kind="stable")]
        starts = np.arange(0, len(order), cfg.batch_size)
        if shuffle:
            rng.shuffle(starts)
        # keep groups intact: a short group may land mid-stream after the
        # shuffle, and re-slicing by a fixed stride would mix length groups
        groups = [order[s : s + cfg.batch_size] for s in starts]
    else:
        groups = [order[s : s + cfg.batch_size]
                  for s in range(0, len(order), cfg.batch_size)]
    if process_count > 1 and not fixed_shape:
        raise ValueError(
            "bucketed (fixed_shape=False) batches are not supported "
            "multi-process: bucket edges chosen from per-process local rows "
            "could differ across processes"
        )

    full_spec = BucketSpec(
        batch_size=local_rows,
        max_clips=cfg.max_clips,
        max_frames=cfg.max_frames,
        max_sentences=cfg.max_sentences,
        max_words=cfg.max_words,
        feat_dim=cfg.feat_dim,
        feature_dtype=cfg.feature_dtype,
    )
    pinned = torch.cuda.is_available()

    for idxs in groups:
        if drop_last and len(idxs) < cfg.batch_size:
            continue
        if process_count > 1:
            idxs = idxs[lo:hi]
        with timing.span("loader.rows", timing.next_key()):
            examples = [dataset[int(i)] for i in idxs]
            if fixed_shape:
                spec = full_spec
            else:
                spec = bucket_for_examples(
                    examples,
                    batch_size=local_rows,
                    feat_dim=cfg.feat_dim,
                    max_clips=cfg.max_clips,
                    max_sentences=cfg.max_sentences,
                    frame_buckets=cfg.frame_buckets,
                    word_buckets=cfg.word_buckets,
                    feature_dtype=cfg.feature_dtype,
                )
        timing.count("loader.rows", len(examples))
        yield native.pack_batch_native(examples, spec, pinned=pinned)
