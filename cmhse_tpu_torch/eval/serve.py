"""Query-against-gallery serving, counterpart of ``cmhse_tpu/eval/serve.py``
(single device).

Encode a gallery once with :meth:`Retriever.build_gallery`, then answer
text->video (:meth:`Retriever.retrieve`) or video->text
(:meth:`Retriever.retrieve_video`) top-k queries; :func:`text_query_batch`
and :func:`video_query_batch` make the query batches. Adding, removing and
compacting gallery rows, the int8 path, the mesh and the daemon wait.
"""

from __future__ import annotations

import numpy as np
import torch

from cmhse_tpu_torch.eval.encode import encode_gallery_device
from cmhse_tpu_torch.models.cmhse import CMHSE
from cmhse_tpu_torch.ops.topk import (dense_sim_topk, prepare_topk_gallery,
                                      should_stream_topk, streaming_sim_topk)


def text_query_batch(vocab, texts: list, max_sentences: int,
                     max_words: int) -> tuple:
    """Tokenize natural-language queries (``vocab.encode(text)`` -> ids)
    into a one-sentence padded batch, the query side of
    :meth:`Retriever.retrieve`."""
    words = np.zeros((len(texts), max_sentences, max_words), np.int32)
    word_len = np.zeros((len(texts), max_sentences), np.int32)
    sent_len = np.ones((len(texts),), np.int32)
    for i, text in enumerate(texts):
        ids = vocab.encode(text)[:max_words]
        words[i, 0, : len(ids)] = ids
        word_len[i, 0] = len(ids)
    return words, word_len, sent_len


def key_index(dataset) -> dict:
    """Key -> row map of a dataset, cached on the instance: serving looks up
    one key a video query and must not rebuild a gallery-sized dict each
    time. The cache is keyed on ``(keys_version, len(keys))``: a dataset
    that changes its ``keys`` in place bumps ``keys_version``
    (``PrecompDataset.keys`` never changes after construction)."""
    version = (getattr(dataset, "keys_version", 0), len(dataset.keys))
    cached = getattr(dataset, "_key_to_idx_cache", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    m = {key: i for i, key in enumerate(dataset.keys)}
    try:
        dataset._key_to_idx_cache = (version, m)
    except AttributeError:
        pass  # slotted or frozen datasets rebuild it each call
    return m


def video_query_batch(dataset, data_cfg, keys: list) -> tuple:
    """Pack dataset examples, looked up by video key, into a query batch for
    :meth:`Retriever.retrieve_video`: ``(frames, frame_len, clip_len)``,
    packed as the loader packs (the native packer, in
    ``data_cfg.feature_dtype``). Raises ``KeyError`` whose ``args[0]`` is
    the list of keys absent from the dataset."""
    from cmhse_tpu_torch import native
    from cmhse_tpu_torch.data.bucketing import BucketSpec

    key_to_idx = key_index(dataset)
    missing = [k for k in keys if k not in key_to_idx]
    if missing:
        raise KeyError(missing)
    spec = BucketSpec(
        batch_size=len(keys), max_clips=data_cfg.max_clips,
        max_frames=data_cfg.max_frames,
        max_sentences=data_cfg.max_sentences,
        max_words=data_cfg.max_words, feat_dim=data_cfg.feat_dim,
        feature_dtype=data_cfg.feature_dtype,
    )
    qb = native.pack_batch_native([dataset[key_to_idx[k]] for k in keys],
                                  spec)
    return qb.frames, qb.frame_len, qb.clip_len


class Retriever:
    """Holds an encoded gallery on the model's device and answers top-k
    queries: one product + top-k while a request's ``[Q, N]`` block stays
    within ``DENSE_TOPK_MAX_BYTES``, the chunked streaming top-k above it
    (the gallery chunked once, at the first request that needs it). Padding
    rows stay in place, masked out of every top-k."""

    def __init__(self, model: CMHSE):
        self.model = model
        self.gallery: torch.Tensor | None = None
        self.gallery_valid: torch.Tensor | None = None
        self.n_valid: int = 0
        self.side: str = "video"
        self._prepared = None

    def build_gallery(self, batches=None, side: str = "video",
                      encoded=None) -> None:
        """Encode batches into the on-device gallery.

        ``side``: "video" (text->video via :meth:`retrieve`) or "text"
        (video->paragraph via :meth:`retrieve_video`). ``encoded``: a
        pre-computed ``encode_gallery_device(...)`` tuple, so one encode
        feeds the Retrievers of both directions."""
        if side not in ("video", "text"):
            raise ValueError(f"side must be 'video' or 'text', got {side!r}")
        if encoded is None:
            if batches is None:
                raise ValueError("build_gallery needs batches or encoded=")
            encoded = encode_gallery_device(self.model, batches)
        v, p, valid = encoded[:3]
        self.side = side
        self.gallery = v if side == "video" else p
        self.gallery_valid = valid.to(self.gallery.device).bool()
        self.n_valid = int(self.gallery_valid.sum())
        self._prepared = None

    def _query(self, arrays) -> list:
        # bf16 frames arrive as a torch tensor (numpy has no bf16)
        return [(a if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.asarray(a))).to(self.model.device)
                for a in arrays]

    def _empty(self, q_rows: int) -> tuple[np.ndarray, np.ndarray]:
        return (np.zeros((q_rows, 0), np.float32),
                np.zeros((q_rows, 0), np.int64))

    @torch.inference_mode()
    def retrieve(self, words, word_len, sent_len, k: int = 10
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k gallery scores + indices for a batch of tokenized TEXT
        queries. ``k`` is clamped on the host to the number of valid gallery
        rows, so padding rows can never surface; the device search runs at
        ``min(k, gallery rows)`` and the trailing columns are trimmed."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery() first")
        k_req = min(k, self.n_valid)
        if k_req == 0:
            return self._empty(int(words.shape[0]))
        q, _ = self.model.encode_text(*self._query((words, word_len,
                                                    sent_len)))
        scores, idx = self._search(q, min(k, int(self.gallery.shape[0])))
        return scores[:, :k_req], idx[:, :k_req]

    @torch.inference_mode()
    def retrieve_video(self, frames, frame_len, clip_len, k: int = 10
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k gallery scores + indices for a batch of VIDEO queries (the
        video->paragraph direction; build the gallery with ``side="text"``).
        Same clamping contract as :meth:`retrieve`."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery() first")
        k_req = min(k, self.n_valid)
        if k_req == 0:
            return self._empty(int(frames.shape[0]))
        q, _ = self.model.encode_video(*self._query((frames, frame_len,
                                                     clip_len)))
        scores, idx = self._search(q, min(k, int(self.gallery.shape[0])))
        return scores[:, :k_req], idx[:, :k_req]

    def _search(self, q: torch.Tensor, k: int
                ) -> tuple[np.ndarray, np.ndarray]:
        if should_stream_topk(int(q.shape[0]), int(self.gallery.shape[0])):
            if self._prepared is None:
                self._prepared = prepare_topk_gallery(self.gallery,
                                                      self.gallery_valid)
            scores, idx = streaming_sim_topk(q, self._prepared, k)
        else:
            scores, idx = dense_sim_topk(q, self.gallery, self.gallery_valid,
                                         k)
        return scores.cpu().numpy(), idx.cpu().numpy()
