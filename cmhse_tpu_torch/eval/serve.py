"""Query-against-gallery serving, counterpart of ``cmhse_tpu/eval/serve.py``:
on one device, or sharded over a mesh (``Retriever(mesh=)``; a local mesh
of :mod:`cmhse_tpu_torch.parallel.mesh` holds every shard in this process,
one a device, as the JAX daemon's one process drives every local device).

Encode a gallery once with :meth:`Retriever.build_gallery`, then answer
text->video (:meth:`Retriever.retrieve`) or video->text
(:meth:`Retriever.retrieve_video`) top-k queries while the gallery grows
(:meth:`Retriever.add_to_gallery`), loses rows
(:meth:`Retriever.remove_from_gallery`) and is compacted
(:meth:`Retriever.compact`, or :meth:`Retriever.plan_compaction` then
:meth:`Retriever.apply_compaction`); :func:`text_query_batch` and
:func:`video_query_batch` make the query batches.

The mutators replace the Retriever's tensors and never write into them: a
gallery encoded under ``torch.inference_mode`` holds inference tensors,
which may not be updated in place outside it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cmhse_tpu_torch.eval.encode import encode_gallery_device
from cmhse_tpu_torch.models.cmhse import CMHSE
from cmhse_tpu_torch.ops.topk import (PreparedGallery, adaptive_n_chunks,
                                      append_to_prepared, dense_sim_topk,
                                      prepare_topk_gallery,
                                      quantized_sim_topk,
                                      should_prepare_topk,
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


def _row_aligned_keys(keys, ids, valid: np.ndarray, rows: int) -> list | None:
    """Row-aligned keys of a gallery segment: padding rows stay in place,
    so keys given one per real example are spread onto the valid rows;
    keys given one per row are taken as they are; no keys means the
    encode's ``ids`` (None when the encode returned none)."""
    if keys is None:
        return None if ids is None else list(ids)
    nvalid = int(valid.sum())
    if len(keys) == rows:
        return list(keys)
    if len(keys) == nvalid:
        spread: list = [None] * rows
        it = iter(keys)
        for i, ok in enumerate(valid):
            if ok:
                spread[i] = next(it)
        return spread
    raise ValueError(
        f"keys has {len(keys)} entries; expected one per gallery "
        f"row ({rows}) or one per valid example ({nvalid})")


def _build_key_rows(gallery_keys: list | None, offset: int = 0) -> dict:
    """Reverse index key -> [row, ...] over row-aligned keys (padding rows
    carry ``None`` and are skipped). A list a key: after remove and re-add
    one key sits on a tombstoned row and a live one, and removal must find
    both and let the validity decide."""
    m: dict = {}
    for i, key in enumerate(gallery_keys or ()):
        if key is not None:
            m.setdefault(key, []).append(i + offset)
    return m


def _unpack(encoded) -> tuple:
    """``(v, p, valid, ids)`` of an ``encode_gallery_device`` tuple, with
    or without ``return_ids``."""
    v, p, valid = encoded[:3]
    return v, p, valid, (encoded[3] if len(encoded) > 3 else None)


def _mask_slots(prep: PreparedGallery, slots: torch.Tensor
                ) -> PreparedGallery:
    """``prep`` with its flattened slots ``slots`` marked invalid: a new
    mask, the same chunks."""
    pv = prep.valid
    return prep._replace(valid=pv.reshape(-1).index_fill(
        0, slots, False).reshape(pv.shape))


class CompactionPlan(NamedTuple):
    """Every compacted serving form, built by
    :meth:`Retriever.plan_compaction` while queries go on, swapped in by
    :meth:`Retriever.apply_compaction`."""

    valid_snapshot: np.ndarray  # host validity at plan time [n_old]
    old_to_new: np.ndarray      # int32 [n_old], -1 = dropped
    gallery: torch.Tensor       # [n_new, D] compacted embeddings
    gallery_valid: torch.Tensor  # bool [n_new] (all True at plan time)
    # PreparedGallery, a list of them (one a shard, mesh), or None
    prepared: PreparedGallery | list | None
    shard_rows: int | None      # per-shard row count (mesh path)
    keys: list | None           # row-aligned keys of the new gallery


class Retriever:
    """Holds an encoded gallery on the model's device and answers top-k
    queries, padding rows kept in place and masked out of every top-k.

    A gallery of at least ``STREAMING_GALLERY_MIN`` rows is also held
    prepared (chunked once; with ``quantize`` its int8 rows too), the JAX
    package's size rule (``should_prepare_topk``). A request then takes the
    int8 two-stage top-k when the Retriever quantizes and holds the int8
    form; otherwise the exact top-k, streaming once its dense ``[Q, N]``
    block would pass ``DENSE_TOPK_MAX_BYTES``, else dense. Streaming goes
    over the prepared form; a smaller gallery is chunked at its first
    streaming request and the chunks kept until the gallery changes. Both
    exact paths return the same rows in the same tie order.

    With a ``mesh`` the gallery is sharded over its ``data`` axis: a
    prepared gallery is held as one form a shard, each on its shard's
    device (``prepare_sharded_topk_gallery``), and a request runs
    ``sharded_sim_topk_prepared`` (int8 per shard when the Retriever
    quantizes), or ``sharded_sim_topk`` below the size rule. The answers
    equal the single device's."""

    def __init__(self, model: CMHSE, mesh=None, quantize: bool = False,
                 rescore_m: int | None = None):
        """``mesh``: a :class:`~cmhse_tpu_torch.parallel.mesh.Mesh` to shard
        the gallery over (a local mesh in a serving process). ``quantize``:
        the two-stage int8 top-k for prepared galleries (formally
        approximate: a true top-k row could miss the int8 pool; see
        ``ops/topk.py``). ``rescore_m``: the int8 pool's depth, the recall
        dial (default ``max(64, 4k)``)."""
        self.model = model
        self.mesh = mesh
        self.quantize = quantize
        self.rescore_m = rescore_m
        self.gallery: torch.Tensor | None = None
        self.gallery_valid: torch.Tensor | None = None
        # host copy of gallery_valid: remove and compact read row validity
        # here instead of downloading the device mask under the daemon's
        # lock; every mutator keeps it in step
        self._valid_host: np.ndarray | None = None
        self.gallery_keys: list | None = None
        self.n_valid: int = 0
        self.side: str = "video"
        # one form, or under a mesh a list of them (one a shard this
        # process holds, shard_rows rows each)
        self._prepared: PreparedGallery | list | None = None
        self._prepared_shard_rows: int | None = None
        # the chunks of a gallery below the size rule, made at its first
        # streaming request; every mutator drops them
        self._streamed: PreparedGallery | None = None
        # key -> [row, ...], kept beside gallery_keys so a remove costs
        # O(removed), not a scan of the gallery
        self._key_rows: dict | None = None

    def build_gallery(self, batches=None, keys: list | None = None,
                      side: str = "video", encoded=None) -> None:
        """Encode batches into the on-device gallery.

        ``side``: "video" (text->video via :meth:`retrieve`) or "text"
        (video->paragraph via :meth:`retrieve_video`). ``encoded``: a
        pre-computed ``encode_gallery_device(...)`` tuple, so one encode
        feeds the Retrievers of both directions (``v`` may be None for the
        text side). ``keys``: one a row or one a valid example; default the
        encode's ids."""
        if side not in ("video", "text"):
            raise ValueError(f"side must be 'video' or 'text', got {side!r}")
        if encoded is None:
            if batches is None:
                raise ValueError("build_gallery needs batches or encoded=")
            encoded = encode_gallery_device(self.model, batches,
                                            return_ids=True)
        v, p, valid, ids = _unpack(encoded)
        self.side = side
        self.gallery = v if side == "video" else p
        self.gallery_valid = valid.to(self.gallery.device).bool()
        self._valid_host = self.gallery_valid.cpu().numpy().copy()
        self.n_valid = int(self._valid_host.sum())
        self._prepared, self._prepared_shard_rows = self._build_prepared(
            self.gallery, self.gallery_valid)
        self.gallery_keys = _row_aligned_keys(
            keys, ids, self._valid_host, int(self.gallery.shape[0]))
        self._key_rows = _build_key_rows(self.gallery_keys)
        self._streamed = None

    def _build_prepared(self, gallery: torch.Tensor, valid: torch.Tensor
                        ) -> tuple[PreparedGallery | list | None, int | None]:
        """``(prepared, shard_rows)`` of a (gallery, valid) pair where the
        size rule asks for a prepared form, else ``(None, None)``: one form,
        or under a mesh the per-shard forms and their row count. Shared by
        :meth:`build_gallery`, :meth:`add_to_gallery` and
        :meth:`plan_compaction` (which must not touch serving state)."""
        if not should_prepare_topk(int(gallery.shape[0])):
            return None, None
        if self.mesh is None:
            return prepare_topk_gallery(gallery, valid,
                                        quantize=self.quantize), None
        from cmhse_tpu_torch.parallel.eval_sharded import \
            prepare_sharded_topk_gallery

        return prepare_sharded_topk_gallery(gallery, self.mesh, valid=valid,
                                            quantize=self.quantize)

    def add_to_gallery(self, batches=None, keys: list | None = None,
                       encoded=None) -> None:
        """Append newly encoded items: the result equals a gallery built
        from all of them at once (indices, keys, scores). The prepared form
        is extended (:func:`append_to_prepared`: the tail chunk and the new
        rows only) until its chunk count passes twice the count a fresh
        prepare would pick; then it is rebuilt once. Under a mesh the
        per-shard forms are rebuilt on every add: the shards hold equal
        rows, and an append would unbalance them. ``encoded``: as in
        :meth:`build_gallery`, so one encode feeds both directions."""
        if self.gallery is None:
            return self.build_gallery(batches, keys=keys, side=self.side,
                                      encoded=encoded)
        if encoded is None:
            if batches is None:
                raise ValueError("add_to_gallery needs batches or encoded=")
            encoded = encode_gallery_device(self.model, batches,
                                            return_ids=True)
        v, p, valid, ids = _unpack(encoded)
        dev = self.gallery.device
        new_emb = (v if self.side == "video" else p).to(dev)
        new_valid = valid.to(dev).bool()
        n_old = int(self.gallery.shape[0])
        n_new_total = n_old + int(new_emb.shape[0])
        self._streamed = None
        if self.mesh is not None:
            self._prepared = None  # the shards are rebuilt below
        elif self._prepared is not None:
            if (self._prepared.chunks.shape[0]
                    > 2 * adaptive_n_chunks(n_new_total)):
                self._prepared = None  # drifted: rebuilt below
            else:
                self._prepared = append_to_prepared(
                    self._prepared, new_emb, n_existing=n_old,
                    valid=new_valid)
        self.gallery = torch.cat([self.gallery, new_emb])
        self.gallery_valid = torch.cat([self.gallery_valid, new_valid])
        if self._prepared is None:
            self._prepared, self._prepared_shard_rows = self._build_prepared(
                self.gallery, self.gallery_valid)
        new_valid_np = new_valid.cpu().numpy()
        self._valid_host = np.concatenate([self._valid_host, new_valid_np])
        self.n_valid += int(new_valid_np.sum())
        new_keys = _row_aligned_keys(keys, ids, new_valid_np,
                                     int(new_emb.shape[0]))
        if self.gallery_keys is not None and new_keys is not None:
            self.gallery_keys = self.gallery_keys + new_keys
            for key, rows in _build_key_rows(new_keys, offset=n_old).items():
                self._key_rows.setdefault(key, []).extend(rows)
        else:
            self.gallery_keys, self._key_rows = None, {}

    def remove_from_gallery(self, keys) -> int:
        """Tombstone gallery items by key: their rows are marked invalid in
        the mask and the prepared form, so they never surface in a top-k;
        nothing is re-encoded and no other row moves. :meth:`compact`
        reclaims the rows. Returns the number of rows removed; unknown keys
        are ignored. O(removed) host work through the key index and the
        host validity copy."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery() first")
        candidates: list = []
        for key in set(keys):
            candidates.extend(self._key_rows.get(key, ()))
        if not candidates:
            return 0
        rows = [i for i in candidates if self._valid_host[i]]
        if rows:
            self._tombstone_rows(rows)
        return len(rows)

    def _tombstone_rows(self, rows: list) -> None:
        """Mark valid gallery rows invalid in the mask, its host copy and the
        prepared forms: the core of :meth:`remove_from_gallery` and of the
        raced-tombstone replay in :meth:`apply_compaction`. New masks
        replace the old; the chunks are not rebuilt."""
        idx = torch.as_tensor(rows, dtype=torch.long,
                              device=self.gallery_valid.device)
        self.gallery_valid = self.gallery_valid.index_fill(0, idx, False)
        self._valid_host[rows] = False  # the host copy is ours to write
        self.n_valid -= len(rows)
        self._streamed = None
        if self._prepared is None:
            return
        if self.mesh is None:
            # one form: its slot s < n is gallery row s
            self._prepared = _mask_slots(self._prepared, idx)
            return
        # per-shard forms: global row r lives in shard r // shard_rows at
        # local slot r % shard_rows (slots past shard_rows are the shard's
        # own padding)
        srows = self._prepared_shard_rows
        by_shard = np.asarray(rows, np.int64)
        shard_of, slot = by_shard // srows, by_shard % srows
        prepared = list(self._prepared)
        for i, (shard, _) in enumerate(self.mesh.local_shards()):
            mine = slot[shard_of == shard]
            if mine.size:
                prepared[i] = _mask_slots(prepared[i], torch.as_tensor(
                    mine, device=prepared[i].valid.device))
        self._prepared = prepared

    @property
    def invalid_fraction(self) -> float:
        """Fraction of gallery rows that are dead weight (tombstones and
        encode padding), which still cost product and memory on every
        query: the trigger of :meth:`compact`."""
        if self.gallery is None:
            return 0.0
        rows = int(self.gallery.shape[0])
        return 1.0 - self.n_valid / rows if rows else 0.0

    def compact(self) -> np.ndarray:
        """Rebuild the gallery without its invalid rows (tombstones and
        encode padding). Surviving rows keep their order, keys and scores;
        their indices change: returns the ``old_row -> new_row`` int32 map
        (``-1`` = dropped). The prepared forms are rebuilt from the
        compacted gallery. The identity map when every row is valid."""
        plan = self.plan_compaction()
        if isinstance(plan, np.ndarray):
            return plan
        return self.apply_compaction(plan)

    def plan_compaction(self) -> CompactionPlan | np.ndarray:
        """Build every compacted serving form without touching serving
        state: the half of an online compaction that runs while queries go
        on against the old forms. Returns the identity map (an
        ``np.ndarray``) when every row is valid, else a
        :class:`CompactionPlan`. Removes may race the build
        (:meth:`apply_compaction` replays them); appends may not."""
        if self.gallery is None:
            raise RuntimeError("call build_gallery() first")
        valid_np = self._valid_host.copy()  # a remove writes the live one
        n_old = int(valid_np.shape[0])
        kept = np.flatnonzero(valid_np)
        old_to_new = np.full(n_old, -1, np.int32)
        old_to_new[kept] = np.arange(kept.size, dtype=np.int32)
        if kept.size == n_old:
            return old_to_new
        dev = self.gallery.device
        gallery = self.gallery[torch.from_numpy(kept).to(dev)]
        gallery_valid = torch.ones(kept.size, dtype=torch.bool, device=dev)
        keys = (None if self.gallery_keys is None
                else [self.gallery_keys[i] for i in kept])
        prepared, shard_rows = self._build_prepared(gallery, gallery_valid)
        return CompactionPlan(
            valid_snapshot=valid_np, old_to_new=old_to_new, gallery=gallery,
            gallery_valid=gallery_valid, prepared=prepared,
            shard_rows=shard_rows, keys=keys)

    def apply_compaction(self, plan: CompactionPlan) -> np.ndarray:
        """Swap a :meth:`plan_compaction` result into serving state (pointer
        swaps, plus one mask update when removes raced the build). Rows
        tombstoned after the snapshot are in the new gallery and are
        tombstoned again here; the returned map gives them their new index,
        while rows dead at the snapshot map to ``-1``. Raises if the
        gallery's length changed since the snapshot."""
        cur = self._valid_host
        if cur.shape[0] != plan.valid_snapshot.shape[0]:
            raise RuntimeError(
                "gallery length changed during the compaction build; "
                "plan is stale (appends must not race plan/apply — hold "
                "the ingest lock)")
        raced = plan.valid_snapshot & ~cur  # tombstoned during the build
        n_new = int(plan.gallery.shape[0])
        self.gallery = plan.gallery
        self.gallery_valid = plan.gallery_valid
        self._valid_host = np.ones(n_new, bool)
        self.n_valid = n_new
        self.gallery_keys = plan.keys
        self._key_rows = _build_key_rows(self.gallery_keys)
        self._prepared = plan.prepared
        self._prepared_shard_rows = plan.shard_rows
        self._streamed = None
        if raced.any():
            new_rows = plan.old_to_new[np.flatnonzero(raced)]
            self._tombstone_rows([int(r) for r in new_rows])
        return plan.old_to_new

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
        n = int(self.gallery.shape[0])
        prep = self._prepared
        # a request's k above rescore_m widens the pool, as in JAX
        rescore_m = (None if self.rescore_m is None
                     else max(self.rescore_m, k))
        if self.mesh is not None:
            from cmhse_tpu_torch.parallel.eval_sharded import (
                sharded_sim_topk, sharded_sim_topk_prepared)

            if prep is not None:
                scores, idx = sharded_sim_topk_prepared(
                    q, prep, k, self.mesh,
                    shard_rows=self._prepared_shard_rows,
                    quantized=self.quantize, rescore_m=rescore_m)
            else:
                scores, idx = sharded_sim_topk(q, self.gallery, k, self.mesh,
                                               valid=self.gallery_valid)
        elif prep is not None and prep.int8_chunks is not None:
            scores, idx = quantized_sim_topk(q, prep, k, rescore_m=rescore_m)
        elif should_stream_topk(int(q.shape[0]), n_gallery=n):
            if prep is None:
                if self._streamed is None:
                    self._streamed = prepare_topk_gallery(self.gallery,
                                                          self.gallery_valid)
                prep = self._streamed
            scores, idx = streaming_sim_topk(q, prep, k)
        else:
            scores, idx = dense_sim_topk(q, self.gallery, self.gallery_valid,
                                         k)
        return scores.cpu().numpy(), idx.cpu().numpy()
