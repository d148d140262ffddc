"""Gallery encoding, counterpart of ``cmhse_tpu/eval/encode.py``.

Two paths:
  * :func:`encode_data` — host collection: every batch's embeddings are
    copied to numpy and padded rows dropped (offline analysis, export);
  * :func:`encode_gallery_device` — the serving and evaluation path:
    embeddings stay on the model's device, padded rows stay in place and
    are flagged by ``valid``; batches reach the card through
    :class:`~cmhse_tpu_torch.data.prefetch.Prefetcher` (pinned buffers, copies on a side
    stream, overlapping the encode).

Both run on the model's device (the card unless the model was made on the
CPU) under ``torch.inference_mode``.
"""

from __future__ import annotations

import numpy as np
import torch

from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.data.prefetch import Prefetcher
from cmhse_tpu_torch.models.cmhse import CMHSE


@torch.inference_mode()
def encode_batch(model: CMHSE, batch: Batch):
    """(video_emb, para_emb, clip_emb, sent_emb) of one batch, on the
    model's device (a batch already there is not copied)."""
    b = batch.to(model.device)
    v, clip = model.encode_video(b.frames, b.frame_len, b.clip_len)
    p, sent = model.encode_text(b.words, b.word_len, b.sent_len)
    return v, p, clip, sent


def encode_data(model: CMHSE, batches, return_low_level: bool = False):
    """Host-collecting encode: returns (video_embs [N, E], para_embs
    [N, E], video_ids [N]) as numpy with padded rows dropped, plus
    optionally the low-level (clip, sentence) embeddings and their masks.
    bf16 embeddings come back as f32 arrays of the same values (numpy has
    no bf16)."""
    v_all, p_all, ids_all = [], [], []
    clip_all, sent_all, cmask_all, smask_all = [], [], [], []
    for batch in batches:
        v, p, clip, sent = encode_batch(model, batch)
        keep = np.asarray(batch.valid)
        v_all.append(v.float().cpu().numpy()[keep])
        p_all.append(p.float().cpu().numpy()[keep])
        ids_all.append(np.asarray(batch.video_ids)[keep])
        if return_low_level:
            clip_all.append(clip.float().cpu().numpy()[keep])
            sent_all.append(sent.float().cpu().numpy()[keep])
            cmask_all.append(np.asarray(batch.clip_valid())[keep])
            smask_all.append(np.asarray(batch.sent_valid())[keep])
    if not v_all:
        raise ValueError("no batches to encode (empty split)")
    out = (np.concatenate(v_all), np.concatenate(p_all),
           np.concatenate(ids_all))
    if not return_low_level:
        return out
    return out + ([np.concatenate(x)
                   for x in (clip_all, sent_all, cmask_all, smask_all)],)


def encode_gallery_device(model: CMHSE, batches, return_ids: bool = False):
    """Device-resident gallery encode.

    Returns (video_embs [Np, E], para_embs [Np, E], valid bool[Np]) on the
    model's device, in its compute dtype (a bf16 model's gallery is stored
    bf16), padded rows kept in place (aligned across both modalities) and
    flagged by ``valid``. ``return_ids`` adds the host
    ``video_ids`` int32[Np], used by serving to map rows back to keys.
    """
    v_all, p_all, valid_all, ids_all = [], [], [], []
    for host, batch in Prefetcher(model.device)(batches):
        batch = batch.to(model.device)  # on the CPU: numpy -> tensors
        v, p, _, _ = encode_batch(model, batch)
        v_all.append(v)
        p_all.append(p)
        valid_all.append(batch.valid)
        if return_ids:
            ids_all.append(np.asarray(host.video_ids))
    if not v_all:
        raise ValueError("no batches to encode (empty split)")
    out = (torch.cat(v_all), torch.cat(p_all), torch.cat(valid_all))
    if return_ids:
        return out + (np.concatenate(ids_all),)
    return out
