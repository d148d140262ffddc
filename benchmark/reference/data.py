"""The reference's own padding of ragged video-paragraph pairs, so that it
rebuilds from the benchmark's raw inputs what the measured program derives
from them."""

from __future__ import annotations

import numpy as np
import torch


def pad_examples(examples: list, max_clips: int, max_frames: int,
                 max_sentences: int, max_words: int,
                 device) -> dict:
    """Ragged examples (``clips``: list of ``[frames, feat]`` arrays,
    ``sentences``: list of id arrays, ``video_id``) -> a dict of padded
    tensors on ``device``; clips, frames, sentences and words past the caps
    are dropped."""
    b = len(examples)
    feat = examples[0].clips[0].shape[1]
    frames = np.zeros((b, max_clips, max_frames, feat), np.float32)
    frame_len = np.zeros((b, max_clips), np.int64)
    clip_len = np.zeros((b,), np.int64)
    words = np.zeros((b, max_sentences, max_words), np.int64)
    word_len = np.zeros((b, max_sentences), np.int64)
    sent_len = np.zeros((b,), np.int64)
    ids = np.zeros((b,), np.int64)
    for i, ex in enumerate(examples):
        clips = ex.clips[:max_clips]
        clip_len[i] = len(clips)
        for c, f in enumerate(clips):
            n = min(len(f), max_frames)
            frames[i, c, :n] = f[:n]
            frame_len[i, c] = n
        sents = ex.sentences[:max_sentences]
        sent_len[i] = len(sents)
        for s, w in enumerate(sents):
            n = min(len(w), max_words)
            words[i, s, :n] = w[:n]
            word_len[i, s] = n
        ids[i] = ex.video_id
    out = dict(frames=frames, frame_len=frame_len, clip_len=clip_len,
               words=words, word_len=word_len, sent_len=sent_len, ids=ids)
    out = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    out["valid"] = torch.ones(b, dtype=torch.bool, device=device)
    return out

