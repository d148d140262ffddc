"""The fixed-shape masked batch, counterpart of ``cmhse_tpu/data/batch.py``.

Shapes are static per bucket; raggedness lives in the length fields and
padding rows of a short batch are flagged by ``valid``. The loader builds
batches of numpy arrays on the host; :meth:`Batch.to` moves them to a torch
device. bf16 ``frames`` are already a CPU ``torch.bfloat16`` tensor on the
host (see :func:`cmhse_tpu_torch.data.bucketing.pad_batch`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class Batch:
    """One padded video-paragraph batch at both hierarchy levels.

    Video side:
      frames:    f32|bf16[B, Cmax, Fmax, feat]  clip frame features
      frame_len: i32[B, Cmax]              valid frames per clip (0 = pad clip)
      clip_len:  i32[B]                    valid clips per video
    Text side:
      words:     i32[B, Smax, Wmax]        caption token ids
      word_len:  i32[B, Smax]              valid words per sentence
      sent_len:  i32[B]                    valid sentences per paragraph
    Bookkeeping:
      video_ids: i32[B]  dataset-level id
      valid:     bool[B] row validity (False = padding row of a short batch)
    """

    frames: Any
    frame_len: Any
    clip_len: Any
    words: Any
    word_len: Any
    sent_len: Any
    video_ids: Any
    valid: Any

    @property
    def batch_size(self) -> int:
        return self.frames.shape[0]

    @property
    def max_clips(self) -> int:
        return self.frames.shape[1]

    @property
    def max_sentences(self) -> int:
        return self.words.shape[1]

    def _slots_valid(self, n_slots: int, lengths):
        if isinstance(lengths, np.ndarray):
            slots = np.arange(n_slots)[None, :]
            return (slots < lengths[:, None]) & np.asarray(self.valid)[:, None]
        slots = torch.arange(n_slots, device=lengths.device)[None, :]
        return (slots < lengths[:, None]) & self.valid[:, None]

    def clip_valid(self):
        """bool[B, Cmax] — which clip slots are real."""
        return self._slots_valid(self.frames.shape[1], self.clip_len)

    def sent_valid(self):
        """bool[B, Smax] — which sentence slots are real."""
        return self._slots_valid(self.words.shape[1], self.sent_len)

    def to(self, device: str | torch.device) -> "Batch":
        """The same batch as torch tensors on ``device`` (dtypes kept)."""
        return Batch(**{
            f.name: torch.as_tensor(getattr(self, f.name)).to(device)
            for f in dataclasses.fields(self)
        })
