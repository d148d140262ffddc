"""The CMHSE model, counterpart of ``cmhse_tpu/models/cmhse.py``.

  * flat (``hierarchical=False``): one GRU per modality over the whole
    sequence — the VSE-style baseline;
  * hierarchical: frames->clip and clips->video GRUs on the video side,
    words->sentence and sentences->paragraph on the text side;
  * full CMHSE: + attention pooling readouts and the layer-wise
    reconstruction decoders (training only).

``encode_video`` / ``encode_text`` are the serving and evaluation entry
points; ``forward(batch)`` is the training forward and returns
:class:`ModelOutputs`, everything the objective needs.

``ModelConfig.dtype`` is the compute dtype: ``"float32"``, or
``"bfloat16"`` for the JAX package's mixed-precision configuration (bf16
activations and embeddings, f32 parameters, f32 GRU carry and loss).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from cmhse_tpu_torch.config import ModelConfig
from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.device import resolve_device
from cmhse_tpu_torch.models.encoders import (SequenceEncoder, WordEmbedding,
                                             _dense)
from cmhse_tpu_torch.models.gru import gru_input_projection
from cmhse_tpu_torch.ops.gru_kernel import gru_recurrence

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ModelOutputs:
    """Everything the objective needs from one training forward."""

    video_emb: torch.Tensor  # [B, E] L2-normalized
    para_emb: torch.Tensor  # [B, E]
    clip_emb: torch.Tensor  # [B, Cmax, E] L2-normalized low-level video
    sent_emb: torch.Tensor  # [B, Smax, E]
    clip_valid: torch.Tensor  # bool [B, Cmax]
    sent_valid: torch.Tensor  # bool [B, Smax]
    # decoder predictions; None when the model has no reconstruction
    # decoders (the objective then skips the term)
    video_recon: torch.Tensor | None  # [B, Cmax, E]
    text_recon: torch.Tensor | None  # [B, Smax, E]


class ReconstructionDecoder(nn.Module):
    """GRU decoder reconstructing the low-level embedding sequence from the
    high-level embedding (the paper's layer-wise reconstruction).

    Teacher-forced: the input at step t is the true low-level embedding at
    t-1 (zeros at t = 0); the initial state is ``tanh(init(high))``; outputs
    go through the ``out`` Dense into the joint space. ``w_i``/``w_h``/
    ``b_i``/``b_h`` init uniform(-1/sqrt(H), 1/sqrt(H)), biases included,
    as the JAX package's decoder and PyTorch's GRU do.

    Routing: the recurrence is :func:`gru_recurrence` with the seeded h0 at
    every T — the seeded ``gru_fwd`` / ``gru_bwd`` variants on a CUDA tensor
    (or a refusal), their plain versions on the CPU. The JAX package sends
    decoders shorter than ``DECODER_PALLAS_MIN_T = 16`` steps to its scan
    instead, a threshold it measured on a TPU; the port does not carry it
    over. In f32 the two routes compute the same function. In bf16 they do
    not: the JAX scan carries h in bf16, the kernels carry it in f32 and
    round only what they store, so the port's bf16 decoders agree with the
    JAX package's within the bf16 band, not to f32 accuracy.
    """

    def __init__(self, embed_size: int, rnn_hidden: int,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        e, h = embed_size, rnn_hidden
        self.dtype = dtype
        self.init = _dense(e, h, True, generator, dtype)
        scale = 1.0 / math.sqrt(h)
        for name, shape in (("w_i", (e, 3 * h)), ("w_h", (h, 3 * h)),
                            ("b_i", (3 * h,)), ("b_h", (3 * h,))):
            p = torch.empty(shape)
            nn.init.uniform_(p, -scale, scale, generator=generator)
            self.register_parameter(name, nn.Parameter(p))
        self.out = _dense(h, e, True, generator, dtype)

    def forward(self, high_emb: torch.Tensor, low_seq: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """high_emb ``[B, E]``, low_seq ``[B, T, E]``, lengths ``[B]`` ->
        predictions ``[B, T, E]``."""
        b, _, e = low_seq.shape
        h0 = torch.tanh(self.init(high_emb))
        shifted = torch.cat([low_seq.new_zeros(b, 1, e), low_seq[:, :-1]],
                            dim=1)
        xw = gru_input_projection(shifted.to(self.dtype), self.w_i,
                                  self.b_i)
        outs, _ = gru_recurrence(xw.contiguous(), self.w_h, self.b_h,
                                 lengths.to(torch.int32), h0)
        return self.out(outs)


class CMHSE(nn.Module):
    """Cross-Modal Hierarchical Sequence Embedding model.

    ``device``: None means the CUDA card (raises when there is none); pass
    ``"cpu"`` for the plain PyTorch path. ``generator``: the CPU generator
    the fresh init draws from (default: seeded with 0). Parameters are made
    on the CPU and then moved, so a seed gives the same weights on every
    device; the decoders are drawn after the encoders, so a seed gives the
    same encoder weights with or without them. Submodule and parameter names
    follow the JAX params tree (see :mod:`cmhse_tpu_torch.interop`).
    """

    def __init__(self, cfg: ModelConfig, vocab_size: int,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        if cfg.dtype not in COMPUTE_DTYPES or cfg.param_dtype != "float32":
            raise NotImplementedError(
                "the port computes in float32 or bfloat16 with float32 "
                f"parameters (got dtype={cfg.dtype!r}, "
                f"param_dtype={cfg.param_dtype!r})")
        device = resolve_device(device)
        dtype = COMPUTE_DTYPES[cfg.dtype]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.vocab_size = vocab_size
        low_readout = "attn" if cfg.attention_pool else cfg.readout
        high_readout = "attn" if cfg.attention_pool else "last"
        e, h = cfg.embed_size, cfg.rnn_hidden
        self.word_embedding = WordEmbedding(vocab_size, cfg.word_dim,
                                            generator)
        self.video_low = SequenceEncoder(cfg.feat_dim, e, h, low_readout,
                                         cfg.bidirectional, generator, dtype)
        self.text_low = SequenceEncoder(cfg.word_dim, e, h, low_readout,
                                        cfg.bidirectional, generator, dtype)
        if cfg.hierarchical:
            self.video_high = SequenceEncoder(e, e, h, high_readout,
                                              generator=generator,
                                              dtype=dtype)
            self.text_high = SequenceEncoder(e, e, h, high_readout,
                                             generator=generator, dtype=dtype)
        if cfg.reconstruction:  # the config refuses it without hierarchy
            self.video_decoder = ReconstructionDecoder(e, h, generator, dtype)
            self.text_decoder = ReconstructionDecoder(e, h, generator, dtype)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.word_embedding.embedding.device

    def encode_video(self, frames: torch.Tensor, frame_len: torch.Tensor,
                     clip_len: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """frames f32|bf16[B, C, F, feat] -> (video_emb [B, E], clip_emb
        [B, C, E]) in the compute dtype."""
        b, cmax, fmax, feat = frames.shape
        flat = frames.reshape(b * cmax, fmax, feat)
        clip_emb, _ = self.video_low(flat, frame_len.reshape(b * cmax))
        clip_emb = clip_emb.reshape(b, cmax, -1)
        if not self.cfg.hierarchical:
            if cmax != 1:
                raise ValueError(
                    "flat (non-hierarchical) model requires max_clips == 1 "
                    f"(got Cmax={cmax}); set DataConfig.max_clips=1 — "
                    "otherwise clips beyond slot 0 would be silently "
                    "discarded")
            return clip_emb[:, 0], clip_emb
        video_emb, _ = self.video_high(clip_emb, clip_len)
        return video_emb, clip_emb

    def encode_text(self, words: torch.Tensor, word_len: torch.Tensor,
                    sent_len: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """words i32[B, S, W] -> (para_emb [B, E], sent_emb [B, S, E]) in
        the compute dtype."""
        b, smax, wmax = words.shape
        vecs = self.word_embedding(words.reshape(b * smax, wmax))
        sent_emb, _ = self.text_low(vecs, word_len.reshape(b * smax))
        sent_emb = sent_emb.reshape(b, smax, -1)
        if not self.cfg.hierarchical:
            if smax != 1:
                raise ValueError(
                    "flat (non-hierarchical) model requires "
                    f"max_sentences == 1 (got Smax={smax}); set "
                    "DataConfig.max_sentences=1")
            return sent_emb[:, 0], sent_emb
        para_emb, _ = self.text_high(sent_emb, sent_len)
        return para_emb, sent_emb

    def forward(self, batch: Batch) -> ModelOutputs:
        """The training forward over a :class:`Batch` of tensors on the
        model's device (``batch.to(model.device)``)."""
        video_emb, clip_emb = self.encode_video(batch.frames, batch.frame_len,
                                                batch.clip_len)
        para_emb, sent_emb = self.encode_text(batch.words, batch.word_len,
                                              batch.sent_len)
        video_recon = text_recon = None
        if self.cfg.reconstruction:
            video_recon = self.video_decoder(video_emb, clip_emb,
                                             batch.clip_len)
            text_recon = self.text_decoder(para_emb, sent_emb, batch.sent_len)
        return ModelOutputs(
            video_emb=video_emb, para_emb=para_emb, clip_emb=clip_emb,
            sent_emb=sent_emb, clip_valid=batch.clip_valid(),
            sent_valid=batch.sent_valid(), video_recon=video_recon,
            text_recon=text_recon)

    def load_jax_params(self, params: dict) -> None:
        """Load a JAX ``CMHSE`` params tree (nested numpy arrays); see
        :func:`cmhse_tpu_torch.interop.params_from_jax`."""
        from cmhse_tpu_torch.interop import params_from_jax

        self.load_state_dict(params_from_jax(params))
