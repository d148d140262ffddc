"""Encoders, the reconstruction decoders and the CMHSE model."""

from cmhse_tpu_torch.models.cmhse import (CMHSE, ModelOutputs,
                                          ReconstructionDecoder)
from cmhse_tpu_torch.models.encoders import (AttentionPool, SequenceEncoder,
                                             WordEmbedding)
from cmhse_tpu_torch.models.gru import (MaskedGRU, flip_padded,
                                        gru_input_projection, gru_sequence,
                                        masked_mean)

__all__ = [
    "AttentionPool", "CMHSE", "MaskedGRU", "ModelOutputs",
    "ReconstructionDecoder", "SequenceEncoder", "WordEmbedding",
    "flip_padded", "gru_input_projection", "gru_sequence", "masked_mean",
]
