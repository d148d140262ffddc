"""cmhse_tpu_torch — the PyTorch/CUDA port of ``cmhse_tpu``.

The JAX package stays the reference; this package mirrors its module layout
(``config``, ``data``, ``models``, ``ops``, ``eval``) in PyTorch and imports
nothing of JAX or of ``cmhse_tpu``. Every Pallas kernel on a ported path
becomes a hand-written CUDA kernel for Hopper (``csrc/``), built at first
use. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from cmhse_tpu_torch.config import (PRESETS, DataConfig, ExperimentConfig,
                                    LossConfig, ModelConfig, TrainConfig,
                                    get_preset)

__version__ = "0.1.0"

__all__ = [
    "DataConfig", "ExperimentConfig", "LossConfig", "ModelConfig", "PRESETS",
    "TrainConfig", "__version__", "get_preset",
]
