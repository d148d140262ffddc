"""The training objective and the update step."""

from cmhse_tpu_torch.train.objective import total_loss
from cmhse_tpu_torch.train.state import (TrainState, clip_by_global_norm_,
                                         create_train_state, global_norm,
                                         make_optimizer, set_learning_rate,
                                         train_step)

__all__ = [
    "TrainState", "clip_by_global_norm_", "create_train_state",
    "global_norm", "make_optimizer", "set_learning_rate", "total_loss",
    "train_step",
]
