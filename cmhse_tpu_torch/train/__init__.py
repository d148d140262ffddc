"""The training objective and the update step."""

from cmhse_tpu_torch.train.objective import (hardest_negatives, total_loss,
                                             total_loss_at)
from cmhse_tpu_torch.train.state import (TrainState, clip_by_global_norm_,
                                         create_train_state, global_norm,
                                         make_optimizer, set_learning_rate,
                                         train_step)

__all__ = [
    "TrainState", "clip_by_global_norm_", "create_train_state",
    "global_norm", "hardest_negatives", "make_optimizer",
    "set_learning_rate", "total_loss", "total_loss_at", "train_step",
]
