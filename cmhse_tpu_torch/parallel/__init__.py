"""Multi-GPU execution, counterpart of ``cmhse_tpu/parallel/``: the mesh
(one card a process on ``torch.distributed``, or one process over a list
of local devices), data-parallel training placement, and sharded
evaluation and top-k."""

from cmhse_tpu_torch.parallel.eval_sharded import (
    prepare_sharded_topk_gallery, sharded_ranks, sharded_retrieval_metrics,
    sharded_sim_topk, sharded_sim_topk_prepared)
from cmhse_tpu_torch.parallel.mesh import (Mesh, local_devices, make_mesh,
                                           maybe_initialize_distributed)
from cmhse_tpu_torch.parallel.train_dp import (local_rows, place_batch,
                                               place_state)

__all__ = [
    "Mesh", "local_devices", "local_rows", "make_mesh",
    "maybe_initialize_distributed", "place_batch", "place_state",
    "prepare_sharded_topk_gallery", "sharded_ranks",
    "sharded_retrieval_metrics", "sharded_sim_topk",
    "sharded_sim_topk_prepared",
]
