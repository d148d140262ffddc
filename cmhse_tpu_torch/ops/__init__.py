"""Tensor ops and the hand-written CUDA kernels' wrappers.

``gru_kernel``, ``simhinge_kernel`` and ``rankcount_kernel`` hold the
kernels' wrappers and their plain PyTorch versions; ``cuda_lib`` builds and
binds ``csrc/*.cu`` and keeps every wrapper's launch count
(``cuda_lib.launches``). The package re-exports the JAX package's op names
(similarity, loss, ranking and top-k); importing it builds nothing.
"""

from cmhse_tpu_torch.ops.loss import contrastive_loss, positive_mask_from_ids
from cmhse_tpu_torch.ops.ranking import (recall_at_k, retrieval_metrics,
                                         retrieval_ranks)
from cmhse_tpu_torch.ops.similarity import cosine_sim, l2norm
from cmhse_tpu_torch.ops.topk import (PreparedGallery, append_to_prepared,
                                      prepare_topk_gallery,
                                      quantized_sim_topk, should_stream_topk,
                                      streaming_sim_topk)

__all__ = [
    "PreparedGallery", "append_to_prepared", "contrastive_loss",
    "cosine_sim", "l2norm", "positive_mask_from_ids", "prepare_topk_gallery",
    "quantized_sim_topk", "recall_at_k", "retrieval_metrics",
    "retrieval_ranks", "should_stream_topk", "streaming_sim_topk",
]
