"""Encode, evaluate and serve."""

from cmhse_tpu_torch.eval.encode import encode_data, encode_gallery_device
from cmhse_tpu_torch.eval.retrieval import (evalrank, format_table,
                                            streaming_bidirectional_metrics,
                                            validate_metrics)
from cmhse_tpu_torch.eval.serve import (Retriever, key_index,
                                        text_query_batch, video_query_batch)

__all__ = [
    "Retriever", "encode_data", "encode_gallery_device", "evalrank",
    "format_table", "key_index", "streaming_bidirectional_metrics",
    "text_query_batch", "validate_metrics", "video_query_batch",
]
