"""Data contract and host-side batching (numpy until :meth:`Batch.to`)."""

from cmhse_tpu_torch.data.batch import Batch
from cmhse_tpu_torch.data.bucketing import (BucketSpec, bucket_for_examples,
                                            pad_batch, pick_bucket)
from cmhse_tpu_torch.data.datasets import (CorrelatedSyntheticDataset,
                                           PrecompDataset, RaggedExample,
                                           SyntheticHierarchicalDataset)
from cmhse_tpu_torch.data.loader import batches_from_dataset
from cmhse_tpu_torch.data.prefetch import Prefetcher
from cmhse_tpu_torch.data.vocab import (Vocabulary, build_vocab, find_vocab,
                                        tokenize)

__all__ = [
    "Batch", "BucketSpec", "CorrelatedSyntheticDataset", "PrecompDataset",
    "Prefetcher", "RaggedExample", "SyntheticHierarchicalDataset",
    "Vocabulary", "batches_from_dataset", "bucket_for_examples",
    "build_vocab", "find_vocab", "pad_batch", "pick_bucket", "tokenize",
]
