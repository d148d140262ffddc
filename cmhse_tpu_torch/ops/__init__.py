"""Tensor ops and the hand-written CUDA kernels' wrappers.

``gru_kernel``, ``simhinge_kernel`` and ``rankcount_kernel`` hold the
kernels' wrappers and their plain PyTorch versions; ``cuda_lib`` builds and
binds ``csrc/*.cu`` and keeps every wrapper's launch count
(``cuda_lib.launches``).
"""
