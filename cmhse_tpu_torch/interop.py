"""Carry weights from the JAX package's ``CMHSE`` into the port.

The port names its submodules and parameters after the JAX params tree
(``word_embedding.embedding``, ``video_low.gru.fwd_w_i``,
``video_low.attn_pool.proj``, ``video_decoder.init``, ...), so the only
change on the way is one transpose per Dense kernel: flax stores
``kernel [in, out]``, ``nn.Linear`` stores ``weight [out, in]``. GRU
weights, the decoders' ``w_i``/``w_h``/``b_i``/``b_h`` included, keep the
JAX layout as they are.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``CMHSE`` params tree -> the port's ``state_dict``, every module
    included (the reconstruction decoders too).

    ``params``: the tree flax ``init`` returns (``variables["params"]``),
    leaves converted with ``np.asarray``.
    """
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            key = f"{prefix}{name}"
            if isinstance(value, Mapping):
                walk(value, key + ".")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(
                    np.array(arr.T, order="C"))
            else:
                out[key] = torch.from_numpy(np.array(arr))

    walk(params, "")
    return out
