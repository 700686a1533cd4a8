"""Multi-head attention (counterpart of ``ops/attention.py``).

``multihead_attention(q, k, v, scale)`` computes ``softmax(q kᵀ·scale) v``
over heads, ``q (N, Lq, h, d)`` and ``k/v (N, Lk, h, d)`` to ``(N, Lq, h,
d)``: scores and softmax in float32, probabilities cast to v's dtype for
the PV product.  A CUDA tensor always runs the flash-attention kernel
(``ops/flash_attention.py``), a CPU tensor its plain version.  There is no
regime gate: the JAX package's gate and block sizes were measured on a TPU.
``force="plain"`` runs the plain version on any device, for tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import attention_plain, flash_attention_forward


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float,
                        force: Optional[str] = None) -> torch.Tensor:
    if force == "plain":
        return attention_plain(q, k, v, scale)[0]
    if force is not None:
        raise ValueError(f"force must be None or 'plain', got {force!r}")
    return flash_attention_forward(q, k, v, scale)[0]
