"""Multi-head attention (counterpart of ``ops/attention.py``).

``multihead_attention(q, k, v, scale)`` computes ``softmax(q kᵀ·scale) v``
over heads, ``q (N, Lq, h, d)`` and ``k/v (N, Lk, h, d)`` to ``(N, Lq, h,
d)``: scores and softmax in float32, probabilities cast to v's dtype for
the PV product.  A CUDA tensor always runs the flash-attention kernels
(``ops/flash_attention.py``): the forward kernel, and under grad the
``FlashAttention`` autograd Function, whose backward is the dQ and dK/dV
kernels.  A CPU tensor runs their plain versions.  There is no regime
gate: the JAX package's gate and block sizes were measured on a TPU.
``force="plain"`` runs the plain forward on any device, for tests, with
autograd's own backward.

``biased_attention(q, k, v, scale, bias, mask)`` is the attention of Swin's
windows and BEiT's layers, which add a relative-position bias (and Swin a
shift/pad mask) to the scores: the JAX package computes it as two einsums
outside any Pallas kernel, and so does the port, with two ``torch.matmul``
calls.  The scores are float32 as the JAX einsum's
``preferred_element_type=float32`` makes them, through
``float32_product``.  Softmax in float32, the probabilities cast to v's
dtype for the PV product, outside autocast.  A float64 input stays
float64.

``float32_product(a, b)`` is ``a @ b`` as an einsum with
``preferred_element_type=float32`` makes it: the operands cast up to
float32 (a float64 input stays float64) and multiplied outside autocast
(a bf16 product under autocast would round the scores to bf16), so bf16
operands give exact float32 products with float32 sums.  Besides
``biased_attention``, the non-local heads form their scores with it (NL,
DNL, CC, DA, PSA and the ``SelfAttentionBlock`` of ANN and ISA).

The Mask2Former decoder's masked cross-attention is the same function with
no bias and a per-image additive mask: the JAX ``CrossAttention`` (and its
``chunked_softmax_attention``, a form of the same product that works
round an XLA lowering) puts -1e30 on each blocked key's score, and a row
that blocks every key attends to all of them.  The flash kernels take no
mask, and the JAX head does not use its flash kernel either.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, bias: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None,
                     dropout: Optional[Callable] = None) -> torch.Tensor:
    """``softmax(q kᵀ·scale + bias + mask) v`` with ``q (B, h, Lq, d)``,
    ``k/v (B, h, Lk, d)``, ``bias (h, Lq, Lk)`` and ``mask (nW, Lq, Lk)``
    shared by every ``nW``-th row of B (``B = N·nW``); ``dropout`` acts on
    the probabilities."""
    # the product's output is not saved for the backward: in place
    scores = float32_product(q, k.transpose(-2, -1)).mul_(scale)
    with torch.autocast(q.device.type, enabled=False):
        if bias is not None:
            scores = scores.add_(bias.to(scores.dtype))
        if mask is not None:
            scores.unflatten(0, (-1, mask.shape[0])).add_(
                mask[:, None].to(scores.dtype))
        attn = torch.softmax(scores, dim=-1)
        if dropout is not None:
            attn = dropout(attn)
        return torch.matmul(attn.to(v.dtype), v)


def float32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 (or float64) operands and output, outside
    autocast."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                              torch.float32)
    with torch.autocast(a.device.type, enabled=False):
        return torch.matmul(a.to(acc), b.to(acc))
