"""Pooling on NCHW tensors (counterpart of ``ops/pooling.py``'s
``adaptive_avg_pool2d`` and ``max_pool2d``).

``max_pool2d`` pads each spatial axis by the JAX package's rule
(``_pool_padding``: torch's, with ``ceil_mode``'s last window starting
inside the left-padded input) with -inf, then takes ``F.max_pool2d``
without padding.  ``F.max_pool2d`` is looked up at call time.

``adaptive_avg_pool2d(x, output_size)`` on an NCHW tensor: output bin ``i``
of an axis of length ``n`` averages ``[floor(i*n/o), ceil((i+1)*n/o))``
(PyTorch's ``AdaptiveAvgPool2d`` bins, which overlap when ``o`` does not
divide ``n``), in float32, rounded once to the input's dtype.  The JAX
rule as its jitted models run it, to the bit where the sums are exact:
each bin's float32 sum times the float32 reciprocal of its count.  (XLA
folds the count of the uniform bins' average pooling to a constant and
turns the division into that product; run op by op, JAX divides there.)

The sums are two products with 0/1 bin matrices (rows, then columns), so
the backward is two products as well.  ``F.adaptive_avg_pool2d``'s CUDA
backward for an output above 1 x 1 has no deterministic implementation
and raises under ``torch.use_deterministic_algorithms(True)``, which the
Kvasir and SegFormer schedules set; a matrix product's does not.  The
products run outside autocast, in float32; with TF32 off (the port's
float32, ``core/mixed_precision.float32_precision``) a product with 0 or 1
is exact, so only the sums' order is free.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _pool_padding(size: int, k: int, s: int, p: int, ceil_mode: bool):
    """The (lo, hi) padding of one axis for a pool of ``k``, stride ``s``,
    padding ``p``: torch's output size, with the JAX package's rule."""
    if ceil_mode:
        out = -(-(size + 2 * p - k) // s) + 1
        if (out - 1) * s >= size + p:
            out -= 1
    else:
        out = (size + 2 * p - k) // s + 1
    return p, max((out - 1) * s + k - size - p, 0)


def max_pool2d(x: torch.Tensor, kernel_size: IntPair, stride: IntPair = None,
               padding: IntPair = 0, ceil_mode: bool = False) -> torch.Tensor:
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride if stride is not None else kernel_size)
    ph, pw = _pair(padding)
    top, bottom = _pool_padding(x.shape[2], kh, sh, ph, ceil_mode)
    left, right = _pool_padding(x.shape[3], kw, sw, pw, ceil_mode)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, (kh, kw), (sh, sw))


def bin_matrix(size: int, out: int, device=None) -> torch.Tensor:
    """``(out, size)`` float32: row ``i`` is 1 on bin ``i``'s inputs."""
    i = torch.arange(out, device=device)
    start = (i * size) // out
    stop = -((-(i + 1) * size) // out)  # ceil((i + 1) * size / out)
    j = torch.arange(size, device=device)
    inside = (j >= start[:, None]) & (j < stop[:, None])
    return inside.to(torch.float32)


def adaptive_avg_pool2d(x: torch.Tensor,
                        output_size: IntPair) -> torch.Tensor:
    oh, ow = _pair(output_size)
    rows = bin_matrix(x.shape[2], oh, x.device)
    cols = bin_matrix(x.shape[3], ow, x.device)
    count = rows.sum(1)[:, None] * cols.sum(1)[None, :]
    with torch.autocast(x.device.type, enabled=False):
        sums = torch.matmul(torch.matmul(rows, x.float()), cols.T)
        return (sums * count.reciprocal()).to(x.dtype)
