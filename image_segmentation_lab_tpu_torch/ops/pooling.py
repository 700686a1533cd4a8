"""Pooling on NCHW tensors (counterpart of ``ops/pooling.py``'s
``adaptive_avg_pool2d``, ``avg_pool2d`` and ``max_pool2d``).

``max_pool2d`` pads each spatial axis by the JAX package's rule
(``_pool_padding``: torch's, with ``ceil_mode``'s last window starting
inside the left-padded input) with -inf, then takes ``F.max_pool2d``
without padding.  ``F.max_pool2d`` is looked up at call time.

``avg_pool2d`` keeps torch's windows (``ceil_mode``'s last window clipped
to the input, ``count_include_pad`` counting explicit padding but not the
overhang), as the JAX function does: the window sums in float32 (float64
for float64) by ``F.avg_pool2d`` with ``divisor_override=1``, then the
division by each window's count, rounded once to the input's dtype.  The
JAX function under ``jax.jit``, as its models run it, divides by the count
when the padding counts and multiplies by the count's float32 reciprocal
when it does not (XLA folds that count to a constant and turns the
division into the product); the port takes the same rule, so where the
window sums are exact the bits are the JAX package's.  XLA picks the order
of the window sums by shape (row-major taps, column-major taps or a
reshaped reduction), so elsewhere they differ in the last bits.  The
backward is ``F.avg_pool2d``'s, a gather on the card with no atomics.

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

import functools
from typing import Tuple, Union

import numpy as np
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


def _window_counts(size: int, k: int, s: int, p: int, ceil_mode: bool,
                   count_include_pad: bool) -> np.ndarray:
    """The number of counted taps of each window along one axis."""
    top, bottom = _pool_padding(size, k, s, p, ceil_mode)
    out = (size + top + bottom - k) // s + 1
    starts = np.arange(out) * s - p
    lo, hi = (-p, size + p) if count_include_pad else (0, size)
    return (np.minimum(starts + k, hi) - np.maximum(starts, lo)).astype(
        np.float32)


@functools.lru_cache(maxsize=256)
def _counts(hw, kernel, stride, padding, ceil_mode, count_include_pad,
            device, dtype):
    """Each window's count, ``(out_h, out_w)`` on ``device``: made once per
    geometry, so a call copies nothing from the host."""
    rows, cols = (_window_counts(n, k, s, p, ceil_mode, count_include_pad)
                  for n, k, s, p in zip(hw, kernel, stride, padding))
    return torch.from_numpy(rows[:, None] * cols[None, :]).to(device, dtype)


def avg_pool2d(x: torch.Tensor, kernel_size: IntPair, stride: IntPair = None,
               padding: IntPair = 0, ceil_mode: bool = False,
               count_include_pad: bool = True) -> torch.Tensor:
    kernel = _pair(kernel_size)
    stride = _pair(stride if stride is not None else kernel_size)
    padding = _pair(padding)
    acc = torch.promote_types(x.dtype, torch.float32)
    count = _counts(tuple(x.shape[2:]), kernel, stride, padding, ceil_mode,
                    count_include_pad, x.device, acc)
    with torch.autocast(x.device.type, enabled=False):
        sums = F.avg_pool2d(x.to(acc), kernel, stride, padding,
                            ceil_mode=ceil_mode, divisor_override=1)
        out = (sums / count if count_include_pad
               else sums * count.reciprocal())
        return out.to(x.dtype)


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
