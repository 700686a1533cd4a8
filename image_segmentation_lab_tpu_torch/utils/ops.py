"""Resize, upsample and ``add_prefix`` (counterpart of ``utils/ops.py``).

``resize`` is ``F.interpolate`` on NCHW tensors, with the reference's
advisory when ``align_corners=True`` meets sizes that do not line up.  The
JAX package builds its interpolation by hand because ``jax.image.resize``
lacks ``align_corners``; its float32 paths compute the same weights as
``F.interpolate``: bilinear, and bicubic (a = -0.75 cubic convolution,
border taps replicated, negative source coordinates left unclamped).

``Upsample`` recomputes an integer output size from ``scale_factor`` at
call time and resizes to that size, as the JAX module does.

The output keeps the input's dtype, as the JAX resize's does, also under
the bf16 policy: CUDA autocast would run ``F.interpolate`` in float32 (the
upsamples are on its float32 list), so resize steps out of autocast.  A
bf16 input is interpolated with float32 arithmetic inside
``F.interpolate``'s kernel and rounded once, on the CPU and the card alike,
as the JAX resize computes it.  Under grad, a bilinear resize goes through
``BilinearResize``, whose backward is ``ops/resize_backward.py``: float32
sums rounded once, with no atomics, where ``F.interpolate``'s own CUDA
backward adds with atomics (in bf16 for bf16 tensors).

Bicubic is the JAX package's separable form (``resize_bicubic``'s
matrices): an ``(out, in)`` cubic-convolution matrix per axis (a = -0.75,
at most four taps a row, clamped border taps summed into one column), and
two float32 products, rows then columns, rounded once to the input's
dtype.  Its backward is two products as well: deterministic, where
``F.interpolate``'s bicubic CUDA backward adds with atomics and has no
deterministic implementation.  BEiT's and MAE's tables take it under grad
on every train step.  The matrices are built once per geometry and device.

Nearest takes the JAX package's rule, ``src = min(floor(dst * in / out),
in - 1)`` with the ratio in float64, as two index selections:
``F.interpolate``'s nearest mode computes the ratio in float32 and picks
another row at some sizes (84 -> 160, 112 -> 48, 600 -> 288, ...).

``resize(x, scale_factor=s)`` gives ``int(H·s)`` rows, as the JAX resize
does, and maps coordinates with the user's scale, step ``1/s``, not the
ratio of the sizes (they differ where ``H·s`` is not whole: 25 rows at 0.5
give 12, read at step 2, not 25/12), as ``F.interpolate`` does when it is
given a scale factor.  The scale reaches every rule: the bilinear forward
and the tables of its backward (``resize_backward.axis_table``), the
bicubic matrices and the nearest index.  ``align_corners=True`` ignores
it.  ``Upsample`` recomputes an integer size and resizes to it.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize_backward import resize_backward


class BilinearResize(torch.autograd.Function):
    """``F.interpolate(x, size, mode="bilinear")`` with the separable backward
    of ``ops/resize_backward.py``."""

    @staticmethod
    def forward(ctx, x, size, align_corners, scales=None):
        ctx.in_size, ctx.align_corners = tuple(x.shape[2:]), align_corners
        ctx.scales = scales
        return _interpolate(x, size, "bilinear", align_corners, scales)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return (resize_backward(grad, ctx.in_size, ctx.align_corners,
                                ctx.scales), None, None, None)


def _interpolate(x, size, mode, align_corners, scales):
    """``F.interpolate`` to ``size``, or by the user's ``scales`` (whose
    output size is ``size``).  A bf16 bilinear resize on the CPU runs in
    float32 and rounds once, as the JAX resize does (and
    ``F.interpolate``'s CUDA kernel): the CPU kernel rounds some bf16 lerps
    otherwise (a 6 x 6 map to 80 x 80)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu" \
            and mode == "bilinear":
        return _interpolate(x.float(), size, mode, align_corners,
                            scales).to(x.dtype)
    if scales is None:
        return F.interpolate(x, size=size, mode=mode,
                             align_corners=align_corners)
    return F.interpolate(x, scale_factor=scales, mode=mode,
                         align_corners=align_corners,
                         recompute_scale_factor=False)


@functools.lru_cache(maxsize=256)
def _nearest_index(in_size: int, out_size: int, device,
                   scale: Optional[float] = None) -> torch.Tensor:
    step = 1.0 / scale if scale else in_size / out_size
    rows = np.minimum(np.floor(np.arange(out_size) * step), in_size - 1)
    return torch.from_numpy(rows.astype(np.int64)).to(device)


@functools.lru_cache(maxsize=64)
def bicubic_matrix(in_size: int, out_size: int, align_corners: bool,
                   device: torch.device = torch.device("cpu"),
                   dtype: torch.dtype = torch.float32,
                   scale: Optional[float] = None) -> torch.Tensor:
    """``(out_size, in_size)`` cubic-convolution matrix of one axis, as
    ``F.interpolate``'s bicubic weights it: taps at ``floor(src) - 1 ...
    floor(src) + 2``, clamped to the border (duplicates add up), and no
    clamp of a negative ``src``; step ``1/scale`` where a scale is given."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * ((in_size - 1) / (out_size - 1) if out_size > 1 else 0.0)
    else:
        src = (dst + 0.5) * (1.0 / scale if scale
                             else in_size / out_size) - 0.5
    i0 = np.floor(src)
    ax = np.abs(np.arange(-1, 3)[None, :] - (src - i0)[:, None])
    a = -0.75
    w = np.where(ax <= 1.0, ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
                 np.where(ax < 2.0,
                          ((a * ax - 5.0 * a) * ax + 8.0 * a) * ax - 4.0 * a,
                          0.0)).astype(np.float32)
    taps = np.clip(i0.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :],
                   0, in_size - 1)
    matrix = np.zeros((out_size, in_size), np.float32)
    np.add.at(matrix, (np.repeat(np.arange(out_size), 4), taps.ravel()),
              w.ravel())
    return torch.from_numpy(matrix).to(device=device, dtype=dtype)


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int],
                   align_corners: bool = False,
                   scales: Optional[Tuple[float, float]] = None
                   ) -> torch.Tensor:
    """Bicubic resize of an NCHW tensor as two matrix products, in float32
    (float64 for a float64 input) outside autocast, rounded once."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    sh, sw = scales or (None, None)
    rows = bicubic_matrix(x.shape[2], size[0], align_corners, x.device,
                          dtype, sh)
    cols = bicubic_matrix(x.shape[3], size[1], align_corners, x.device,
                          dtype, sw)
    with torch.autocast(x.device.type, enabled=False):
        return torch.matmul(torch.matmul(rows, x.to(dtype)),
                            cols.T).to(x.dtype)


def resize(input, size: Optional[Sequence[int]] = None,
           mode: str = "bilinear", align_corners: Optional[bool] = None,
           warning: bool = True, *,
           scale_factor: Optional[Union[float, Tuple[float, float]]] = None):
    H, W = input.shape[2:]
    scales = None
    if size is None:
        assert scale_factor is not None, "resize needs a size or a scale"
        scales = tuple(float(s) for s in (
            scale_factor if isinstance(scale_factor, (tuple, list))
            else (scale_factor, scale_factor)))
        size = (int(H * scales[0]), int(W * scales[1]))
    size = tuple(int(s) for s in size)
    if warning and align_corners:
        oh, ow = size
        if ((oh > 1 and ow > 1 and H > 1 and W > 1)
                and (oh - 1) % (H - 1) and (ow - 1) % (W - 1)):
            warnings.warn(
                f"When align_corners={align_corners}, the output would be "
                f"more aligned if input size {(H, W)} and out size {size} "
                f"satisfy (out-1) % (in-1) == 0")
    if (H, W) == size:
        return input
    sh, sw = scales or (None, None)
    if mode == "nearest":
        return input.index_select(
            2, _nearest_index(H, size[0], input.device, sh)).index_select(
            3, _nearest_index(W, size[1], input.device, sw))
    if mode == "bicubic":
        return resize_bicubic(input, size, bool(align_corners), scales)
    with torch.autocast(input.device.type, enabled=False):
        if (mode == "bilinear" and torch.is_grad_enabled()
                and input.requires_grad):
            return BilinearResize.apply(input, size, bool(align_corners),
                                        scales)
        return _interpolate(input, size, mode, bool(align_corners), scales)


class Upsample(nn.Module):

    def __init__(self, scale_factor: Union[float, Tuple[float, float]],
                 mode: str = "bilinear",
                 align_corners: Optional[bool] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x):
        sf = self.scale_factor
        sf = sf if isinstance(sf, (tuple, list)) else (sf, sf)
        size = (int(x.shape[2] * sf[0]), int(x.shape[3] * sf[1]))
        return resize(x, size=size, mode=self.mode,
                      align_corners=self.align_corners, warning=False)


def add_prefix(inputs: dict, prefix: str) -> dict:
    """``{k: v}`` -> ``{f'{prefix}.{k}': v}``."""
    return {f"{prefix}.{name}": value for name, value in inputs.items()}
