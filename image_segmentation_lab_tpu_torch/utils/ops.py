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
backward adds with atomics (in bf16 for bf16 tensors).  Bicubic keeps
``F.interpolate``'s backward.

Nearest takes the JAX package's rule, ``src = min(floor(dst * in / out),
in - 1)`` with the ratio in float64, as two index selections:
``F.interpolate``'s nearest mode computes the ratio in float32 and picks
another row at some sizes (84 -> 160, 112 -> 48, 600 -> 288, ...).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize_backward import resize_backward


class BilinearResize(torch.autograd.Function):
    """``F.interpolate(x, size, mode="bilinear")`` with the gather backward
    of ``ops/resize_backward.py``."""

    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.in_size, ctx.align_corners = tuple(x.shape[2:]), align_corners
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=align_corners)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return (resize_backward(grad, ctx.in_size, ctx.align_corners),
                None, None)


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    rows = np.minimum(np.floor(np.arange(out_size) * (in_size / out_size)),
                      in_size - 1)
    return torch.from_numpy(rows.astype(np.int64)).to(device)


def resize(input, size: Sequence[int], mode: str = "bilinear",
           align_corners: Optional[bool] = None, warning: bool = True):
    size = tuple(int(s) for s in size)
    H, W = input.shape[2:]
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
    if mode == "nearest":
        return input.index_select(
            2, _nearest_index(H, size[0], input.device)).index_select(
            3, _nearest_index(W, size[1], input.device))
    with torch.autocast(input.device.type, enabled=False):
        if (mode == "bilinear" and torch.is_grad_enabled()
                and input.requires_grad):
            return BilinearResize.apply(input, size, bool(align_corners))
        return F.interpolate(input, size=size, mode=mode,
                             align_corners=bool(align_corners))


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
