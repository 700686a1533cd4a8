"""Resize, upsample and ``add_prefix`` (counterpart of ``utils/ops.py``).

``resize`` is ``F.interpolate`` on NCHW tensors, with the reference's
advisory when ``align_corners=True`` meets sizes that do not line up.  The
JAX package builds its interpolation by hand because ``jax.image.resize``
lacks ``align_corners``; its float32 paths compute the same weights as
``F.interpolate``: bilinear, and bicubic (a = -0.75 cubic convolution,
border taps replicated, negative source coordinates left unclamped).

``Upsample`` recomputes an integer output size from ``scale_factor`` at
call time and resizes to that size, as the JAX module does.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple, Union

import torch.nn.functional as F
from torch import nn


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
