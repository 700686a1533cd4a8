"""Resize (counterpart of ``utils/ops.py``).

``resize`` is ``F.interpolate`` on NCHW tensors, with the reference's
advisory when ``align_corners=True`` meets sizes that do not line up.  The
JAX package builds bilinear interpolation by hand because
``jax.image.resize`` lacks ``align_corners``; its float32 path computes the
same weights as ``F.interpolate``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch.nn.functional as F


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
