"""Synthetic images and masks (counterpart of the image generator of
``core/dataset/synthetic.py``): random dark backgrounds with one bright
noisy disk per foreground class, from a fixed numpy seed, bit-identical to
the JAX package's ``SyntheticDataset._make_item``."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_synthetic_item(idx: int, image_size: Tuple[int, int] = (160, 160),
                        num_classes: int = 2, seed: int = 0):
    """``(image (H, W, 3) uint8, mask (H, W) float32)`` for item ``idx``."""
    rng = np.random.RandomState(seed * 100003 + idx)
    h, w = image_size
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), np.float32)
    image = rng.randint(0, 60, (h, w, 3)).astype(np.float32)
    for c in range(1, num_classes):
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(
            w // 4, 3 * w // 4)
        r = rng.randint(min(h, w) // 8, min(h, w) // 4)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
        mask[blob] = c
        color = rng.randint(100, 255, 3)
        image[blob] = color + rng.randn(int(blob.sum()), 3) * 10
    image = np.clip(image + rng.randn(h, w, 3) * 8, 0, 255)
    return image.astype(np.uint8), mask
