"""SyntheticDataset (counterpart of ``core/dataset/synthetic.py``): random
dark backgrounds with one bright noisy disk per foreground class, from a
fixed numpy seed, bit-identical to the JAX package's items.  Items that
already have the pipeline's size are not resized, so it needs neither
OpenCV nor Pillow at that size."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..registry_hub import DATASET
from .custom import CustomDataset


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


@DATASET.register()
class SyntheticDataset(CustomDataset):
    """``length`` items of ``make_synthetic_item`` (counterpart of the JAX
    package's ``SyntheticDataset``): the same items, the same infos."""

    CLASSES = ["background", "object"]
    PALETTE = [[0, 0, 0], [0, 63, 255]]

    def __init__(self,
                 pipeline,
                 length: int = 64,
                 image_size: Tuple[int, int] = (160, 160),
                 num_classes: int = 2,
                 seed: int = 0,
                 return_ori_seg_gt: bool = False,
                 ignore_index: int = 255,
                 classes=None,
                 palette=None,
                 **_ignored):
        if num_classes != 2:
            self.CLASSES = [f"class_{i}" for i in range(num_classes)]
            rng = np.random.RandomState(42)
            self.PALETTE = rng.randint(0, 255, (num_classes, 3)).tolist()
        self._init_pipeline(pipeline)
        self.length = int(length)
        self.image_size = tuple(image_size)
        self.seed = seed
        self.return_ori_seg_gt = return_ori_seg_gt
        self.ignore_index = ignore_index
        self.reduce_zero_label = False
        self.label_map = None
        self.CLASSES, self.PALETTE = self.get_classes_and_palette(
            classes, palette)
        self.num_classes = len(self.CLASSES)
        self.ori_img_size = self.image_size
        self.test_mode = False
        self.img_infos = [dict(filename=f"synthetic_{i:05d}.jpg")
                          for i in range(self.length)]

    def __len__(self):
        return self.length

    def prepare_data_info(self, idx):
        return dict(img_file_path=self.img_infos[idx]["filename"],
                    ori_img_size_all=self.image_size)

    def __getitem__(self, idx):
        infos = self.prepare_data_info(idx)
        image, ori_gt = make_synthetic_item(idx, self.image_size,
                                            self.num_classes, self.seed)
        if self.return_ori_seg_gt:
            infos["ori_gt"] = ori_gt
        image, mask = self._cpu_resize_pair(image, ori_gt)
        return image, mask, infos
