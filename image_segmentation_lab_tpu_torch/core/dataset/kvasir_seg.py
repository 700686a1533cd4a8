"""KvasirSegDataset (counterpart of ``core/dataset/kvasir_seg.py``):
background/polyp, masks binarised at 250 to {0, 1}; in val mode the
original-resolution ground truth can ride along (``return_ori_seg_gt``)."""

from __future__ import annotations

import numpy as np

from ..fileio import imread
from ..registry_hub import DATASET
from .custom import CustomDataset


@DATASET.register()
class KvasirSegDataset(CustomDataset):
    CLASSES = ["background", "polyp"]
    PALETTE = [[0, 0, 0], [0, 63, 255]]

    def prepare_train_val_data(self, infos):
        image = imread(infos["img_file_path"], channel_order="rgb")
        self._note_ori_size(infos, image)
        ori_gt = imread(infos["ann_file_path"], flag="grayscale").astype(
            np.float32)
        ori_gt = (ori_gt >= 250).astype(np.float32)  # {0, 1}
        if self.return_ori_seg_gt:
            infos["ori_gt"] = ori_gt
        image, mask = self._cpu_resize_pair(image, ori_gt)
        return image, mask, infos
