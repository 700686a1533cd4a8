"""CityscapesDataset (counterpart of ``core/dataset/cityscapes.py``): the
19 trainId classes and palette, ``*_leftImg8bit.png`` images and
``*_gtFine_labelTrainIds.png`` masks, through ``CustomDataset``."""

from __future__ import annotations

from ..evaluation.class_names import get_classes, get_palette
from ..registry_hub import DATASET
from .custom import CustomDataset


@DATASET.register()
class CityscapesDataset(CustomDataset):
    CLASSES = tuple(get_classes("cityscapes"))
    PALETTE = get_palette("cityscapes")

    def __init__(self,
                 img_suffix="_leftImg8bit.png",
                 seg_map_suffix="_gtFine_labelTrainIds.png",
                 **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)
