"""Standard-benchmark dataset classes (counterpart of
``core/dataset/standard_datasets.py``: ADE20K, VOC, COCO-Stuff, LoveDA,
Potsdam, Vaihingen, iSAID, and the retinal-vessel sets STARE, DRIVE,
CHASE_DB1, HRF).

The reference only ships Kvasir (+ an orphaned cityscapes config) but its
evaluation tables cover ten datasets (core/evaluation/class_names.py);
these registry entries make the common benchmarks usable directly with the
generic CustomDataset loading + an albumentations-YAML pipeline.
"""

from __future__ import annotations

from ..evaluation.class_names import get_classes, get_palette
from ..registry_hub import DATASET
from .custom import CustomDataset


@DATASET.register()
class ADE20KDataset(CustomDataset):
    """ADE20K: 150 classes, ids shifted down by one (0 = ignore)."""

    CLASSES = tuple(get_classes("ade"))
    PALETTE = get_palette("ade")

    def __init__(self, img_suffix=".jpg", seg_map_suffix=".png",
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix,
                         reduce_zero_label=reduce_zero_label, **kwargs)


@DATASET.register()
class PascalVOCDataset(CustomDataset):
    """Pascal VOC 2012: 21 classes, split files under ImageSets/Segmentation."""

    CLASSES = tuple(get_classes("voc"))
    PALETTE = get_palette("voc")

    def __init__(self, img_suffix=".jpg", seg_map_suffix=".png", split=None,
                 **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, split=split,
                         **kwargs)


@DATASET.register()
class COCOStuffDataset(CustomDataset):
    """COCO-Stuff (164k layout): 171 classes, ``_labelTrainIds.png`` masks."""

    CLASSES = tuple(get_classes("cocostuff"))
    PALETTE = get_palette("cocostuff")

    def __init__(self, img_suffix=".jpg",
                 seg_map_suffix="_labelTrainIds.png", **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)


@DATASET.register()
class LoveDADataset(CustomDataset):
    """LoveDA remote sensing: 7 classes, ids shifted down by one (0 = ignore)."""

    CLASSES = tuple(get_classes("loveda"))
    PALETTE = get_palette("loveda")

    def __init__(self, img_suffix=".png", seg_map_suffix=".png",
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix,
                         reduce_zero_label=reduce_zero_label, **kwargs)


@DATASET.register()
class PotsdamDataset(CustomDataset):
    """ISPRS Potsdam aerial tiles: 6 classes, ids shifted down by one."""

    CLASSES = tuple(get_classes("potsdam"))
    PALETTE = get_palette("potsdam")

    def __init__(self, img_suffix=".png", seg_map_suffix=".png",
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix,
                         reduce_zero_label=reduce_zero_label, **kwargs)


@DATASET.register()
class VaihingenDataset(CustomDataset):
    """ISPRS Vaihingen aerial tiles: same label contract as Potsdam."""

    CLASSES = tuple(get_classes("vaihingen"))
    PALETTE = get_palette("vaihingen")

    def __init__(self, img_suffix=".png", seg_map_suffix=".png",
                 reduce_zero_label=True, **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix,
                         reduce_zero_label=reduce_zero_label, **kwargs)


@DATASET.register()
class iSAIDDataset(CustomDataset):
    """iSAID aerial instance-as-semantic: 16 classes, 255 = ignore."""

    CLASSES = tuple(get_classes("isaid"))
    PALETTE = get_palette("isaid")

    def __init__(self, img_suffix=".png",
                 seg_map_suffix="_instance_color_RGB.png", **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)


@DATASET.register()
class STAREDataset(CustomDataset):
    """STARE retinal vessels: binary fg/bg, ``.ah.png`` annotations."""

    CLASSES = tuple(get_classes("stare"))
    PALETTE = get_palette("stare")

    def __init__(self, img_suffix=".png", seg_map_suffix=".ah.png",
                 **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)


@DATASET.register()
class DRIVEDataset(CustomDataset):
    """DRIVE retinal vessels: binary fg/bg, ``_manual1.png`` annotations."""

    CLASSES = tuple(get_classes("drive"))
    PALETTE = get_palette("drive")

    def __init__(self, img_suffix=".png", seg_map_suffix="_manual1.png",
                 **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)


@DATASET.register()
class ChaseDB1Dataset(CustomDataset):
    """CHASE_DB1 retinal vessels: binary fg/bg, ``_1stHO.png`` annotations."""

    CLASSES = tuple(get_classes("chase_db1"))
    PALETTE = get_palette("chase_db1")

    def __init__(self, img_suffix=".png", seg_map_suffix="_1stHO.png",
                 **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)


@DATASET.register()
class HRFDataset(CustomDataset):
    """HRF retinal vessels: binary fg/bg, plain ``.png`` annotations."""

    CLASSES = tuple(get_classes("hrf"))
    PALETTE = get_palette("hrf")

    def __init__(self, img_suffix=".png", seg_map_suffix=".png", **kwargs):
        super().__init__(img_suffix=img_suffix,
                         seg_map_suffix=seg_map_suffix, **kwargs)
