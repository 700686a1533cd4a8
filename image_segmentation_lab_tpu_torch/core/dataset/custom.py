"""CustomDataset (counterpart of ``core/dataset/custom.py``).

The reference's dataset: an albumentations pipeline from YAML,
directory/suffix/split annotation scanning (sorted), per-image or global
original sizes, a custom class subset remapped through ``label_map``, the
palette of that subset (or a seed-42 random one), ``reduce_zero_label``
and ``ignore_index``.

The augmentation is split between host and device as in the JAX package:

* host, per item (this class): the file read, the decode and the
  pipeline's leading ``Resize`` (``_cpu_resize_pair``, cv2's
  interpolation), the only per-image work of variable shape;
* device, per batch: everything after that Resize, through
  ``device_pipeline`` (``data.Pipeline``; its Resize is the identity once
  the item has the target size).

Items are numpy ``(image uint8 HWC RGB, mask float32 HW, infos)``;
``collate_fn`` stacks them as the reference's collate does (uniform
original sizes -> one tuple and a stacked ``ori_gt``; mixed -> lists).
Decoding and resizing import OpenCV or Pillow inside the call; an item
already at the target size is not resized at all (``cv2.resize`` to the
same size is the identity), so synthetic items need neither library.
Images are decoded RGB.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...data.pipeline import Pipeline
from ...data.transforms import Compose, Resize
from ..fileio import HardDiskBackend, imread, list_from_file, resize_pair


class CustomDataset:
    """Base dataset (see the module docstring)."""

    CLASSES: Optional[Sequence[str]] = None
    PALETTE: Optional[Sequence[Sequence[int]]] = None

    def __init__(self,
                 pipeline,
                 img_dir,
                 img_suffix=".jpg",
                 ann_dir=None,
                 seg_map_suffix=".png",
                 split=None,
                 data_root=None,
                 test_mode=False,
                 ignore_index=255,
                 reduce_zero_label=False,
                 classes=None,
                 palette=None,
                 ori_img_size=None,
                 return_ori_seg_gt=False,
                 file_client=HardDiskBackend):
        self._init_pipeline(pipeline)

        self.img_dir = img_dir
        self.img_suffix = img_suffix
        self.ann_dir = ann_dir
        self.seg_map_suffix = seg_map_suffix
        self.split = split
        self.data_root = data_root
        self.test_mode = test_mode
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        self.label_map: Optional[Dict[int, int]] = None
        self.CLASSES, self.PALETTE = self.get_classes_and_palette(
            classes, palette)
        self.num_classes = len(self.CLASSES) if self.CLASSES else 0
        self.ori_img_size = tuple(ori_img_size) if ori_img_size else None
        self.file_client = (file_client() if isinstance(file_client, type)
                            else file_client)
        self.return_ori_seg_gt = return_ori_seg_gt
        if test_mode and self.CLASSES is None:
            raise ValueError(
                "`cls.CLASSES` or `classes` should be specified when testing")

        if self.data_root is not None:
            if not osp.isabs(self.img_dir):
                self.img_dir = osp.join(self.data_root, self.img_dir)
            if self.ann_dir is not None and not osp.isabs(self.ann_dir):
                self.ann_dir = osp.join(self.data_root, self.ann_dir)
            if self.split is not None and not osp.isabs(self.split):
                self.split = osp.join(self.data_root, self.split)

        self.img_infos = self.load_annotations(
            self.img_dir, self.img_suffix, self.ann_dir, self.seg_map_suffix,
            self.split)

    # ---------------------------------------------------------- pipeline
    def _init_pipeline(self, pipeline):
        """A YAML path, a ``Pipeline`` or a dict -> ``self.pipeline``, and
        the split between host and device."""
        if isinstance(pipeline, str):
            self.pipeline = Pipeline.from_yaml(pipeline)
        elif isinstance(pipeline, Pipeline):
            self.pipeline = pipeline
        else:
            self.pipeline = Pipeline.from_dict(pipeline)
        self._split_leading_resize()

    def _split_leading_resize(self):
        """Hoist the pipeline's leading Resize to the host decode."""
        self.cpu_resize: Optional[Resize] = None
        root = self.pipeline.root
        if isinstance(root, Compose) and root.transforms and isinstance(
                root.transforms[0], Resize):
            self.cpu_resize = root.transforms[0]
        self.device_pipeline = self.pipeline  # its Resize is then a no-op

    @property
    def input_size_hw(self) -> Optional[Tuple[int, int]]:
        if self.cpu_resize is not None:
            return (self.cpu_resize.height, self.cpu_resize.width)
        return None

    def _cpu_resize_pair(self, image, mask=None):
        """The item at the hoisted Resize's size, with both of its
        interpolations (the device Resize does nothing once the item has
        that size, so the YAML's ``mask_interpolation`` acts here)."""
        if self.cpu_resize is None:
            return image, mask
        size = (self.cpu_resize.height, self.cpu_resize.width)
        if image.shape[:2] == size and (mask is None
                                        or mask.shape[:2] == size):
            return image, mask
        return resize_pair(image, mask, size,
                           self.cpu_resize.interpolation != 0,
                           self.cpu_resize.mask_interpolation != 0)

    # ---------------------------------------------------------- scanning
    def __len__(self):
        return len(self.img_infos)

    def load_annotations(self, img_dir, img_suffix, ann_dir, seg_map_suffix,
                         split) -> List[Dict]:
        """The items, from ``split`` (one name a line) or from the files
        under ``img_dir`` with ``img_suffix``, sorted by file name."""
        img_infos = []
        if split is not None:
            for line in list_from_file(split):
                img_name = line.strip()
                info = dict(filename=img_name + img_suffix)
                if ann_dir is not None:
                    info["ann_filename"] = img_name + seg_map_suffix
                img_infos.append(info)
        else:
            for img in self.file_client.list_dir_or_file(
                    dir_path=img_dir, list_dir=False, suffix=img_suffix,
                    recursive=True):
                info = dict(filename=img)
                if ann_dir is not None:
                    info["ann_filename"] = img.replace(img_suffix,
                                                       seg_map_suffix)
                img_infos.append(info)
            img_infos = sorted(img_infos, key=lambda x: x["filename"])
        if len(img_infos) == 0:
            raise RuntimeError(f"No images with suffix '{img_suffix}' found "
                               f"in {img_dir}")
        print(f"Loaded {len(img_infos)} images")
        return img_infos

    def prepare_data_info(self, idx) -> Dict[str, Any]:
        img_info = self.img_infos[idx]
        infos = dict(
            img_file_path=osp.join(self.img_dir, img_info["filename"]))
        if self.ann_dir is not None and "ann_filename" in img_info:
            infos["ann_file_path"] = osp.join(self.ann_dir,
                                              img_info["ann_filename"])
        if self.ori_img_size:
            infos["ori_img_size_all"] = self.ori_img_size
        # else the decode records ori_img_size_each (_note_ori_size)
        return infos

    def __getitem__(self, idx):
        infos = self.prepare_data_info(idx)
        if self.test_mode:
            return self.prepare_test_data(infos)
        return self.prepare_train_val_data(infos)

    # ---------------------------------------------------------- items
    def _load_mask(self, path) -> np.ndarray:
        """Class indices: a palette ('P') PNG through Pillow (cv2's
        grayscale read would expand its palette to luminance), anything
        else as grayscale."""
        try:
            from PIL import Image
        except ImportError:
            raise ImportError("loading masks needs Pillow (PIL), to tell "
                              "palette PNGs apart") from None
        with Image.open(path) as im:
            if im.mode == "P":
                return self._postprocess_mask(
                    np.asarray(im).astype(np.int64))
        mask = imread(path, flag="grayscale").astype(np.int64)
        return self._postprocess_mask(mask)

    def _postprocess_mask(self, mask: np.ndarray) -> np.ndarray:
        if self.reduce_zero_label:
            # 0 -> ignore (255), every other id down by one
            mask[mask == 0] = 255
            mask = mask - 1
            mask[mask == 254] = 255
        if self.label_map is not None:
            out = mask.copy()
            for old_id, new_id in self.label_map.items():
                # an excluded class (-1) becomes ignore_index, as the
                # reference's uint8 masks wrap -1 to 255
                out[mask == old_id] = (self.ignore_index if new_id == -1
                                       else new_id)
            mask = out
        return mask

    def _note_ori_size(self, infos, image):
        if "ori_img_size_all" not in infos:
            infos["ori_img_size_each"] = tuple(image.shape[:2])

    def prepare_train_val_data(self, infos):
        image = imread(infos["img_file_path"], channel_order="rgb")
        self._note_ori_size(infos, image)
        ori_gt = self._load_mask(infos["ann_file_path"]).astype(np.float32)
        if self.return_ori_seg_gt:
            infos["ori_gt"] = ori_gt
        image, mask = self._cpu_resize_pair(image, ori_gt)
        return image, mask, infos

    def prepare_test_data(self, infos):
        image = imread(infos["img_file_path"], channel_order="rgb")
        self._note_ori_size(infos, image)
        image, _ = self._cpu_resize_pair(image)
        return image, None, infos

    # ---------------------------------------------------------- collate
    @staticmethod
    def collate_fn(batch):
        """Stack the items (one shape: the pipeline starts with a Resize,
        or the dataset's sizes are uniform) and merge their infos."""
        images, labels, infos = zip(*batch)
        shapes = {np.asarray(im).shape for im in images}
        if len(shapes) > 1:
            raise ValueError(
                f"cannot collate mixed image sizes {sorted(shapes)}; start "
                f"the augmentation YAML with a Resize")
        images = np.stack([np.asarray(im) for im in images])
        if labels[0] is not None:
            labels = np.stack([np.asarray(l) for l in labels])
        else:
            labels = None
        ori_img_size_all = infos[0].get("ori_img_size_all", None)

        batch_infos: Dict[str, Any] = {}
        for res in infos:
            for key, value in res.items():
                batch_infos.setdefault(key, []).append(value)

        if ori_img_size_all:
            batch_infos["ori_img_size_hw"] = tuple(ori_img_size_all)
            batch_infos.pop("ori_img_size_all")
            if "ori_gt" in batch_infos:
                batch_infos["ori_gt"] = np.stack(batch_infos["ori_gt"])
        else:
            batch_infos["ori_img_size_hw"] = [
                tuple(s) for s in batch_infos.pop("ori_img_size_each")]
        return images, labels, batch_infos

    # ---------------------------------------------------------- classes
    def get_classes_and_palette(self, classes=None, palette=None):
        """The class names (all, or the ``classes`` subset with its
        ``label_map``) and their palette."""
        if classes is None:
            self.custom_classes = False
            return self.CLASSES, self.PALETTE
        self.custom_classes = True
        if isinstance(classes, str):
            class_names = list_from_file(classes)
        elif isinstance(classes, (tuple, list)):
            class_names = list(classes)
        else:
            raise ValueError(f"Unsupported type {type(classes)} of classes.")
        if self.CLASSES:
            if not set(class_names).issubset(self.CLASSES):
                raise ValueError("classes is not a subset of CLASSES.")
            self.label_map = {}
            for i, c in enumerate(self.CLASSES):
                self.label_map[i] = (class_names.index(c)
                                     if c in class_names else -1)
            if all(self.label_map[i] == i for i in range(len(self.CLASSES))):
                self.label_map = None  # the identity
        palette = self.get_palette_for_custom_classes(class_names, palette)
        return class_names, palette

    def get_palette_for_custom_classes(self, class_names, palette=None):
        """The subset's rows of PALETTE, ``palette``, or a random palette
        from numpy's seed 42 (the global state restored after)."""
        if self.label_map is not None:
            palette = []
            for old_id, new_id in sorted(self.label_map.items(),
                                         key=lambda x: x[1]):
                if new_id != -1:
                    palette.append(self.PALETTE[old_id])
            palette = type(self.PALETTE)(palette)
        elif palette is None:
            if self.PALETTE is None:
                state = np.random.get_state()
                np.random.seed(42)
                palette = np.random.randint(0, 255,
                                            size=(len(class_names), 3))
                np.random.set_state(state)
            else:
                palette = self.PALETTE
        return palette
