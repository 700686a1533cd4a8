"""Image decoding and directory listing for the datasets (counterpart of
``core/fileio/image_io.py`` and ``backend.py``).

``imread`` decodes with OpenCV, or with Pillow where OpenCV is missing,
each imported inside the call: importing the port loads neither (the GPU
machine has neither).  Colour images come back BGR unless
``channel_order='rgb'``, as the JAX package's ``imread`` gives them.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np

_CV2_FLAGS = {"color": 1, "grayscale": 0, "unchanged": -1}


def _decoder():
    """``("cv2", cv2)`` or ``("pillow", PIL.Image)``."""
    try:
        import cv2
        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return "pillow", Image
    except ImportError:
        raise ImportError("decoding images needs OpenCV (cv2) or Pillow "
                          "(PIL); neither is installed") from None


def imread(path, flag: str = "color",
           channel_order: str = "bgr") -> np.ndarray:
    """The image at ``path``: ``(H, W, 3)`` uint8 for ``flag='color'``,
    ``(H, W)`` for ``'grayscale'``, as stored for ``'unchanged'``."""
    if flag not in _CV2_FLAGS:
        raise ValueError(f"flag must be one of {sorted(_CV2_FLAGS)}, got "
                         f"{flag!r}")
    path = str(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"img file does not exist: {path}")
    backend, lib = _decoder()
    if backend == "cv2":
        img = lib.imread(path, _CV2_FLAGS[flag])
        if img is None:
            raise IOError(f"Failed to read image: {path}")
        if flag == "color" and channel_order == "rgb":
            img = lib.cvtColor(img, lib.COLOR_BGR2RGB)
        return img
    with lib.open(path) as im:
        if flag == "unchanged":
            return np.array(im)
        if flag == "grayscale":
            return np.array(im.convert("L"))
        img = np.array(im.convert("RGB"))
    return img if channel_order == "rgb" else np.ascontiguousarray(
        img[:, :, ::-1])


def resize_pair(image, mask, size_hw: Tuple[int, int], bilinear: bool,
                mask_bilinear: bool):
    """``image`` and ``mask`` (or None) resized on the host to ``size_hw``
    as cv2.resize does (Pillow where OpenCV is missing)."""
    h, w = size_hw
    backend, lib = _decoder()
    if backend == "cv2":
        def one(x, linear):
            return lib.resize(x, (w, h), interpolation=(
                lib.INTER_LINEAR if linear else lib.INTER_NEAREST))
    else:
        def one(x, linear):
            return np.asarray(lib.fromarray(x).resize(
                (w, h), lib.BILINEAR if linear else lib.NEAREST))
    return one(image, bilinear), (None if mask is None
                                  else one(mask, mask_bilinear))


class HardDiskBackend:
    """The local file system: sorted recursive listing with a suffix
    filter, paths relative to the listed directory."""

    name = "HardDiskBackend"

    def list_dir_or_file(self,
                         dir_path,
                         list_dir: bool = True,
                         list_file: bool = True,
                         suffix: Optional[Union[str, Tuple[str, ...]]] = None,
                         recursive: bool = False) -> Iterator[str]:
        if list_dir and suffix is not None:
            raise TypeError("`suffix` should be None when `list_dir` is True")
        if suffix is not None and not isinstance(suffix, (str, tuple)):
            raise TypeError("`suffix` must be a string or tuple of strings")
        root = str(dir_path)

        def _walk(d):
            for entry in sorted(os.scandir(d), key=lambda e: e.name):
                if not entry.name.startswith(".") and entry.is_file():
                    rel = os.path.relpath(entry.path, root)
                    if (suffix is None or rel.endswith(suffix)) and list_file:
                        yield rel
                elif os.path.isdir(entry.path):
                    if list_dir:
                        yield os.path.relpath(entry.path, root)
                    if recursive:
                        yield from _walk(entry.path)

        return _walk(root)


def list_from_file(filename, prefix: str = "", offset: int = 0,
                   max_num: int = 0, encoding: str = "utf-8") -> list:
    """The lines of a text file, each with ``prefix``."""
    item_list = []
    with open(filename, "r", encoding=encoding) as f:
        for _ in range(offset):
            f.readline()
        for line in f:
            if 0 < max_num <= len(item_list):
                break
            item_list.append(prefix + line.rstrip("\n\r"))
    return item_list
