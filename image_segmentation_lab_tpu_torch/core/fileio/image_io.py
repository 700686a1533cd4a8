"""Image decoding and writing, and directory listing for the datasets
(counterpart of ``core/fileio/image_io.py`` and ``backend.py``).

``imread`` decodes with OpenCV, or with Pillow where OpenCV is missing,
each imported inside the call: importing the port loads neither (the GPU
machine has neither).  Colour images come back BGR unless
``channel_order='rgb'``, as the JAX package's ``imread`` gives them.

``imwrite`` writes PNG files with its own encoder (the standard library's
``zlib``, ``struct`` and CRC32, no other writer): 8-bit RGB from a BGR
``(H, W, 3)`` uint8 image, as ``cv2.imwrite`` takes it; 8-bit palette
images (a ``PLTE`` chunk of 256 entries) from ``(H, W)`` uint8 indices and
a ``palette``, as Pillow writes a mode ``"P"`` image; 8- and 16-bit gray
from ``(H, W)`` uint8 or wider integers, where values outside [0, 65535]
are clipped, as Pillow writes a mode ``"I"`` image (PNG has no 32-bit
gray).
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple, Union

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


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray,
               palette: Optional[Sequence[Sequence[int]]] = None) -> bytes:
    """The PNG file of ``img`` (see the module docstring; a colour image is
    taken as RGB here): every scanline with filter 0, one ``IDAT``."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3 and palette is None:
        pixels, depth, colour = img.astype(np.uint8), 8, 2
    elif img.ndim == 2 and palette is not None:
        if img.dtype != np.uint8:
            raise TypeError(f"palette indices must be uint8, got {img.dtype}")
        pixels, depth, colour = img, 8, 3
    elif img.ndim == 2 and img.dtype in (np.uint8, np.bool_):
        pixels, depth, colour = img.astype(np.uint8), 8, 0
    elif img.ndim == 2 and np.issubdtype(img.dtype, np.integer):
        pixels = np.clip(img, 0, 65535).astype(">u2")
        depth, colour = 16, 0
    else:
        raise ValueError(f"cannot write a {img.dtype} image of shape "
                         f"{img.shape} as PNG")
    h, w = pixels.shape[:2]
    rows = np.ascontiguousarray(pixels).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    chunks = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                              colour, 0, 0, 0))]
    if colour == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = np.asarray(palette, np.uint8)
        chunks.append(_png_chunk(b"PLTE", table.tobytes()))
    chunks.append(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    chunks.append(_png_chunk(b"IEND", b""))
    return b"\x89PNG\r\n\x1a\n" + b"".join(chunks)


def imwrite(img: np.ndarray, file_path, auto_mkdir: bool = True,
            palette: Optional[Sequence[Sequence[int]]] = None) -> bool:
    """Write ``img`` to ``file_path`` as PNG (the only format written): a
    colour image is BGR, as ``cv2.imwrite`` takes it; ``palette`` makes a
    ``(H, W)`` uint8 image a palette image."""
    if Path(file_path).suffix.lower() != ".png":
        raise ValueError(f"imwrite writes PNG only, not {file_path}")
    img = np.asarray(img)
    if img.ndim == 3 and palette is None:
        img = img[..., ::-1]  # BGR -> RGB
    data = encode_png(img, palette)
    if auto_mkdir:
        Path(file_path).parent.mkdir(parents=True, exist_ok=True)
    with open(file_path, "wb") as f:
        f.write(data)
    return True


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
