"""Run directories and file listing (counterpart of
``core/fileio/path.py``): ``mkdir_or_exist``, the ``increment_path``
allocator that gives ``work_dir/project/exp``, then ``exp2``, ``exp3``,
... on collision, and ``scandir``."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

from .image_io import HardDiskBackend


def mkdir_or_exist(dir_name: Union[str, Path], mode: int = 0o777) -> None:
    if dir_name == "":
        return
    os.makedirs(os.path.expanduser(dir_name), mode=mode, exist_ok=True)


def increment_path(work_dir: Union[str, Path],
                   project: str = "runs",
                   name: str = "exp",
                   exist_ok: bool = False,
                   mkdir: bool = True) -> Path:
    """The next free run directory ``work_dir/project/name{,2,3...}``: the
    first run gets the bare ``name``, later ones ``name2``, ``name3``."""
    base = Path(work_dir) / project
    path = base / name
    if path.exists() and not exist_ok:
        n = 2
        while (base / f"{name}{n}").exists():
            n += 1
        path = base / f"{name}{n}"
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def scandir(dir_path, suffix=None, recursive: bool = False):
    """The relative paths of the files under ``dir_path`` that end in
    ``suffix`` (``HardDiskBackend.list_dir_or_file``'s listing)."""
    if isinstance(suffix, list):
        suffix = tuple(suffix)
    yield from HardDiskBackend().list_dir_or_file(
        dir_path, list_dir=False, suffix=suffix, recursive=recursive)
