"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use on a CUDA tensor,
into ``_build/`` beside the package (git-ignored), keyed by a hash of the
source, every header (``*.cuh``) beside it and the flags, and loaded with
``ctypes``.  Nothing here includes
PyTorch's headers, so a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE / "csrc"
_BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc(source: Path) -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if not candidate.is_file():
            raise RuntimeError(
                f"nvcc not found (PATH or $CUDA_HOME/bin): {source.name} "
                f"cannot be built")
        nvcc = str(candidate)
    return nvcc


def library_digest(source: Path) -> str:
    """Hash of what a build of ``source`` depends on: the source, every
    ``*.cuh`` in its directory (a source may include any of them) and the
    flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def load_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` (once per digest) and load it."""
    source = _CSRC / source_name
    digest = library_digest(source)
    target = _BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"
    if not target.is_file():
        nvcc = _nvcc(source)
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a per-process name, then rename: concurrent builders
        # never load a half-written library
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(source.parent), "-o",
                        str(tmp), str(source)], check=True)
        os.replace(tmp, target)
    return ctypes.CDLL(str(target))
