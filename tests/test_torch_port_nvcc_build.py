"""The nvcc build helper's cache key, on the CPU (no ``nvcc`` needed).

A library is rebuilt when anything it is compiled from changes: its source
and every header beside it, which the bf16 kernels share
(``csrc/sm90_wgmma.cuh``).  ``nvcc`` itself is replaced by a stub that
writes the library file, and ``ctypes.CDLL`` by one that returns its path.
"""

import fnmatch
import re
import tomllib
from pathlib import Path

import pytest

from image_segmentation_lab_tpu_torch.ops import nvcc_build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def csrc(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kernel.cu").write_text('#include "shared.cuh"\n')
    (src / "shared.cuh").write_text("// v1\n")
    return src


def test_digest_follows_the_source_and_every_header(csrc):
    source = csrc / "kernel.cu"
    first = nvcc_build.library_digest(source)
    assert nvcc_build.library_digest(source) == first
    (csrc / "shared.cuh").write_text("// v2\n")
    second = nvcc_build.library_digest(source)
    assert second != first
    (csrc / "other.cuh").write_text("// new header\n")
    third = nvcc_build.library_digest(source)
    assert third not in (first, second)
    (csrc / "kernel.cu").write_text('#include "shared.cuh"\n// edit\n')
    assert nvcc_build.library_digest(source) not in (first, second, third)


def test_digest_ignores_files_that_are_not_headers(csrc):
    source = csrc / "kernel.cu"
    first = nvcc_build.library_digest(source)
    (csrc / "notes.txt").write_text("not compiled\n")
    (csrc / "unrelated.cu").write_text("// another library\n")
    assert nvcc_build.library_digest(source) == first


def test_a_header_edit_rebuilds_with_the_header_directory_included(
        csrc, tmp_path, monkeypatch):
    builds = []

    def fake_nvcc(cmd, check):
        builds.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"library")

    monkeypatch.setattr(nvcc_build, "_CSRC", csrc)
    monkeypatch.setattr(nvcc_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc_build, "_nvcc", lambda source: "nvcc")
    monkeypatch.setattr(nvcc_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(nvcc_build.ctypes, "CDLL", lambda path: path)

    first = nvcc_build.load_library("kernel.cu")
    assert nvcc_build.load_library("kernel.cu") == first  # cached
    assert len(builds) == 1
    cmd = builds[0]
    assert cmd[cmd.index("-I") + 1] == str(csrc)
    (csrc / "shared.cuh").write_text("// v2\n")
    second = nvcc_build.load_library("kernel.cu")
    assert len(builds) == 2 and second != first


def test_package_data_ships_every_included_header():
    """Every ``#include "..."`` of a ``csrc/`` source names a file that the
    package data of ``pyproject.toml`` ships, so an installed port builds
    its kernels as a source checkout does."""
    with open(REPO / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "image_segmentation_lab_tpu_torch"]
    csrc = REPO / "image_segmentation_lab_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu*"))
    included = {name for src in sources for name in re.findall(
        r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M)}
    assert {"sm90_bf16x3.cuh", "sm90_wgmma.cuh"} <= included
    for path in sources + [csrc / name for name in included]:
        assert path.is_file(), path
        rel = path.relative_to(csrc.parent).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
