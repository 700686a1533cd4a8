"""Bilinear resize backward: the hand-written CUDA kernel and its plain
version.

``resize_backward(g, in_size, align_corners)`` is the gradient of
``F.interpolate(x, size, mode="bilinear", align_corners=...)`` with respect
to its NCHW input ``x`` of spatial size ``in_size``, for the output
gradient ``g``, in g's dtype (x's: the forward keeps it).  It reads g in
its own dtype, sums in float32 (float64 for float64 on the CPU) and rounds
once, as the gradient of the JAX resize, which interpolates in float32 and
casts once (``image_segmentation_lab_tpu/utils/ops.py::resize_bilinear``).

The sums are gathers over per-axis tables (``axis_table``): for each input
index, the output indices whose lerp reads it and their float32 weights,
computed as ``F.interpolate``'s forward computes them, so the backward is
that forward's transpose.  For CPU tensors the wrapper computes the plain
version (``resize_backward_plain``: the same taps in the same order,
``index_select`` per row tap); for CUDA tensors it launches the kernel of
``csrc/resize_backward.cu`` (float32 or bfloat16, built at first use by
``ops/nvcc_build.py``) or raises.  Both read the same tables and take
every step rounded in the same order, so they give the same bits, and no
atomics: the same bits from call to call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .nvcc_build import load_library

# launches per dtype (float32, bfloat16), counted where the kernel is
# launched and nowhere else
launches = {"resize_backward": 0, "resize_backward_bf16": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the resize backward
    kernel."""
    global _lib
    if _lib is None:
        lib = load_library("resize_backward.cu")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # g, dx, dtype, planes, in_h, in_w, out_h, out_w, the row table
        # (indices, weights, taps), the column table, stream
        lib.resize_backward_bilinear.argtypes = (
            [ptr, ptr, i32, ctypes.c_int64] + [i32] * 4
            + [ptr, ptr, i32] * 2 + [ptr])
        lib.resize_backward_bilinear.restype = i32
        lib.resize_backward_error_string.argtypes = [i32]
        lib.resize_backward_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def axis_table(in_size: int, out_size: int, align_corners: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(indices, weights)`` of one axis, each ``(in_size, taps)``: input
    index i reads output indices ``indices[i]`` (ascending, then padded
    with -1 to the most taps of any input index) with ``weights[i]`` (0
    where padded).  The weights are ``F.interpolate``'s, in float32 step by
    step: ``src = scale·o`` with ``scale = (in-1)/(out-1)``
    (``align_corners``), else ``src = max(scale·(o + 0.5) - 0.5, 0)`` with
    ``scale = in/out``; ``i0 = min(floor(src), in - 1)``, ``i1 = i0 + 1``
    below the last index, ``w1 = src - i0``, ``w0 = 1 - w1``.  Where both
    taps of an output fall on one input (the last index), their weights are
    added; zero weights are left out."""
    o = np.arange(out_size, dtype=np.float32)
    if align_corners:
        scale = (np.float32(in_size - 1) / np.float32(out_size - 1)
                 if out_size > 1 else np.float32(0))
        src = scale * o
    else:
        scale = np.float32(in_size) / np.float32(out_size)
        src = np.maximum(scale * (o + np.float32(0.5)) - np.float32(0.5),
                         np.float32(0))
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    w1 = np.clip(src - i0.astype(np.float32), 0, 1).astype(np.float32)
    i1 = i0 + (i0 < in_size - 1)
    matrix = np.zeros((in_size, out_size), np.float32)  # A transposed
    np.add.at(matrix, (i0, np.arange(out_size)), np.float32(1) - w1)
    np.add.at(matrix, (i1, np.arange(out_size)), w1)
    counts = (matrix != 0).sum(axis=1)
    indices = np.full((in_size, max(int(counts.max()), 1)), -1, np.int32)
    weights = np.zeros(indices.shape, np.float32)
    rows, cols = np.nonzero(matrix)  # row-major: ascending cols per row
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    indices[rows, slot] = cols
    weights[rows, slot] = matrix[rows, cols]
    return indices, weights


@functools.lru_cache(maxsize=None)
def _tables(in_size, out_size, align_corners, device):
    """``axis_table`` on ``device``: int32 indices, float32 weights."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in axis_table(in_size, out_size, align_corners))


def _check(g, in_size):
    if g.dim() != 4 or len(in_size) != 2 or min(in_size) < 1:
        raise ValueError(f"expected an NCHW gradient and a 2-d input size, "
                         f"got {tuple(g.shape)} and {tuple(in_size)}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g.device}")
    if g.device.type == "cuda" and g.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{g.dtype}")


def resize_backward_plain(g: torch.Tensor, in_size: Sequence[int],
                          align_corners: bool) -> torch.Tensor:
    """The kernel's sums in plain torch: for each row tap and, within it,
    each column tap, ``acc + (w_row·w_col)·g`` in float32 (float64 for
    float64), every step rounded, padded taps left out; then g's dtype."""
    (in_h, in_w), (out_h, out_w) = in_size, g.shape[2:]
    acc_dtype = torch.promote_types(g.dtype, torch.float32)
    row_idx, row_w = _tables(in_h, out_h, align_corners, g.device)
    col_idx, col_w = _tables(in_w, out_w, align_corners, g.device)
    col_ok, cols = col_idx >= 0, col_idx.clamp(min=0).long()
    gf = g.to(acc_dtype)
    acc = torch.zeros((*g.shape[:2], in_h, in_w), dtype=acc_dtype,
                      device=g.device)
    for a in range(row_idx.shape[1]):
        # every column tap of this row tap at once, (N, C, in_h, in_w, taps)
        vals = gf.index_select(2, row_idx[:, a].clamp(min=0))[..., cols]
        terms = torch.where(
            (row_idx[:, a, None, None] >= 0) & col_ok,
            (row_w[:, a, None, None].to(acc_dtype) * col_w.to(acc_dtype))
            * vals, 0)
        for b in range(cols.shape[1]):
            acc = acc + terms[..., b]
    return acc.to(g.dtype)


def resize_backward(g: torch.Tensor, in_size: Sequence[int],
                    align_corners: bool) -> torch.Tensor:
    """dx ``(N, C, *in_size)`` in g's dtype of a bilinear resize to g's
    spatial size; see the module docstring."""
    in_size = tuple(int(s) for s in in_size)
    _check(g, in_size)
    if g.device.type == "cpu":
        return resize_backward_plain(g, in_size, align_corners)
    g = g.contiguous()
    n, c, out_h, out_w = g.shape
    in_h, in_w = in_size
    dx = torch.empty((n, c, in_h, in_w), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    if max(g.numel(), dx.numel()) >= 2 ** 31:
        raise ValueError("the kernel indexes elements with 32-bit ints")
    row_idx, row_w = _tables(in_h, out_h, bool(align_corners), g.device)
    col_idx, col_w = _tables(in_w, out_w, bool(align_corners), g.device)
    lib = build_library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.resize_backward_bilinear(
            g.data_ptr(), dx.data_ptr(), _DTYPES[g.dtype], n * c, in_h, in_w,
            out_h, out_w, row_idx.data_ptr(), row_w.data_ptr(),
            row_idx.shape[1], col_idx.data_ptr(), col_w.data_ptr(),
            col_idx.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"resize backward kernel launch failed: "
                           f"{lib.resize_backward_error_string(err).decode()}")
    launches["resize_backward_bf16" if g.dtype == torch.bfloat16
             else "resize_backward"] += 1
    return dx
