"""Bilinear resize backward: the hand-written CUDA kernel and its plain
version.

``resize_backward(g, in_size, align_corners)`` is the gradient of
``F.interpolate(x, size, mode="bilinear", align_corners=...)`` with respect
to its NCHW input ``x`` of spatial size ``in_size``, for the output
gradient ``g``, in g's dtype (x's: the forward keeps it).  It reads g in
its own dtype, sums in float32 (float64 for float64 on the CPU) and rounds
once, as the gradient of the JAX resize, which interpolates in float32 and
casts once (``image_segmentation_lab_tpu/utils/ops.py::resize_bilinear``).

The sums are separable, over per-axis tables (``axis_table``): for each
input index, the output indices whose lerp reads it and their float32
weights, computed as ``F.interpolate``'s forward computes them, so the
backward is that forward's transpose.  First the W pass, ``h[o, j] =
sum_p w_col[j, p]·g[o, p]`` (ascending p), then the H pass, ``dx[i, j] =
sum_o w_row[i, o]·h[o, j]`` (ascending o), each step rounded in float32.
For CPU tensors the wrapper computes the plain version
(``resize_backward_plain``: those steps in that order, a column or row tap
at a time); for CUDA tensors it launches the kernel of
``csrc/resize_backward.cu`` (float32 or bfloat16, built at first use by
``ops/nvcc_build.py``) on the tiles that ``_plan`` lays out, summing each
axis by input index or, where no input index has more than two taps, by a
scan over the output indices (``_axis``), or raises.  Both take the same
steps in the same order, so they give the same bits, and no atomics: the
same bits from call to call.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Sequence, Tuple

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
        # g, dx, dtype, planes, in_h, in_w, out_h, out_w; per axis (rows,
        # columns) the method, table, its ints, stride, spans and chunk;
        # the bands and their count, band_rows, tile_planes, rows_max,
        # stage_rows, g_pitch, h_pitch, stream
        lib.resize_backward_bilinear.argtypes = (
            [ptr, ptr, i32, ctypes.c_int64] + [i32] * 4
            + [i32, ptr, i32, i32, ptr, i32] * 2
            + [ptr, i32] + [i32] * 6 + [ptr])
        lib.resize_backward_bilinear.restype = i32
        lib.resize_backward_error_string.argtypes = [i32]
        lib.resize_backward_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def axis_table(in_size: int, out_size: int, align_corners: bool,
               scale: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(indices, weights)`` of one axis, each ``(in_size, taps)``: input
    index i reads output indices ``indices[i]`` (ascending, then padded
    with -1 to the most taps of any input index) with ``weights[i]`` (0
    where padded).  The weights are ``F.interpolate``'s, in float32 step by
    step: ``src = scale·o`` with ``scale = (in-1)/(out-1)``
    (``align_corners``), else ``src = max(scale·(o + 0.5) - 0.5, 0)`` with
    ``scale = in/out``, or ``1/scale`` rounded to float32 where the resize
    was given a scale factor (not with ``align_corners``: ``F.interpolate``
    takes the user's scale, see ``utils/ops.resize``);
    ``i0 = min(floor(src), in - 1)``, ``i1 = i0 + 1``
    below the last index, ``w1 = src - i0``, ``w0 = 1 - w1``.  Where both
    taps of an output fall on one input (the last index), their weights are
    added; zero weights are left out."""
    o = np.arange(out_size, dtype=np.float32)
    if align_corners:
        scale = (np.float32(in_size - 1) / np.float32(out_size - 1)
                 if out_size > 1 else np.float32(0))
        src = scale * o
    else:
        scale = (np.float32(1.0 / scale) if scale
                 else np.float32(in_size) / np.float32(out_size))
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
def _tables(in_size, out_size, align_corners, device, scale=None):
    """``axis_table`` on ``device``: int32 indices and float32 weights
    (for the plain version)."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in axis_table(in_size, out_size, align_corners,
                                     scale))


def _sums_table(in_size, out_size, align_corners, scale=None):
    """``axis_table`` as the kernel's sums read it, ``(in, stride)`` int32:
    for each input index its first output index, its number of taps and
    two ints of padding, then the taps' float32 weights' bits, the rows
    padded to a multiple of 4 ints (16 bytes).  The outputs that read one
    input index are consecutive."""
    indices, weights = axis_table(in_size, out_size, align_corners, scale)
    counts = (indices >= 0).sum(1)
    first = np.where(counts > 0, indices[:, 0], 0)
    assert all((indices[i, :n] == first[i] + np.arange(n)).all()
               for i, n in enumerate(counts))
    taps = weights.shape[1]
    table = np.zeros((in_size, 4 + -(-taps // 4) * 4), np.int32)
    table[:, 0], table[:, 1] = first, counts
    table[:, 4:4 + taps] = weights.view(np.int32)
    return table


def _scan_tables(in_size, out_size, align_corners, chunk, scale=None):
    """``axis_table`` as the kernel's scans read it.  ``taps``, ``(out,
    4)`` int32: for each output index the lower input index it reads, that
    input's weight, the next input's weight (0 where it reads one input),
    0; weights as float32 bits.  ``spans``, ``(chunks, 2)`` int32: for
    each chunk of ``chunk`` input indices the first output index that
    reads one of them and one past the last ((0, 0) where none does)."""
    indices, weights = axis_table(in_size, out_size, align_corners, scale)
    valid = indices >= 0
    inputs, outputs = np.nonzero(valid)[0], indices[valid]
    w = weights[valid]
    order = np.lexsort((inputs, outputs))  # by output, then input
    inputs, outputs, w = inputs[order], outputs[order], w[order]
    lower = np.ones(len(outputs), bool)
    lower[1:] = outputs[1:] != outputs[:-1]
    assert (outputs[lower] == np.arange(out_size)).all()
    taps = np.zeros((out_size, 4), np.int32)
    taps[:, 0] = inputs[lower]
    taps[:, 1] = w[lower].view(np.int32)
    assert (inputs[~lower] == taps[outputs[~lower], 0] + 1).all()
    taps[outputs[~lower], 2] = w[~lower].view(np.int32)
    first = np.where(valid.any(1), indices[:, 0], out_size)
    end = np.where(valid, indices, -1).max(1) + 1
    spans = np.array([(first[k:k + chunk].min(), end[k:k + chunk].max())
                      for k in range(0, in_size, chunk)], np.int32)
    spans[spans[:, 1] == 0] = 0
    return taps, spans


# how an axis's pass sums (csrc/resize_backward.cu Method): over each input
# index's taps, kCols columns or kRows rows a unit at once (SUMS), or by a
# scan over the output indices, about W_SCAN or H_SCAN of them a unit
# (SCAN), where no input index has more than two taps (a downsample)
SUMS, SCAN = 0, 1
KCOLS, KROWS = 4, 4
W_SCAN, H_SCAN = 48, 16


def _scans(in_size, out_size, align_corners, scale=None):
    """Whether the kernel sums this axis by a scan: where no input index
    has more than two taps (a downsample)."""
    return (axis_table(in_size, out_size, align_corners, scale)[0]
            >= 0).sum(1).max() <= 2


def _scan_chunk(in_size, out_size, outputs):
    """Input indices of a SCAN unit that reads about ``outputs`` output
    indices."""
    return max(1, min(in_size, round(outputs * in_size / out_size)))


@functools.lru_cache(maxsize=None)
def _axis(in_size, out_size, align_corners, scale, chunk):
    """One axis as the kernel reads it: ``(method, table, stride, spans,
    chunk)``, numpy; ``chunk`` the input indices a scan's unit takes (0
    where the axis sums by input index, whose units take ``KCOLS`` or
    ``KROWS``)."""
    if not _scans(in_size, out_size, align_corners, scale):
        table = _sums_table(in_size, out_size, align_corners, scale)
        return SUMS, table, table.shape[1], None, 0
    taps, spans = _scan_tables(in_size, out_size, align_corners, chunk,
                               scale)
    return SCAN, taps, 4, spans, chunk


# the shared memory a CTA of the kernel plans for: the tables, two stages
# of g, the partials and the dx tile in 72 KB leave three CTAs an SM of the
# H100's 228 KB; 227 KB is the most a CTA can have
SMEM_PLAN_BYTES, SMEM_MAX_BYTES = 72 * 1024, 227 * 1024
STAGES = 2


def _smem_bytes(tile_planes, band_rows, rows_max, stage_rows, g_pitch,
                h_pitch, in_w, elem, table_words):
    """The kernel's shared memory (``csrc/resize_backward.cu``
    ``Layout``): both axes' tables, two stages of ``stage_rows`` g rows,
    the partials, the dx tile."""
    words = (table_words + STAGES * stage_rows * g_pitch
             + tile_planes * rows_max * h_pitch)
    return 4 * (-(-words // 4) * 4) + tile_planes * band_rows * in_w * elem \
        + 16


@functools.lru_cache(maxsize=None)
def _plan(planes, in_h, in_w, out_h, out_w, elem, align_corners,
          scale_h=None, scale_w=None):
    """The input rows and columns of an H and a W pass unit, then the
    kernel's tiles, as the arguments of ``resize_backward_bilinear`` from
    ``bands`` on: ``bands``, ``(nbands, 2)`` int32: each band's first
    g row and its g rows; ``band_rows``, ``tile_planes``, ``rows_max``,
    ``stage_rows``, ``g_pitch``, ``h_pitch``.  A band is ``band_rows``
    input rows (a multiple of a row SCAN's chunk, or the whole plane) and
    the g rows they tap: the most whose tile fits ``SMEM_PLAN_BYTES``.
    Where a band is a whole plane, a tile takes ``tile_planes`` planes,
    enough for about 2048 partials while they fit.  A stage holds a tile's
    whole band, or where the least band does not fit, ``stage_rows`` of
    its g rows at a time, the most that fit.  A staged g row takes
    ``g_pitch`` 4-byte words and a partial row ``h_pitch`` floats, both odd
    (a bf16 row starts at the word that holds its first element).  Raises
    ``ValueError`` where one staged g row does not fit
    ``SMEM_MAX_BYTES`` beside the tables, the partials and the dx tile."""
    row_scan = _scans(in_h, out_h, align_corners, scale_h)
    row_chunk = (_scan_chunk(in_h, out_h, H_SCAN) if row_scan else KROWS)
    col_chunk = (_scan_chunk(in_w, out_w, W_SCAN)
                 if _scans(in_w, out_w, align_corners, scale_w) else KCOLS)
    indices = axis_table(in_h, out_h, align_corners, scale_h)[0]
    valid = indices >= 0
    first = np.where(valid.any(1), indices[:, 0], out_h)
    last = np.where(valid, indices, -1).max(1)
    g_pitch = (out_w if elem == 4 else (out_w + 2) // 2) | 1
    h_pitch = in_w | 1

    def bands(rows):
        out = []
        for lo in range(0, in_h, rows):
            o_lo, o_hi = first[lo:lo + rows].min(), last[lo:lo + rows].max()
            out.append((o_lo, o_hi + 1 - o_lo) if o_hi >= 0 else (0, 0))
        return np.array(out, np.int32)

    def smem(rows, tile_planes=1, stage_rows=None):
        rows_max = int(bands(rows)[:, 1].max())
        return _smem_bytes(tile_planes, rows, rows_max,
                           stage_rows or tile_planes * rows_max, g_pitch,
                           h_pitch, in_w, elem, table_words)

    # a row scan's bands are multiples of its chunk: halve it to fit
    while True:
        table_words = sum(
            _axis(i, o, align_corners, sc, ch)[1].size
            for i, o, sc, ch in ((in_h, out_h, scale_h, row_chunk),
                                 (in_w, out_w, scale_w, col_chunk)))
        if not row_scan or row_chunk == 1 or \
                smem(min(row_chunk, in_h)) <= SMEM_PLAN_BYTES:
            break
        row_chunk = (row_chunk + 1) // 2
    step = row_chunk if row_scan else 1
    # a taller band never takes less shared memory
    band_rows = min(step, in_h)
    while band_rows < in_h and smem(min(band_rows + step, in_h)) \
            <= SMEM_PLAN_BYTES:
        band_rows = min(band_rows + step, in_h)
    table, tile_planes = bands(band_rows), 1
    rows_max = int(table[:, 1].max())
    stage_rows = rows_max
    if smem(band_rows) > SMEM_PLAN_BYTES:  # stage the band in parts
        most = max([1] + [s for s in range(1, rows_max)
                          if smem(band_rows, 1, s) <= SMEM_PLAN_BYTES])
        parts = -(-rows_max // most)  # as few as fit, of even size
        stage_rows = -(-rows_max // parts)
        if smem(band_rows, 1, stage_rows) > SMEM_MAX_BYTES:
            raise ValueError(
                f"a row of {out_w} elements does not fit the resize "
                f"backward kernel's shared memory beside its tables")
    elif band_rows == in_h:  # every g row of the plane: (0, out_h)
        assert table.tolist() == [[0, out_h]]
        want = min(planes, -(-2048 // (out_h * in_w)))
        tile_planes = next(t for t in range(want, 0, -1)
                           if t == 1 or smem(in_h, t) <= SMEM_PLAN_BYTES)
        stage_rows = tile_planes * rows_max
    return (row_chunk, col_chunk, table, band_rows, tile_planes, rows_max,
            stage_rows, g_pitch, h_pitch)


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
                          align_corners: bool,
                          scales: Optional[Tuple[float, float]] = None
                          ) -> torch.Tensor:
    """The kernel's sums in plain torch, in float32 (float64 for float64),
    every step rounded, padded taps left out: the W pass, ``h + w·g`` for
    each column tap in ascending order, then the H pass, ``dx + w·h`` for
    each row tap in ascending order; then g's dtype."""
    (in_h, in_w), (out_h, out_w) = in_size, g.shape[2:]
    sh, sw = scales or (None, None)
    acc_dtype = torch.promote_types(g.dtype, torch.float32)
    row_idx, row_w = _tables(in_h, out_h, align_corners, g.device, sh)
    col_idx, col_w = _tables(in_w, out_w, align_corners, g.device, sw)
    gf = g.to(acc_dtype)
    h = torch.zeros((*g.shape[:3], in_w), dtype=acc_dtype, device=g.device)
    for b in range(col_idx.shape[1]):
        taps = col_idx[:, b]
        h = torch.where(taps >= 0, h + col_w[:, b].to(acc_dtype)
                        * gf[..., taps.clamp(min=0).long()], h)
    dx = torch.zeros((*g.shape[:2], in_h, in_w), dtype=acc_dtype,
                     device=g.device)
    for a in range(row_idx.shape[1]):
        taps = row_idx[:, a, None]
        dx = torch.where(taps >= 0, dx + row_w[:, a, None].to(acc_dtype)
                         * h[:, :, taps[:, 0].clamp(min=0).long()], dx)
    return dx.to(g.dtype)


def resize_backward(g: torch.Tensor, in_size: Sequence[int],
                    align_corners: bool,
                    scales: Optional[Tuple[float, float]] = None
                    ) -> torch.Tensor:
    """dx ``(N, C, *in_size)`` in g's dtype of a bilinear resize to g's
    spatial size (by the user's ``scales``, if given); see the module
    docstring."""
    in_size = tuple(int(s) for s in in_size)
    _check(g, in_size)
    if g.device.type == "cpu":
        return resize_backward_plain(g, in_size, align_corners, scales)
    g = g.contiguous()
    if g.data_ptr() % 4:  # the kernel copies 4-byte words of g
        g = g.clone()
    n, c, out_h, out_w = g.shape
    in_h, in_w = in_size
    dx = torch.empty((n, c, in_h, in_w), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    if max(g.numel(), dx.numel()) >= 2 ** 31:
        raise ValueError("the kernel indexes elements with 32-bit ints")
    sh, sw = scales or (None, None)
    args = _launch_args(n * c, in_h, in_w, out_h, out_w, g.element_size(),
                        bool(align_corners), sh, sw, g.device)
    lib = build_library()
    # the kernel launches on the current device
    with (contextlib.nullcontext()
          if g.device.index == torch.cuda.current_device()
          else torch.cuda.device(g.device)):
        err = lib.resize_backward_bilinear(
            g.data_ptr(), dx.data_ptr(), _DTYPES[g.dtype], n * c, in_h, in_w,
            out_h, out_w, *args[0],
            torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resize backward kernel launch failed: "
                           f"{lib.resize_backward_error_string(err).decode()}")
    launches["resize_backward_bf16" if g.dtype == torch.bfloat16
             else "resize_backward"] += 1
    return dx


@functools.lru_cache(maxsize=None)
def _launch_args(planes, in_h, in_w, out_h, out_w, elem, align_corners,
                 scale_h, scale_w, device):
    """``resize_backward_bilinear``'s arguments after ``out_w`` and before
    the stream, once for each shape: ``(args, tensors)``, the tables on
    ``device`` (``tensors`` keeps them alive)."""
    row_chunk, col_chunk, bands, *plan = _plan(
        planes, in_h, in_w, out_h, out_w, elem, align_corners, scale_h,
        scale_w)
    axes = [_axis(i, o, align_corners, sc, chunk)
            for i, o, sc, chunk in ((in_h, out_h, scale_h, row_chunk),
                                    (in_w, out_w, scale_w, col_chunk))]
    tensors = [None if t is None else torch.from_numpy(t).to(device)
               for t in [a for _, table, _, spans, _ in axes
                         for a in (table, spans)] + [bands]]
    args = []
    for (method, table, stride, _, chunk), (table_t, spans_t) in zip(
            axes, (tensors[0:2], tensors[2:4])):
        args += [method, table_t.data_ptr(), table.size, stride,
                 spans_t.data_ptr() if spans_t is not None else None, chunk]
    args += [tensors[4].data_ptr(), len(bands), *plan]
    return tuple(args), tensors
