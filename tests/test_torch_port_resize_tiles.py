"""The resize backward kernel's tiles and index math, on the CPU.

``csrc/resize_backward.cu`` runs only on the card; its plan and tables
come from ``ops/resize_backward.py`` (``_plan``, ``_axis``).  This file
replays the kernel's work in numpy, tile by tile, as its source does it:
the staged band of g rows (bf16 rows from the 4-byte word that holds their
first element, at an odd word pitch), the W pass and the H pass by input
index or by a scan, the dx tile and its copy out.  Each replay must give
``resize_backward_plain``'s bits and write every element of dx once.  The
plans are squeezed into a few KB of shared memory, so that small planes
take several bands, a short last band and P planes a tile.
"""

import numpy as np
import pytest
import torch

from image_segmentation_lab_tpu_torch.ops import resize_backward as rb

F32 = np.float32


def weight(bits):
    return np.array([bits], np.int32).view(np.float32)[0]


def input_sum(get, table, i):
    """The kernel's ``sums``: input i's taps, ascending, each step
    rounded."""
    first, count = table[i, 0], table[i, 1]
    acc = F32(0)
    for b in range(count):
        acc = F32(acc + F32(weight(table[i, 4 + b]) * get(first + b)))
    return acc


def scan(get, taps, span, i0, i1, store):
    """The kernel's ``scan`` over the outputs of ``span``."""
    acc0 = acc1 = F32(0)
    ic = i0
    for o in range(span[0], span[1]):
        t, x = taps[o], get(o)
        while ic < t[0]:
            if ic < i1:
                store(ic, acc0)
            acc0, acc1, ic = acc1, F32(0), ic + 1
        if t[0] == ic:
            acc0 = F32(acc0 + F32(weight(t[1]) * x))
            if t[2] != 0:
                acc1 = F32(acc1 + F32(weight(t[2]) * x))
        elif t[2] != 0:
            assert t[0] == ic - 1
            acc0 = F32(acc0 + F32(weight(t[2]) * x))
    while ic < i1:
        store(ic, acc0)
        acc0, acc1, ic = acc1, F32(0), ic + 1


def replay(g, in_size, ac, scales=None):
    """dx as the kernel computes it, and how often each element was
    written."""
    n, c, out_h, out_w = g.shape
    (in_h, in_w), elem, planes = in_size, g.element_size(), n * c
    flat = g.float().reshape(-1).numpy()
    sh, sw = scales or (None, None)
    (row_chunk, col_chunk, bands, band_rows, tile_planes, rows_max,
     stage_rows, g_pitch, h_pitch) = rb._plan(planes, in_h, in_w, out_h,
                                              out_w, elem, ac, sh, sw)
    row_method, rows, _, row_spans, _ = rb._axis(in_h, out_h, ac, sh,
                                                 row_chunk)
    col_method, cols, _, col_spans, _ = rb._axis(in_w, out_w, ac, sw,
                                                 col_chunk)
    per_word = 4 // elem
    dx = np.full(planes * in_h * in_w, np.nan, np.float32)
    written = np.zeros(dx.size, int)
    for t in range(-(-planes // tile_planes) * len(bands)):
        group, b = divmod(t, len(bands))
        plane0 = group * tile_planes
        tp = min(tile_planes, planes - plane0)
        i_lo = b * band_rows
        in_rows = min(band_rows, in_h - i_lo)
        o_lo, o_rows = bands[b][:2]
        g_row0 = plane0 * out_h + o_lo
        assert tp * o_rows <= tile_planes * rows_max
        h = np.full(tile_planes * rows_max * h_pitch, np.nan, np.float32)
        # the band's g rows, stage_rows at a time: stage them, W pass them
        for r0 in range(0, tp * o_rows, stage_rows):
            rows_staged = min(stage_rows, tp * o_rows - r0)
            stage = np.full(stage_rows * g_pitch * per_word, np.nan,
                            np.float32)
            for r in range(rows_staged):
                e0 = (g_row0 + r0 + r) * out_w
                shift = 0 if elem == 4 else e0 & 1
                words = ((out_w + shift) * elem + 3) // 4
                assert words <= g_pitch
                for m in range(words * per_word):
                    e = e0 - shift + m
                    stage[r * g_pitch * per_word + m] = (
                        flat[e] if e < flat.size else np.inf)
            unit_cols = col_chunk if col_method == rb.SCAN else rb.KCOLS
            for u in range(rows_staged * -(-in_w // unit_cols)):
                chunk, r = divmod(u, rows_staged)
                shift = 0 if elem == 4 else ((g_row0 + r0 + r) * out_w) & 1
                base = r * g_pitch * per_word + shift
                j0 = chunk * unit_cols
                j1 = min(j0 + unit_cols, in_w)

                def get(o, base=base):
                    return stage[base + o]

                def store(j, v, r=r0 + r):
                    h[r * h_pitch + j] = v

                if col_method == rb.SCAN:
                    scan(get, cols, col_spans[chunk], j0, j1, store)
                else:
                    for j in range(j0, j1):
                        store(j, input_sum(get, cols, j))
        e0 = (plane0 * in_h + i_lo) * in_w
        vec = 16 // elem
        shift = e0 % vec
        tile_dx = np.full(tile_planes * band_rows * in_w + 16, np.nan,
                          np.float32)
        unit_rows = row_chunk if row_method == rb.SCAN else rb.KROWS
        units = -(-in_rows // unit_rows)
        for v in range(tp * units * in_w):
            rest, j = divmod(v, in_w)
            q, kc = divmod(rest, units) if tile_planes > 1 else (0, rest)
            i0 = i_lo + kc * unit_rows
            i1 = min(i0 + unit_rows, i_lo + in_rows)

            def get(o, q=q, j=j):
                return h[(q * o_rows + o - o_lo) * h_pitch + j]

            def store(i, a, q=q, j=j):
                tile_dx[shift + (q * in_rows + i - i_lo) * in_w + j] = a

            if row_method == rb.SCAN:
                scan(get, rows, row_spans[i0 // unit_rows], i0, i1, store)
            else:
                for i in range(i0, i1):
                    store(i, input_sum(get, rows, i))
        count = tp * in_rows * in_w
        for chunk in range((shift + count + vec - 1) // vec):
            lo = chunk * vec - shift
            for e in range(max(lo, 0), min(lo + vec, count)):
                dx[e0 + e] = tile_dx[shift + e]
                written[e0 + e] += 1
    out = torch.from_numpy(dx.reshape(n, c, in_h, in_w))
    return out.to(g.dtype), written


# (N, C, H, W), output size, align_corners, the user's scale: upsamples
# (by input index) with several bands, a ragged bf16 width (odd rows start
# mid-word), align_corners, P planes a tile with a short last group; a
# downsample on both axes (scans, bands a multiple of the row chunk); the
# odd grid read at step 2; a 1-pixel input; one axis each way; bands staged
# in parts: wide rows at 8x, a 1-pixel input read by a large plane
CASES = {
    "up_2x_bands": ((1, 2, 9, 6), (18, 12), False, None),
    "up_ragged_odd_width": ((1, 2, 7, 9), (17, 23), False, None),
    "up_align_corners": ((1, 2, 6, 5), (11, 13), True, None),
    "tile_planes": ((5, 3, 2, 3), (4, 6), False, None),
    "down_scans": ((1, 2, 20, 14), (9, 6), False, None),
    "down_half_odd": ((1, 3, 9, 9), (4, 4), False, 0.5),
    "one_pixel": ((3, 2, 1, 1), (9, 8), False, None),
    "down_rows_up_cols": ((1, 2, 12, 5), (5, 11), False, None),
    "parts_8x_wide": ((1, 2, 3, 8), (24, 64), False, None),
    "parts_one_pixel": ((2, 1, 1, 1), (40, 40), False, None),
}


@pytest.fixture
def small_plans(monkeypatch):
    """Plans of a few KB, so that these planes take several bands."""
    monkeypatch.setattr(rb, "SMEM_PLAN_BYTES", 2048)
    rb._plan.cache_clear()
    yield
    rb._plan.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_tiles_give_the_plain_versions_bits(name, dtype, small_plans):
    (n, c, h, w), size, ac, scale = CASES[name]
    scales = (scale, scale) if scale else None
    rng = np.random.RandomState(sorted(CASES).index(name))
    g = torch.from_numpy(rng.randn(n, c, *size).astype(np.float32)).to(dtype)
    got, written = replay(g, (h, w), ac, scales)
    assert (written == 1).all()
    assert torch.equal(got, rb.resize_backward_plain(g, (h, w), ac, scales))


# (planes, in_h, in_w, out_h, out_w, bytes an element): one input row's g
# rows at 8x over 2048 columns, and a 1-pixel input read by a 256² plane,
# whose bands do not fit two stages whole
WIDE_BANDS = {
    "up_8x_2048_f32": (4, 64, 256, 512, 2048, 4),
    "up_8x_2048_bf16": (4, 64, 256, 512, 2048, 2),
    "pool_1_to_256_f32": (8192, 1, 1, 256, 256, 4),
}


@pytest.mark.parametrize("name", sorted(WIDE_BANDS))
def test_wide_bands_are_staged_in_parts_within_the_plan(name):
    planes, in_h, in_w, out_h, out_w, elem = WIDE_BANDS[name]
    (row_chunk, col_chunk, bands, band_rows, tile_planes, rows_max,
     stage_rows, g_pitch, h_pitch) = rb._plan(planes, in_h, in_w, out_h,
                                              out_w, elem, False)
    assert band_rows == 1 and tile_planes == 1
    assert 1 <= stage_rows < rows_max
    tables = sum(rb._axis(i, o, False, None, ch)[1].size
                 for i, o, ch in ((in_h, out_h, row_chunk),
                                  (in_w, out_w, col_chunk)))
    assert rb._smem_bytes(1, 1, rows_max, stage_rows, g_pitch, h_pitch, in_w,
                          elem, tables) <= rb.SMEM_PLAN_BYTES


def test_a_row_past_the_shared_memory_is_refused():
    """One staged g row of 60000 float32 elements (two stages: 469 KB)
    cannot fit a CTA's 227 KB."""
    with pytest.raises(ValueError, match="shared memory"):
        rb._plan(1, 1, 1, 1, 60000, 4, False)
