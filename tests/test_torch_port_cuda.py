"""The hand-written kernels against their plain versions, on the card.

Skipped without an NVIDIA GPU.  This file imports no jax, so it runs on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.  Confusion counts are integers: equality
is exact.  Flash attention: atol 2e-6 / rtol 1e-5 in float32 at
unit-normal inputs (float32 reduction order), 2e-2 / 2e-2 in bfloat16, as
in tests/test_flash_attention.py; its gradients atol 2e-5 / rtol 1e-4 in
float32, the JAX tests' gradient tolerance.  Each case draws its inputs
from a seed fixed by its name (``case_seed``), so adding a case leaves the
others' inputs as they were.
"""

import ast
import inspect
import os
import zlib

import numpy as np
import pytest
import torch

from image_segmentation_lab_tpu_torch.ops import (attention, confusion,
                                                  flash_attention, nvcc_build,
                                                  resize_backward)
from image_segmentation_lab_tpu_torch.utils.ops import resize

pytestmark = pytest.mark.cuda
# cuBLAS's fixed workspace, which deterministic algorithms require, in
# force from the process's first matrix product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def case_seed(name):
    """A case's seed, fixed by its name alone."""
    return zlib.crc32(name.encode())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# (N, C, H, W), num_classes, ignore_index, dtype.  The kernel reads 16-byte
# packets where H*W and both base pointers allow it (H*W a multiple of 4 in
# float32, of 8 in bf16), else one pixel at a time; it counts in registers
# up to 8 channels (classes, for the labels entry), in per-warp shared rows
# up to 256 classes and in one set of shared bins above.  A small input
# ("c2_one_cta", "c150", "c4096", "empty", ...) runs one CTA, which writes
# its counts itself; the others run several, whose last sums the partial
# rows ("_grid": on the shared paths)
CASES = {
    "flagship_c2": ((2, 2, 67, 131), 2, 255, torch.float32),  # H*W odd
    "c2_aligned": ((2, 2, 48, 64), 2, 255, torch.float32),
    "c2_aligned_bf16": ((2, 2, 40, 56), 2, 255, torch.bfloat16),
    "c2_one_cta": ((1, 2, 16, 32), 2, 255, torch.float32),
    "c2_bf16_grid": ((2, 2, 64, 96), 2, 255, torch.bfloat16),
    "c1": ((2, 1, 24, 40), 1, 255, torch.float32),
    "c8": ((2, 8, 32, 36), 8, 255, torch.float32),  # the last in registers
    "c9": ((2, 9, 32, 36), 9, 255, torch.float32),  # the first in shared
    "c9_bf16": ((2, 9, 32, 36), 9, 255, torch.bfloat16),
    "c19_bf16": ((2, 19, 33, 65), 19, 255, torch.bfloat16),
    "c150": ((1, 150, 24, 40), 150, 255, torch.float32),
    "c150_grid": ((1, 150, 96, 96), 150, 255, torch.float32),
    "c256": ((1, 256, 8, 8), 256, -1, torch.float32),  # the last per warp
    "c257": ((1, 257, 8, 8), 257, -1, torch.float32),  # one set of bins
    "c4096": ((1, 4096, 4, 8), 4096, 255, torch.float32),
    "c4096_grid": ((1, 4096, 16, 192), 4096, 255, torch.float32),
    "ignore_neg1": ((3, 5, 97, 131), 5, -1, torch.float32),
    "channels_gt_classes": ((1, 7, 40, 40), 4, 255, torch.float32),
    "ties": ((2, 4, 50, 50), 4, 255, torch.float32),
    "empty": ((0, 2, 8, 8), 2, 255, torch.float32),
    "all_ignored": ((2, 2, 32, 32), 2, 255, torch.float32),
    # every input a contiguous view whose data starts 4 bytes past a
    # 16-byte boundary, though H*W would allow packets
    "view_off_16_bytes": ((3, 2, 16, 20), 2, 255, torch.float32),
}


def off_16_bytes(t):
    """A contiguous copy of ``t`` whose data starts one element (4 bytes)
    past its buffer's start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def make_inputs(name, device):
    (n, c, h, w), num_classes, ignore, dtype = CASES[name]
    g = torch.Generator(device="cpu").manual_seed(case_seed(name))
    if name == "ties":
        logits = torch.randint(0, 2, (n, c, h, w), generator=g).float()
    else:
        logits = torch.randn((n, c, h, w), generator=g)
    gt = torch.randint(-1, num_classes + 2, (n, h, w), generator=g)
    gt[torch.rand((n, h, w), generator=g) < 0.2] = ignore
    if name == "all_ignored":
        gt[:] = ignore
    logits = logits.to(device=device, dtype=dtype)
    gt = gt.to(device=device, dtype=torch.int32)
    if name == "view_off_16_bytes":
        logits, gt = off_16_bytes(logits), off_16_bytes(gt)
    return logits, gt, num_classes, ignore


def assert_counts_equal(out, ref):
    for a, b, what in zip(out, ref, ("inter", "pred", "label")):
        assert a.dtype == torch.float32 and a.is_cuda
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(),
                                      err_msg=what)


def label_inputs(name, device):
    """Class maps for the labels entry, with predictions out of range;
    laid out as the case's logits are."""
    logits, gt, num_classes, ignore = make_inputs(name, device)
    g = torch.Generator(device="cpu").manual_seed(case_seed(name) + 1)
    pred = torch.randint(-2, num_classes + 2, gt.shape, generator=g)
    pred = pred.to(device=device, dtype=torch.int32)
    if name == "view_off_16_bytes":
        pred = off_16_bytes(pred)
    return pred, gt, num_classes, ignore


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name):
    """Both entries equal the plain version, and a second call gives the
    same counts and leaves the ticket at 0."""
    args = make_inputs(name, cuda)
    ref = confusion.histograms_plain(*args)
    label_args = label_inputs(name, cuda)
    label_ref = confusion.histograms_from_labels_plain(*label_args)
    for _ in range(2):
        assert_counts_equal(confusion.confusion_histograms(*args), ref)
        assert_counts_equal(
            confusion.confusion_histograms_from_labels(*label_args),
            label_ref)
    device = args[1].device
    stream = torch.cuda.current_stream(device).cuda_stream
    assert int(confusion._tickets[(device.index, stream)][0]) == 0


@pytest.mark.parametrize("name", ["c2_aligned", "c9", "c150_grid"])
def test_calls_on_two_streams_in_a_row(cuda, name):
    """Each stream has its own ticket: calls alternating between two
    streams each give the plain version's counts."""
    args = make_inputs(name, cuda)
    ref = confusion.histograms_plain(*args)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    outs = []
    for stream in streams + streams:
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            outs.append(confusion.confusion_histograms(*args))
    torch.cuda.synchronize()
    for out in outs:
        assert_counts_equal(out, ref)


@pytest.mark.parametrize("name", ["c2_aligned", "c2_aligned_bf16", "c8",
                                  "c9", "view_off_16_bytes"])
def test_nan_is_the_maximum_on_every_path(cuda, name):
    """NaN logits on the packet and scalar paths, in registers and in
    shared memory: the first NaN wins, as in torch.argmax."""
    logits, gt, num_classes, ignore = make_inputs(name, cuda)
    logits[:, -1, ::3] = float("nan")
    logits[:, 0, ::7] = float("nan")
    assert_counts_equal(
        confusion.confusion_histograms(logits, gt, num_classes, ignore),
        confusion.histograms_plain(logits, gt, num_classes, ignore))


def test_nan_is_the_maximum_as_in_torch_argmax(cuda):
    logits, gt, num_classes, ignore = make_inputs("ignore_neg1", cuda)
    logits[:, 2, ::3] = float("nan")
    logits[:, 0, ::7] = float("nan")
    assert_counts_equal(
        confusion.confusion_histograms(logits, gt, num_classes, ignore),
        confusion.histograms_plain(logits, gt, num_classes, ignore))


def test_each_entry_counts_its_launches(cuda, monkeypatch):
    """Launches per entry, and per kernel instance (H*W odd: one pixel at a
    time, two register slots)."""
    monkeypatch.setattr(confusion, "launches", {"logits": 0, "labels": 0})
    monkeypatch.setattr(confusion, "instances", {})
    logits, gt, num_classes, ignore = make_inputs("flagship_c2", cuda)
    confusion.confusion_histograms(logits, gt, num_classes, ignore)
    confusion.confusion_histograms(logits, gt, num_classes, ignore)
    confusion.confusion_histograms_from_labels(gt, gt, num_classes, ignore)
    assert confusion.launches == {"logits": 2, "labels": 1}
    assert confusion.instances == {"float32/2 slots/one pixel": 2,
                                   "labels/2 slots/one pixel": 1}


def test_cuda_tensor_without_library_raises(cuda, monkeypatch, tmp_path):
    """No compiler, no library: a CUDA tensor raises and is never counted
    on the CPU."""
    monkeypatch.setattr(confusion, "_lib", None)
    monkeypatch.setattr(nvcc_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    logits, gt, num_classes, ignore = make_inputs("flagship_c2", cuda)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        confusion.confusion_histograms(logits, gt, num_classes, ignore)


# (N, h, Lq, Lk, d), dtype: SETR ViT-S/16 at 640² (batch 8), SegFormer-B0
# stage 1 at 640² (Lq != Lk), ragged and small cases; Lk = 65 leaves 63 of
# the last tile's 64 keys masked, Lk = 1 makes o equal v; float32 runs the
# tensor-core kernel on q, k, v split into three bf16 parts
FLASH_CASES = {
    "setr_f32": ((8, 6, 1601, 1601, 64), torch.float32),
    "setr_bf16": ((8, 6, 1601, 1601, 64), torch.bfloat16),
    "mit_f32": ((8, 1, 25600, 400, 32), torch.float32),
    "ragged_130": ((3, 1, 130, 130, 64), torch.float32),
    "d48": ((1, 2, 300, 300, 48), torch.float32),
    "masked_tail": ((2, 3, 63, 65, 32), torch.float32),
    "one_key_bf16": ((2, 2, 70, 1, 64), torch.bfloat16),
    "one_key_f32": ((2, 2, 70, 1, 64), torch.float32),
    "fit_128_contiguous_f32": ((2, 3, 128, 128, 64), torch.float32),
}
FLASH_TOL = {torch.float32: dict(atol=2e-6, rtol=1e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def flash_inputs(name, device):
    (n, h, lq, lk, d), dtype = FLASH_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(case_seed(name))
    return [torch.randn(shape, generator=g).to(device=device, dtype=dtype)
            for shape in ((n, lq, h, d), (n, lk, h, d), (n, lk, h, d))]


def assert_flash_matches_plain(q, k, v):
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        o, lse = flash_attention.flash_attention_forward(q, k, v, scale)
        ref_o, ref_lse = flash_attention.attention_plain(q, k, v, scale)
    assert o.dtype == q.dtype and o.is_cuda and o.is_contiguous()
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(o.float(), ref_o.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **FLASH_TOL[torch.float32])


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, name):
    assert_flash_matches_plain(*flash_inputs(name, cuda))


@pytest.mark.parametrize("name", ["setr_f32", "masked_tail", "mit_f32"])
def test_float32_forward_repeats_bit_for_bit(cuda, name):
    """Each output row has one owner and no atomics: two calls on the same
    inputs give the same bits."""
    q, k, v = flash_inputs(name, cuda)
    with torch.no_grad():
        first = flash_attention.flash_attention_forward(q, k, v, 0.125)
        again = flash_attention.flash_attention_forward(q, k, v, 0.125)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_float32_forward_takes_rows_off_16_bytes(cuda):
    """The float32 kernel reads the split planes, which are contiguous:
    rows that start 4 bytes in need no alignment, unlike bf16's."""
    q, k, v = flash_inputs("fit_128_contiguous_f32", cuda)
    padded = torch.zeros(*v.shape[:-1], v.shape[-1] + 2, device=cuda)
    padded[..., 1:-1] = v
    off = padded[..., 1:-1]  # rows start 4 bytes in
    assert off.data_ptr() % 16 and off.stride(1) % 4
    assert_flash_matches_plain(q, k, off)


def test_flash_kernel_reads_qkv_slices_in_place(cuda):
    """The ViT passes q, k and v as strided views of the qkv projection."""
    n, lq, h, d = 2, 197, 6, 64
    g = torch.Generator(device="cpu").manual_seed(5)
    qkv = torch.randn(n, lq, 3 * h * d, generator=g).to(cuda)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    assert_flash_matches_plain(q, k, v)


def test_multihead_attention_launches_the_kernel_unless_forced_plain(
        cuda, monkeypatch):
    """At SETR's shape and qkv layout: the default runs the kernel (and the
    split) once, ``force="plain"`` runs no kernel, and the two agree."""
    monkeypatch.setattr(flash_attention, "launches",
                        {"forward": 0, "split_bf16x3": 0})
    n, lq, h, d = 8, 1601, 6, 64
    g = torch.Generator(device="cpu").manual_seed(6)
    qkv = torch.randn(n, lq, 3 * h * d, generator=g).to(cuda)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    with torch.no_grad():
        out = attention.multihead_attention(q, k, v, d ** -0.5)
        plain = attention.multihead_attention(q, k, v, d ** -0.5,
                                              force="plain")
    assert flash_attention.launches == {"forward": 1, "split_bf16x3": 1}
    torch.testing.assert_close(out, plain, **FLASH_TOL[torch.float32])


def test_flash_counts_its_launches(cuda, monkeypatch):
    """A float32 forward call splits q, k and v once and launches the
    kernel once; the plain version counts nothing."""
    monkeypatch.setattr(flash_attention, "launches",
                        {"forward": 0, "forward_bf16": 0, "split_bf16x3": 0})
    q, k, v = flash_inputs("ragged_130", cuda)
    with torch.no_grad():
        for _ in range(3):
            flash_attention.flash_attention_forward(q, k, v, 0.125)
        flash_attention.attention_plain(q, k, v, 0.125)
    assert flash_attention.launches == {"forward": 3, "forward_bf16": 0,
                                        "split_bf16x3": 3}


# (N, h, Lq, Lk, d) of the bf16 tensor-core kernel (128 query rows and 64
# keys a tile): exact fits, SETR's ragged Lq = 1601, Lk = 65 (63 masked
# keys in the last tile) and Lk = 1, d = 32/48/64, Lq != Lk; q, k, v are
# strided views of a fused projection unless named contiguous
BF16_CASES = {
    "fit_64": (2, 2, 64, 64, 64),
    "fit_128": (2, 3, 128, 128, 64),
    "fit_128_contiguous": (2, 3, 128, 128, 64),
    "setr": (8, 6, 1601, 1601, 64),
    "masked_tail_65": (2, 3, 63, 65, 32),
    "one_key": (2, 2, 70, 1, 64),
    "d32": (2, 4, 200, 200, 32),
    "d48": (1, 2, 300, 300, 48),
    "mit": (8, 1, 25600, 400, 32),
    "lq_ne_lk_d48": (2, 2, 100, 37, 48),
}


def bf16_inputs(name, device):
    n, h, lq, lk, d = BF16_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(case_seed(name))
    if name.endswith("contiguous"):
        return [torch.randn(n, length, h, d, generator=g).to(
            device=device, dtype=torch.bfloat16) for length in (lq, lk, lk)]

    def proj(length, parts):
        x = torch.randn(n, length, parts * h * d, generator=g)
        x = x.to(device=device, dtype=torch.bfloat16)
        return [t.unflatten(-1, (h, d)) for t in x.split(h * d, dim=-1)]

    return proj(lq, 3) if lq == lk else proj(lq, 1) + proj(lk, 2)


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_tensor_core_kernel_matches_plain(cuda, name, monkeypatch):
    """o at the bf16 tolerance, lse at float32's; one launch of the
    tensor-core kernel and none of the float32 one."""
    monkeypatch.setattr(flash_attention, "launches",
                        {"forward": 0, "forward_bf16": 0})
    q, k, v = bf16_inputs(name, cuda)
    assert name.endswith("contiguous") or not k.is_contiguous()
    assert_flash_matches_plain(q, k, v)
    assert flash_attention.launches == {"forward": 0, "forward_bf16": 1}


def test_resize_keeps_bf16_under_cuda_autocast(cuda):
    """CUDA autocast runs the upsamples in float32; the port's resize keeps
    its input's dtype, as the JAX resize does under the bf16 policy."""
    x = torch.randn(2, 3, 8, 8, device=cuda).to(torch.bfloat16)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = resize(x, (16, 16), mode="bilinear", align_corners=False)
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.interpolate(x.float(), size=(16, 16),
                                          mode="bilinear")
    torch.testing.assert_close(out.float(), ref, atol=2.0 ** -8,
                               rtol=2.0 ** -8)


# SETR-PUP's bilinear upsamples (align_corners False) in its train step at
# 8 x 640²: the decode head's three 2x steps on 256 channels and its last
# on the class map, the aux head's 4x step and its loss's resize to 640²
SETR_UPSAMPLES = [((8, 256, 40, 40), (80, 80)),
                  ((8, 256, 80, 80), (160, 160)),
                  ((8, 256, 160, 160), (320, 320)),
                  ((8, 2, 320, 320), (640, 640)),
                  ((8, 2, 40, 40), (160, 160)),
                  ((8, 2, 160, 160), (640, 640))]


def test_bf16_resize_backward_is_the_float32_backward_rounded_once(cuda):
    """The JAX resize interpolates a bf16 input in float32 and casts once
    (``image_segmentation_lab_tpu/utils/ops.py:98-99``), so its gradient is
    the float32 gradient rounded once to bf16, the same bits on every
    call.  The port's bf16 resize backward, at SETR's upsample shapes:
    within one bf16 rounding step (2**-7 of the value) of the float32
    backward rounded once, and the same bits on a second call."""
    g = torch.Generator(device="cpu").manual_seed(case_seed("setr_upsample"))
    faults = []
    for (n, c, h, w), size in SETR_UPSAMPLES:
        x = torch.randn(n, c, h, w, generator=g).to(cuda, torch.bfloat16)
        gy = torch.randn(n, c, *size, generator=g).to(cuda, torch.bfloat16)

        def grad(t):
            leaf = t.detach().requires_grad_(True)
            with torch.enable_grad():
                out = resize(leaf, size, mode="bilinear", align_corners=False)
                return torch.autograd.grad(out, leaf, gy.to(t.dtype))[0]

        first, again = grad(x), grad(x)
        ref = grad(x.float()).to(torch.bfloat16).float()
        diff = (first.float() - ref).abs()
        within = bool((diff <= 2.0 ** -7 * ref.abs()).all())
        if not within or not torch.equal(first, again):
            top = float(ref.abs().max())
            faults.append(
                f"{(n, c, h, w)}->{size}: {float((diff > 0).float().mean()):.3f}"
                f" of the elements off, by up to {float(diff.max()) / top:.4f}"
                f" of max |g| {top:.3g}; a second call off by up to "
                f"{float((first.float() - again.float()).abs().max()):.3g}")
    assert not faults, "; ".join(faults)


def test_bf16_resize_forward_is_the_float32_forward_rounded_once(cuda):
    """``F.interpolate``'s bf16 kernel computes in float32 and rounds once,
    as the JAX resize does: the same bits as the float32 forward cast to
    bf16, with grad (through ``BilinearResize``) and without."""
    g = torch.Generator(device="cpu").manual_seed(case_seed("setr_forward"))
    for (n, c, h, w), size in SETR_UPSAMPLES:
        x = torch.randn(n, c, h, w, generator=g).to(cuda, torch.bfloat16)
        ref = resize(x.float(), size).to(torch.bfloat16)
        assert torch.equal(resize(x, size), ref)
        with torch.enable_grad():
            out = resize(x.clone().requires_grad_(True), size)
        assert type(out.grad_fn).__name__ == "BilinearResizeBackward"
        assert torch.equal(out.detach(), ref)


# the resize backward kernel: SETR's six upsamples, a ragged upsample, a
# downsample, align_corners, and a 1-pixel input (the ASPP image pool);
# (N, C, H, W), output size, align_corners[, the user's scale factor]
RESIZE_CASES = {
    **{f"setr_{i}": (shape, size, False)
       for i, (shape, size) in enumerate(SETR_UPSAMPLES)},
    "ragged_up": ((2, 3, 13, 10), (29, 17), False),
    "down": ((2, 3, 13, 10), (5, 7), False),
    "up_align_corners": ((2, 3, 13, 10), (25, 19), True),
    "down_align_corners": ((1, 2, 17, 9), (8, 4), True),
    "one_pixel": ((2, 5, 1, 1), (65, 65), False),
    # DeepLabV3's train step at 16 x 512²: the decode and aux heads' 8x
    # logits and the ASPP image pool (wide tables); PSPNet's PPM from 6²
    "deeplab_decode": ((16, 2, 64, 64), (512, 512), False),
    "deeplab_aux": ((16, 2, 64, 64), (512, 512), False),
    "deeplab_pool": ((16, 512, 1, 1), (64, 64), False),
    "pool_6_to_80": ((16, 512, 6, 6), (80, 80), False),
    # UPerNet's 8x fpn output (16 taps an axis); MultiLevelNeck's 0.5
    # level, also on the odd grid of 400² (25 -> 12, read at step 2)
    "fpn_8x": ((16, 512, 20, 20), (160, 160), False),
    "mln_half": ((16, 768, 40, 40), (20, 20), False, 0.5),
    "mln_half_odd": ((16, 768, 25, 25), (12, 12), False, 0.5),
    "align_corners_2x": ((16, 256, 40, 40), (80, 80), True),
    # an odd plane whose bands do not divide its rows (the last band is
    # shorter, bf16 rows start mid-word); more tiles than resident CTAs
    "tile_edge": ((4, 8, 61, 47), (183, 141), False),
    "many_planes": ((64, 256, 10, 10), (20, 20), False),
    # bands too wide for two stages, staged in parts: 8x to 2048 columns,
    # and a 1-pixel input read by a 256² plane
    "parts_8x_wide": ((1, 4, 64, 256), (512, 2048), False),
    "parts_pool_256": ((2, 64, 1, 1), (256, 256), False),
    # SegNeXt's, PIDNet-S's and DDRNet's train steps at 16 x 640²:
    # LightHamHead's levels to 80², the PagFM gates and diff taps from
    # 40² and 20², the pyramid pools (5², 3², 2², 1²) to the 1/64 map, the
    # context to 80² and the one-channel boundary logits to 640²
    "ham_level_40": ((16, 160, 40, 40), (80, 80), False),
    "ham_level_20": ((16, 256, 20, 20), (80, 80), False),
    **{f"pid_tap_{c}_{s}": ((16, c, s, s), (80, 80), False)
       for c in (32, 64) for s in (40, 20)},
    **{f"pyramid_{c}_{s}": ((16, c, s, s), (10, 10), False)
       for c in (96, 128) for s in (5, 3, 2, 1)},
    "context_8x": ((16, 128, 10, 10), (80, 80), False),
    "boundary_logits": ((16, 1, 80, 80), (640, 640), False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(RESIZE_CASES))
def test_resize_backward_kernel_matches_plain(cuda, name, dtype,
                                              monkeypatch):
    """One launch gives the plain version's bits (the same float32 steps in
    the same order), the same bits again on a second call, and in bf16 the
    kernel's own float32 result rounded once."""
    counts = dict.fromkeys(resize_backward.launches, 0)
    monkeypatch.setattr(resize_backward, "launches", dict(counts))
    (n, c, h, w), size, ac, *scale = RESIZE_CASES[name]
    scales = (scale[0], scale[0]) if scale else None
    g = torch.Generator(device="cpu").manual_seed(case_seed(name))
    gy = torch.randn(n, c, *size, generator=g).to(cuda, dtype)
    got = resize_backward.resize_backward(gy, (h, w), ac, scales)
    key = ("resize_backward_bf16" if dtype == torch.bfloat16
           else "resize_backward")
    assert resize_backward.launches == dict(counts, **{key: 1})
    assert got.dtype == dtype and got.shape == (n, c, h, w)
    assert torch.equal(got, resize_backward.resize_backward_plain(
        gy, (h, w), ac, scales))
    assert torch.equal(got, resize_backward.resize_backward(gy, (h, w), ac,
                                                            scales))
    if dtype == torch.bfloat16:
        f32 = resize_backward.resize_backward(gy.float(), (h, w), ac, scales)
        assert torch.equal(got, f32.to(torch.bfloat16))


def test_resize_backward_refuses_other_dtypes(cuda):
    gy = torch.zeros(1, 2, 8, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        resize_backward.resize_backward(gy, (4, 4), False)


def test_bf16_kernel_refuses_rows_off_16_bytes(cuda):
    x = torch.zeros(1, 8, 1, 72, device=cuda, dtype=torch.bfloat16)
    q = x[..., 4:68]  # rows start 8 bytes in
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_attention_forward(q, q, q, 0.125)


# (N, h, Lq, Lk, d), dtype: the backward kernels at SETR's training shape,
# d = 32/48/64, Lq != Lk, ragged, Lk = 65 (63 masked keys in the last tile)
# and Lk = 1, in both dtypes (float32 through the split into three bf16
# parts); q, k, v are views of one fused projection (or q and a fused kv)
# unless named contiguous
BWD_CASES = {
    "setr_f32": ((8, 6, 1601, 1601, 64), torch.float32),
    "setr_bf16": ((8, 6, 1601, 1601, 64), torch.bfloat16),
    "mit_f32": ((8, 1, 25600, 400, 32), torch.float32),
    "ragged_130": ((3, 1, 130, 130, 64), torch.float32),
    "ragged_130_bf16": ((3, 1, 130, 130, 64), torch.bfloat16),
    "d48_bf16": ((1, 2, 300, 300, 48), torch.bfloat16),
    "d32_bf16": ((2, 4, 200, 200, 32), torch.bfloat16),
    "masked_tail": ((2, 3, 63, 65, 32), torch.float32),
    "masked_tail_bf16": ((2, 3, 63, 65, 32), torch.bfloat16),
    "lq_ne_lk_d48": ((2, 2, 100, 37, 48), torch.float32),
    "lq_ne_lk_d48_bf16": ((2, 2, 100, 37, 48), torch.bfloat16),
    "one_key_bf16": ((2, 2, 70, 1, 64), torch.bfloat16),
    "fit_128_contiguous_bf16": ((2, 3, 128, 128, 64), torch.bfloat16),
    "one_key_f32": ((2, 2, 70, 1, 64), torch.float32),
    "d32_f32": ((2, 4, 200, 200, 32), torch.float32),
    "fit_128_contiguous_f32": ((2, 3, 128, 128, 64), torch.float32),
    # MiT's spatially reduced attention at 640² (batch cut to 2): MiT-B2
    # (d = 64) stages 1 and 3, MiT-B0 (d = 32) stage 2; q alone, k and v
    # views of the fused kv projection
    "mit_b2_stage1_f32": ((2, 1, 25600, 400, 64), torch.float32),
    "mit_b2_stage1_bf16": ((2, 1, 25600, 400, 64), torch.bfloat16),
    "mit_b2_stage3_f32": ((2, 5, 1600, 400, 64), torch.float32),
    "mit_b2_stage3_bf16": ((2, 5, 1600, 400, 64), torch.bfloat16),
    "mit_b0_stage2_f32": ((2, 2, 6400, 400, 32), torch.float32),
    "mit_b0_stage2_bf16": ((2, 2, 6400, 400, 32), torch.bfloat16),
}
MIT_CASES = sorted(name for name in BWD_CASES if name.startswith("mit_b"))
# the launch counter of each backward kernel, by dtype
BWD_KEYS = {torch.float32: ("backward_dq", "backward_dkv"),
            torch.bfloat16: ("backward_dq_bf16", "backward_dkv_bf16")}
# the float32 forward splits q, k and v, and the float32 dQ and dK/dV
# wrappers called without the split planes each split q, k, v and dO
# themselves
BWD_SPLITS = {torch.float32: 3, torch.bfloat16: 0}


def bwd_tol(ref):
    """Float32: tests/test_flash_attention.py's gradient tolerance.
    Bfloat16: one rounding step of the value (2**-7 of it) plus 1e-3 of the
    tensor's largest value, so that a lost key tile or a wrong cast
    fails; the absolute part never below float32's 2e-5, which a gradient
    that is 0 in exact arithmetic needs (with one key, dP = delta and dQ,
    dK are float32 cancellation noise in the kernel and the reference
    alike)."""
    if ref.dtype == torch.float32:
        return dict(atol=2e-5, rtol=1e-4)
    return dict(atol=max(1e-3 * ref.float().abs().max().item(), 2e-5),
                rtol=2.0 ** -7)


def projection_views(name, device):
    (n, h, lq, lk, d), dtype = BWD_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(case_seed(name))

    def proj(length, parts):
        x = torch.randn(n, length, parts * h * d, generator=g)
        x = x.to(device=device, dtype=dtype)
        return [t.unflatten(-1, (h, d)) for t in x.split(h * d, dim=-1)]

    if "_contiguous" in name:
        qkv = [torch.randn(n, length, h, d, generator=g).to(
            device=device, dtype=dtype) for length in (lq, lk, lk)]
    else:
        qkv = proj(lq, 3) if lq == lk else proj(lq, 1) + proj(lk, 2)
    do = torch.randn(n, lq, h, d, generator=g).to(device=device, dtype=dtype)
    return (*qkv, do)


def backward_kernels(q, k, v, do):
    """The inputs of the dQ and dK/dV kernels after the forward kernel, and
    their outputs (dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        o, lse = flash_attention.flash_attention_forward(q, k, v, scale)
        delta = flash_attention.backward_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        return args, (flash_attention.flash_attention_backward_dq(*args),
                      *flash_attention.flash_attention_backward_dkv(*args))


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_flash_backward_kernels_match_plain(cuda, name, monkeypatch):
    """Each output at its dtype's tolerance, from one launch of each
    backward kernel of the inputs' dtype and none of the other dtype's."""
    monkeypatch.setattr(flash_attention, "launches",
                        dict.fromkeys(flash_attention.launches, 0))
    q, k, v, do = projection_views(name, cuda)
    assert "_contiguous" in name or not k.is_contiguous()
    args, outs = backward_kernels(q, k, v, do)
    with torch.no_grad():
        refs = flash_attention.attention_backward_plain(*args)
    for out, ref, t in zip(outs, refs, (q, k, v)):
        assert out.dtype == t.dtype and out.is_cuda and out.is_contiguous()
        assert out.shape == t.shape
        torch.testing.assert_close(out.float(), ref.float(),
                                   **bwd_tol(ref))
    backward = {key: n for key, n in flash_attention.launches.items()
                if key.startswith("backward")}
    assert backward == {key: int(key in BWD_KEYS[q.dtype])
                        for key in backward}
    assert flash_attention.launches["split_bf16x3"] == BWD_SPLITS[q.dtype]


@pytest.mark.parametrize("name", MIT_CASES)
def test_flash_forward_on_mit_kv_views_matches_plain(cuda, name):
    """The forward kernel at MiT's Lq >> Lk, on k and v as strided views of
    one fused kv projection."""
    q, k, v, _ = projection_views(name, cuda)
    assert not k.is_contiguous() and k.stride(1) == 2 * k.shape[2] * \
        k.shape[3]
    assert_flash_matches_plain(q, k, v)


@pytest.mark.parametrize("name", ["setr_bf16", "masked_tail_bf16",
                                  "lq_ne_lk_d48_bf16", "setr_f32",
                                  "masked_tail"])
def test_bf16_backward_kernels_repeat_bit_for_bit(cuda, name):
    """Each output row has one owner and no atomics: two calls on the same
    inputs give the same bits."""
    q, k, v, do = projection_views(name, cuda)
    args, first = backward_kernels(q, k, v, do)
    with torch.no_grad():
        again = (flash_attention.flash_attention_backward_dq(*args),
                 *flash_attention.flash_attention_backward_dkv(*args))
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_bf16_backward_refuses_rows_off_16_bytes(cuda):
    q, k, v, do = projection_views("fit_128_contiguous_bf16", cuda)
    args, _ = backward_kernels(q, k, v, do)
    padded = torch.zeros(*do.shape[:-1], do.shape[-1] + 8, device=cuda,
                         dtype=do.dtype)
    padded[..., 4:-4] = do
    off = padded[..., 4:-4]  # rows start 8 bytes in
    bad = (q, k, v, off, *args[4:])
    with torch.no_grad(), pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_attention_backward_dq(*bad)
    with torch.no_grad(), pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_attention_backward_dkv(*bad)


@pytest.mark.parametrize("name", ["setr_f32", "masked_tail",
                                  "lq_ne_lk_d48", "fit_128_contiguous_f32"])
def test_split_kernel_matches_plain_exactly(cuda, name, monkeypatch):
    """The split of float32 q, k, v and dO into three bf16 planes each, in
    one launch: the same bits as ``split_bf16x3_plain``, and the parts sum
    to the value."""
    monkeypatch.setattr(flash_attention, "launches",
                        dict.fromkeys(flash_attention.launches, 0))
    tensors = projection_views(name, cuda)
    planes = flash_attention.split_bf16x3(*tensors)
    assert flash_attention.launches["split_bf16x3"] == 1
    for t, got in zip(tensors, planes):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got, flash_attention.split_bf16x3_plain(t))
        assert torch.equal(got.double().sum(0), t.double())


def test_float32_backward_takes_rows_off_16_bytes(cuda):
    """The float32 kernels read the split planes, which are contiguous:
    rows that start 4 bytes in need no alignment, unlike bf16's."""
    q, k, v, do = projection_views("fit_128_contiguous_f32", cuda)
    padded = torch.zeros(*do.shape[:-1], do.shape[-1] + 2, device=cuda)
    padded[..., 1:-1] = do
    off = padded[..., 1:-1]  # rows start 4 bytes in
    assert off.data_ptr() % 16 and off.stride(1) % 4
    args, outs = backward_kernels(q, k, v, off)
    with torch.no_grad():
        refs = flash_attention.attention_backward_plain(*args)
    for out, ref in zip(outs, refs):
        torch.testing.assert_close(out, ref, **bwd_tol(ref))


def test_grad_through_multihead_attention_launches_each_kernel_once(
        cuda, monkeypatch):
    """At SETR's qkv layout: one forward and one backward through the
    Function launch K3, K4 and K5 once each and the split twice (q, k, v
    for the forward; q, k, v, dO for the backward), and agree with
    autograd through the plain version."""
    monkeypatch.setattr(flash_attention, "launches",
                        dict.fromkeys(flash_attention.launches, 0))
    g = torch.Generator(device="cpu").manual_seed(7)
    n, lq, h, d = 2, 1601, 6, 64
    qkv = torch.randn(n, lq, 3 * h * d, generator=g).to(cuda)
    do = torch.randn(n, lq, h, d, generator=g).to(cuda)
    grads = {}
    for force in (None, "plain"):
        leaf = qkv.clone().requires_grad_(True)
        with torch.enable_grad():
            q, k, v = (t.unflatten(-1, (h, d))
                       for t in leaf.split(h * d, dim=-1))
            out = attention.multihead_attention(q, k, v, d ** -0.5,
                                                force=force)
            grads[force], = torch.autograd.grad(out, leaf, do)
    assert flash_attention.launches == {
        "forward": 1, "forward_bf16": 0, "backward_dq": 1, "backward_dkv": 1,
        "backward_dq_bf16": 0, "backward_dkv_bf16": 0, "split_bf16x3": 2}
    torch.testing.assert_close(grads[None], grads["plain"],
                               **bwd_tol(grads["plain"]))


def test_flash_backward_counts_its_launches(cuda, monkeypatch):
    """float32 under its own keys (one split a forward and a backward
    call), bf16 under ``*_bf16``; the plain versions count nothing."""
    monkeypatch.setattr(flash_attention, "launches",
                        dict.fromkeys(flash_attention.launches, 0))
    for name in ("ragged_130", "ragged_130_bf16"):
        q, k, v, do = projection_views(name, cuda)
        with torch.no_grad():
            o, lse = flash_attention.flash_attention_forward(q, k, v, 0.125)
            for _ in range(2):
                flash_attention.flash_attention_backward(q, k, v, o, lse, do,
                                                         0.125)
            delta = flash_attention.backward_delta(o, do)
            flash_attention.attention_backward_plain(q, k, v, do, lse, delta,
                                                     0.125)
            flash_attention.split_bf16x3_plain(q.float())
    assert flash_attention.launches == {
        "forward": 1, "forward_bf16": 1, "backward_dq": 2, "backward_dkv": 2,
        "backward_dq_bf16": 2, "backward_dkv_bf16": 2, "split_bf16x3": 3}


def test_flash_unsupported_head_dim_raises(cuda):
    q = torch.zeros(1, 8, 1, 40, device=cuda)
    with pytest.raises(ValueError, match=r"\(32, 48, 64\)"):
        flash_attention.flash_attention_forward(q, q, q, 0.5)


def test_flash_without_library_raises(cuda, monkeypatch, tmp_path):
    """No compiler, no library: a CUDA tensor raises, forward and backward;
    the module has no try that could fall back to the plain version."""
    tree = ast.parse(inspect.getsource(flash_attention))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    q, k, v, do = projection_views("ragged_130", cuda)
    with torch.no_grad():
        o, lse = flash_attention.flash_attention_forward(q, k, v, 0.125)
    monkeypatch.setattr(flash_attention, "_sm90_lib", None)
    monkeypatch.setattr(flash_attention, "_sm90_bwd_lib", None)
    monkeypatch.setattr(nvcc_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention.flash_attention_forward(q, k, v, 0.125)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention.flash_attention_forward(
            *(t.to(torch.bfloat16) for t in (q, k, v)), 0.125)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention.flash_attention_backward(q, k, v, o, lse, do, 0.125)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention.flash_attention_backward(
            *(t.to(torch.bfloat16) for t in (q, k, v, o)), lse,
            do.to(torch.bfloat16), 0.125)


# ------------------------------------------------- the augmentation pipeline
# The pinned Kvasir pipeline (every draw a constant) and leaf transforms at
# pinned parameters or with draws made on the CPU: the card against the
# port on the CPU, at tests/test_torch_port_data.py's tolerances (1e-2 on
# the 0-255 scale, 2e-4 after Normalize; Rotate's nearest mask taps may
# differ only at half-integer source coordinates, at most 0.1 %).

PINNED_YAML = "tests/data/kvasir_train_transform_pinned.yaml"


def raw_batch(name, n, h, w):
    g = torch.Generator().manual_seed(case_seed(name))
    imgs = torch.randint(0, 256, (n, h, w, 3), generator=g,
                         dtype=torch.uint8)
    masks = torch.randint(0, 2, (n, h, w), generator=g).float()
    return imgs, masks


def rotate_flips_ok(out, ref, angle_deg):
    """Mask taps off only within 1e-3 of a half-integer source coordinate,
    at most 0.1 % of the pixels."""
    import math
    off = (out != ref).numpy()
    h, w = off.shape[1:]
    a = math.radians(angle_deg)
    yy, xx = np.meshgrid(np.arange(h) - (h - 1) / 2,
                         np.arange(w) - (w - 1) / 2, indexing="ij")
    src = [math.cos(a) * yy + math.sin(a) * xx + (h - 1) / 2,
           -math.sin(a) * yy + math.cos(a) * xx + (w - 1) / 2]
    near = np.zeros_like(off[0])
    for v in src:
        near |= np.abs(v - np.floor(v) - 0.5) < 1e-3
    return not (off & ~near[None]).any() and off.mean() <= 1e-3


def pinned_spec(size):
    from image_segmentation_lab_tpu_torch.data import albu_yaml
    spec = albu_yaml.load(PINNED_YAML)
    spec["transform"]["transforms"][0].update(height=size, width=size)
    return spec


@pytest.mark.parametrize("size", [48, 64])
def test_pinned_pipeline_on_the_card_matches_the_cpu(cuda, size):
    """48² inputs: at 48 the Resize is the identity, at 64 it runs."""
    from image_segmentation_lab_tpu_torch.data.pipeline import Pipeline
    pipe = Pipeline.from_dict(pinned_spec(size))
    imgs, masks = raw_batch(f"pinned_{size}", 4, 48, 48)
    out, om = pipe(torch.Generator(device=cuda).manual_seed(0),
                   imgs.to(cuda), masks.to(cuda))
    ref, rm = pipe(torch.Generator().manual_seed(0), imgs, masks)
    assert out.device.type == cuda.type and out.shape == (4, 3, size, size)
    assert om.dtype == torch.int32
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=2e-4)
    assert rotate_flips_ok(om.cpu(), rm, 30.0)


LEAF_CASES = {
    "rotate_reflect101": dict(name="Rotate", limit=(-90, 90), border_mode=4),
    "rotate_constant": dict(name="Rotate", limit=(-90, 90), fill=9.0),
    "blur": dict(name="Blur", blur_limit=(3, 7)),
    "gaussian_blur": dict(name="GaussianBlur", blur_limit=(3, 9),
                          sigma_limit=(0.5, 2.0)),
    "motion_blur": dict(name="MotionBlur", blur_limit=(3, 13)),
    "defocus": dict(name="Defocus", radius=(3, 10), alias_blur=(0.1, 0.5)),
    "glass_blur": dict(name="GlassBlur", sigma=2.5, max_delta=4,
                       iterations=2),
    "hue_saturation_value": dict(name="HueSaturationValue"),
    "iso_noise": dict(name="ISONoise", color_shift=(0.05, 0.2)),
    "brightness_contrast": dict(name="RandomBrightnessContrast"),
    "gamma": dict(name="RandomGamma", gamma_limit=(60, 140)),
    "pad_reflect": dict(name="PadIfNeeded", min_height=70, min_width=41,
                        border_mode=2),
    "random_crop": dict(name="RandomCrop", height=30, width=33),
}


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_transform_with_cpu_draws_on_the_card_matches_the_cpu(cuda, case):
    """Per-image parameters drawn once on the CPU, applied on both."""
    from image_segmentation_lab_tpu_torch.data import transforms as T
    kw = dict(LEAF_CASES[case])
    t = T.TRANSFORMS[kw.pop("name")](p=1.0, **kw)
    imgs, masks = raw_batch(case, 4, 40, 52)
    x = imgs.permute(0, 3, 1, 2).float().contiguous()
    params = t.sample(torch.Generator().manual_seed(case_seed(case)), 4,
                      tuple(x.shape[1:]))
    ref, rm = t.apply(x, masks, params)
    out, om = t.apply(x.to(cuda), masks.to(cuda),
                      {k: v.to(cuda) for k, v in params.items()})
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-2)
    if isinstance(t, T.Rotate):
        for i, angle in enumerate(params["angle"].tolist()):
            assert rotate_flips_ok(om[i:i + 1].cpu(), rm[i:i + 1], angle)
    else:
        assert torch.equal(om.cpu(), rm)


# a DeepLabV3 of the flagship's structure at depth 18, stage widths 8-64,
# with the flagship's losses and no head dropout
TINY_FLAGSHIP = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNetV1c", depth=18, num_stages=4,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                  strides=(1, 2, 1, 1), norm_cfg=dict(type="SyncBatchNorm"),
                  contract_dilation=True, stem_channels=8, base_channels=8),
    decode_head=dict(type="ASPPHead", in_channels=64, in_index=3,
                     channels=16, dilations=(1, 12, 24, 36),
                     dropout_ratio=0.0, num_classes=2,
                     norm_cfg=dict(type="SyncBatchNorm"),
                     align_corners=False,
                     loss_decode=dict(type="CrossEntropyLoss",
                                      use_sigmoid=True, loss_weight=1.0)),
    auxiliary_head=dict(type="FCNHead", in_channels=32, in_index=2,
                        channels=8, num_convs=1, concat_input=False,
                        dropout_ratio=0.0, num_classes=2,
                        norm_cfg=dict(type="SyncBatchNorm"),
                        align_corners=False,
                        loss_decode=dict(type="CrossEntropyLoss",
                                         use_sigmoid=True, loss_weight=1.0)),
    train_cfg=dict(), test_cfg=dict(mode="whole"))


def test_fused_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One step of the tiny flagship with the pinned pipeline fused in,
    from the same weights and raw uint8 batch: the losses (rtol 1e-4) and
    every parameter and BN statistic after the update (rtol 1e-4, atol
    1e-5), with the resize backward kernel launched 3 times."""
    import copy

    from image_segmentation_lab_tpu_torch.data.pipeline import Pipeline
    from image_segmentation_lab_tpu_torch.models.builder import \
        build_segmentor
    from image_segmentation_lab_tpu_torch.train_state import (
        create_train_state, make_train_step)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(case_seed("fused_step"))
    cpu_model = build_segmentor(copy.deepcopy(TINY_FLAGSHIP))
    card_model = copy.deepcopy(cpu_model).to(cuda)
    imgs, masks = raw_batch("fused_step", 4, 48, 48)
    optimizer = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4)
    logs = []
    launched = dict(resize_backward.launches)
    for model, device in ((cpu_model, "cpu"), (card_model, cuda)):
        state = create_train_state(model, optimizer)
        step = make_train_step(state.model, state.optimizer,
                               pipeline=Pipeline.from_dict(pinned_spec(48)))
        logs.append(step(imgs.to(device), masks.to(device),
                         torch.Generator(device=device).manual_seed(0)))
    torch.cuda.synchronize()
    assert resize_backward.launches["resize_backward"] \
        - launched["resize_backward"] == 3
    for key, ref in logs[0].items():
        np.testing.assert_allclose(logs[1][key].cpu().numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    card_state = card_model.state_dict()
    for key, ref in cpu_model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(card_state[key].cpu().numpy(),
                                       ref.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=key)


def test_ppm_backward_under_deterministic_algorithms(cuda, monkeypatch):
    """PSPNet's pyramid pooling at its 640² shapes in miniature (an 80²
    map, scales 1, 2, 3, 6: uneven bins) under
    ``torch.use_deterministic_algorithms(True)``, which PyTorch's own
    adaptive average pooling backward refuses above 1 x 1: forward and
    backward run, give the same bits twice, and the input gradient equals
    the CPU's (rtol 1e-4, atol 1e-6)."""
    import copy

    from image_segmentation_lab_tpu_torch.models.decode_heads import PPM
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.manual_seed(case_seed("ppm_deterministic"))
    cpu_ppm = PPM((1, 2, 3, 6), 64, 16, norm_cfg=dict(type="SyncBatchNorm"),
                  act_cfg=dict(type="ReLU"))
    card_ppm = copy.deepcopy(cpu_ppm).to(cuda)
    g = torch.Generator(device="cpu").manual_seed(case_seed("ppm_x"))
    x = torch.randn(2, 64, 80, 80, generator=g)
    gy = torch.randn(2, 4 * 16, 80, 80, generator=g)
    grads = []
    torch.use_deterministic_algorithms(True)
    try:
        for module, device in ((card_ppm, cuda), (card_ppm, cuda),
                               (cpu_ppm, "cpu")):
            leaf = x.to(device).requires_grad_(True)
            with torch.enable_grad():
                out = torch.cat(module(leaf), dim=1)
                (grad,) = torch.autograd.grad(out, leaf, gy.to(device))
            grads.append(grad.cpu())
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], rtol=1e-4, atol=1e-6)


def test_point_sample_backward_is_deterministic_on_the_card(cuda):
    """``point_sample``'s backward (``torch.gather``'s) under
    ``torch.use_deterministic_algorithms(True)``: it has an implementation
    (``F.grid_sample``'s raises), the same bits on two calls, and the CPU's
    gradient within float32 rounding; at the point path's shapes (one map
    a row, 16 rows, 3 × 12544 points on a 160² map)."""
    from image_segmentation_lab_tpu_torch.ops.point_sample import \
        point_sample
    gen = torch.Generator().manual_seed(case_seed("point_sample"))
    feat = torch.randn(16, 1, 160, 160, generator=gen)
    points = torch.rand(16, 3 * 12544, 2, generator=gen)
    cot = torch.randn(16, 1, 3 * 12544, generator=gen)

    def grad(device):
        x = feat.to(device).requires_grad_(True)
        with torch.enable_grad():
            (point_sample(x, points.to(device)) * cot.to(device)).sum(
            ).backward()
        return x.grad

    torch.use_deterministic_algorithms(True)
    try:
        first, second = grad(cuda), grad(cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(first, second)
    torch.testing.assert_close(first.cpu(), grad("cpu"), rtol=1e-5,
                               atol=1e-6)


def test_auction_on_the_card_equals_the_cpu(cuda):
    """The batched auction on the card against the same on the CPU: 80
    seeded problems (10 predictions × 8 images, 2 targets of which some
    invalid, 100 queries) and 8 with integer-valued ties: the same
    assignments and owners."""
    from image_segmentation_lab_tpu_torch.ops.matching import \
        auction_assignment
    gen = torch.Generator().manual_seed(case_seed("auction"))
    cost = torch.rand(88, 2, 100, generator=gen) * 10
    cost[80:] = torch.round(cost[80:])
    valid = torch.rand(88, 2, generator=gen) < 0.8
    col, owner = auction_assignment(cost.to(cuda), valid.to(cuda))
    ref_col, ref_owner = auction_assignment(cost, valid)
    assert torch.equal(col.cpu(), ref_col) and torch.equal(owner.cpu(),
                                                           ref_owner)
    assert bool((ref_col[valid] >= 0).all())


def test_resize_backward_kernel_takes_the_users_scale(cuda):
    """MultiLevelNeck's 0.5 level on an odd grid (25 -> 12, read at step
    2) and its 4x and 2x levels: the kernel's tables carry the scale, and
    one launch gives the plain version's bits in both dtypes."""
    for (n, c, h, w), scale in (((2, 8, 25, 25), 0.5), ((2, 8, 25, 25), 4),
                                ((2, 8, 13, 11), 2)):
        size = (int(h * scale), int(w * scale))
        gen = torch.Generator().manual_seed(case_seed(f"scale_{scale}"))
        for dtype in (torch.float32, torch.bfloat16):
            gy = torch.randn(n, c, *size, generator=gen).to(cuda, dtype)
            got = resize_backward.resize_backward(gy, (h, w), False,
                                                  (scale, scale))
            assert torch.equal(got, resize_backward.resize_backward_plain(
                gy, (h, w), False, (scale, scale)))
        x = torch.randn(n, c, h, w, generator=gen).to(cuda)
        x.requires_grad_(True)
        with torch.enable_grad():
            out = resize(x, scale_factor=scale, align_corners=False)
            out.backward(gy.float())
        assert out.shape[2:] == size
        assert torch.equal(x.grad, resize_backward.resize_backward_plain(
            gy.float(), (h, w), False, (scale, scale)))


@pytest.mark.parametrize("what", ["avg_pool2d_poolformer",
                                  "avg_pool2d_v1d", "nearest_fpn"])
def test_pool_and_nearest_backward_repeat_under_deterministic_algorithms(
        cuda, what):
    """PoolFormer's mixer (3/1/1 without the padding counted), ResNetV1d's
    averaged shortcut (2/2, ``ceil_mode``, on an odd map) and the FPN's
    nearest top-down resize (``index_select``, whose backward adds by
    index) under ``torch.use_deterministic_algorithms(True)``, which
    raises on an op without a deterministic CUDA implementation: the same
    bits twice, and the CPU's gradient within float32 rounding."""
    from image_segmentation_lab_tpu_torch.ops.pooling import avg_pool2d
    fns = {"avg_pool2d_poolformer": ((8, 64, 128, 128), lambda x: avg_pool2d(
               x, 3, 1, 1, count_include_pad=False)),
           "avg_pool2d_v1d": ((8, 256, 81, 81), lambda x: avg_pool2d(
               x, 2, 2, ceil_mode=True, count_include_pad=False)),
           "nearest_fpn": ((8, 256, 16, 16), lambda x: resize(
               x, (32, 32), mode="nearest"))}
    shape, fn = fns[what]
    gen = torch.Generator().manual_seed(case_seed(what))
    x = torch.randn(*shape, generator=gen)
    cot = torch.randn(*fn(x).shape, generator=gen)

    def grad(device):
        t = x.to(device).requires_grad_(True)
        with torch.enable_grad():
            fn(t).backward(cot.to(device))
        return t.grad

    torch.use_deterministic_algorithms(True)
    try:
        first, second = grad(cuda), grad(cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(first, second)
    torch.testing.assert_close(first.cpu(), grad("cpu"), rtol=1e-5,
                               atol=1e-6)


def test_ohem_and_boundary_map_on_the_card_equal_the_cpu(cuda):
    """PIDNet's and DDRNet's discrete choices on the card, under
    ``torch.use_deterministic_algorithms(True)`` (``torch.sort`` runs
    there; ``torch.kthvalue`` has no deterministic CUDA implementation):
    OHEM's kept set from the same probabilities in both regimes, and the
    boundary map of the same labels, equal to the CPU's."""
    from image_segmentation_lab_tpu_torch.models.decode_heads.pid_head \
        import boundary_from_label
    from image_segmentation_lab_tpu_torch.models.losses.ohem_cross_entropy \
        import ohem_kept
    gen = torch.Generator().manual_seed(case_seed("ohem"))
    p = torch.rand(4 * 160 * 160, generator=gen)
    valid = torch.rand(p.shape, generator=gen) >= 0.1
    p = torch.where(valid, p, torch.full((), float("inf")))
    labels = torch.randint(0, 3, (4, 20, 20), generator=gen)
    labels = labels.repeat_interleave(8, 1).repeat_interleave(8, 2)
    labels[torch.rand(labels.shape, generator=gen) < 0.05] = 255
    torch.use_deterministic_algorithms(True)
    try:
        for min_kept in (10_000, 200_000):
            got = ohem_kept(p.to(cuda), valid.to(cuda), min_kept, 0.7)
            assert torch.equal(got.cpu(), ohem_kept(p, valid, min_kept, 0.7))
        edges = boundary_from_label(labels.to(cuda), 4, 255)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(edges.cpu(), boundary_from_label(labels, 4, 255))
    assert 0 < float(edges.mean()) < 1


def test_nmf_on_the_card_repeats_and_stays_float32_under_autocast(cuda):
    """SegNeXt's NMF at eval: the same bits on a second call (bases from a
    generator seeded with 0 on the card), and under the bf16 autocast its
    float32 result rounded once."""
    from image_segmentation_lab_tpu_torch.models.decode_heads.ham_head \
        import NMF2D
    nmf = NMF2D(dict(MD_S=1, MD_R=16, TRAIN_STEPS=6, EVAL_STEPS=7,
                     INV_T=100, RAND_INIT=True)).eval()
    gen = torch.Generator().manual_seed(case_seed("nmf"))
    x = torch.rand(16, 256, 80, 80, generator=gen).to(cuda)
    first = nmf(x)
    assert torch.equal(first, nmf(x))
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = nmf(x.bfloat16())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, nmf(x.bfloat16().float()).bfloat16())


def test_psa_mask_backward_is_deterministic_on_the_card(cuda):
    """PSANet's mask gather (``psa_head.psa_mask``) and its backward under
    ``torch.use_deterministic_algorithms(True)``, both directions, at the
    psanet config's 79 x 79 mask on the shrunk 40² map: the CPU's planes
    and gradient exactly (each input tap is gathered at most once), and the
    same bits on a second call."""
    from image_segmentation_lab_tpu_torch.models.decode_heads.psa_head \
        import psa_mask
    gen = torch.Generator().manual_seed(case_seed("psa_mask"))
    x = torch.randn(2, 79 * 79, 40, 40, generator=gen)
    cot = torch.randn(2, 1600, 1600, generator=gen)

    def run(device, psa_type):
        xd = x.to(device, copy=True).requires_grad_(True)
        with torch.enable_grad():
            out = psa_mask(xd, (79, 79), psa_type)
            (out * cot.to(device)).sum().backward()
        return out.detach(), xd.grad

    for psa_type in ("collect", "distribute"):
        torch.use_deterministic_algorithms(True)
        try:
            first, second = run(cuda, psa_type), run(cuda, psa_type)
        finally:
            torch.use_deterministic_algorithms(False)
        cpu = run("cpu", psa_type)
        for got, again, want in zip(first, second, cpu):
            assert torch.equal(got, again)
            assert torch.equal(got.cpu(), want)


def test_attention_scores_are_float32_under_autocast_on_the_card(cuda):
    """``attention.float32_product`` of bf16 operands under the bf16
    autocast, as the non-local heads form their scores: float32, equal to
    the float32 product of the same operands with TF32 off."""
    gen = torch.Generator().manual_seed(case_seed("float32_product"))
    a = torch.randn(4, 1600, 256, generator=gen).to(cuda, torch.bfloat16)
    b = torch.randn(4, 256, 1600, generator=gen).to(cuda, torch.bfloat16)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = attention.float32_product(a, b)
        want = torch.matmul(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
