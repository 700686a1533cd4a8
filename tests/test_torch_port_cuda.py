"""The hand-written kernels against their plain versions, on the card.

Skipped without an NVIDIA GPU.  This file imports no jax, so it runs on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.  Confusion counts are integers: equality
is exact.  Flash attention: atol 2e-6 / rtol 1e-5 in float32 at
unit-normal inputs (float32 reduction order), 2e-2 / 2e-2 in bfloat16, as
in tests/test_flash_attention.py; its gradients atol 2e-5 / rtol 1e-4 in
float32, the JAX tests' gradient tolerance.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from image_segmentation_lab_tpu_torch.ops import (attention, confusion,
                                                  flash_attention, nvcc_build)
from image_segmentation_lab_tpu_torch.utils.ops import resize

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# (N, C, H, W), num_classes, ignore_index, dtype
CASES = {
    "flagship_c2": ((2, 2, 67, 131), 2, 255, torch.float32),
    "c19_bf16": ((2, 19, 33, 65), 19, 255, torch.bfloat16),
    "ignore_neg1": ((3, 5, 97, 131), 5, -1, torch.float32),
    "channels_gt_classes": ((1, 7, 40, 40), 4, 255, torch.float32),
    "ties": ((2, 4, 50, 50), 4, 255, torch.float32),
    "empty": ((0, 2, 8, 8), 2, 255, torch.float32),
}


def make_inputs(name, device):
    (n, c, h, w), num_classes, ignore, dtype = CASES[name]
    g = torch.Generator(device="cpu").manual_seed(sorted(CASES).index(name))
    if name == "ties":
        logits = torch.randint(0, 2, (n, c, h, w), generator=g).float()
    else:
        logits = torch.randn((n, c, h, w), generator=g)
    gt = torch.randint(-1, num_classes + 2, (n, h, w), generator=g)
    gt[torch.rand((n, h, w), generator=g) < 0.2] = ignore
    return (logits.to(device=device, dtype=dtype),
            gt.to(device=device, dtype=torch.int32), num_classes, ignore)


def assert_counts_equal(out, ref):
    for a, b, what in zip(out, ref, ("inter", "pred", "label")):
        assert a.dtype == torch.float32 and a.is_cuda
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(),
                                      err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name):
    logits, gt, num_classes, ignore = make_inputs(name, cuda)
    assert_counts_equal(
        confusion.confusion_histograms(logits, gt, num_classes, ignore),
        confusion.histograms_plain(logits, gt, num_classes, ignore))
    pred = torch.randint(-2, num_classes + 2, gt.shape, device=cuda,
                         dtype=torch.int32)
    assert_counts_equal(
        confusion.confusion_histograms_from_labels(pred, gt, num_classes,
                                                   ignore),
        confusion.histograms_from_labels_plain(pred, gt, num_classes,
                                               ignore))


def test_nan_is_the_maximum_as_in_torch_argmax(cuda):
    logits, gt, num_classes, ignore = make_inputs("ignore_neg1", cuda)
    logits[:, 2, ::3] = float("nan")
    logits[:, 0, ::7] = float("nan")
    assert_counts_equal(
        confusion.confusion_histograms(logits, gt, num_classes, ignore),
        confusion.histograms_plain(logits, gt, num_classes, ignore))


def test_each_entry_counts_its_launches(cuda, monkeypatch):
    monkeypatch.setattr(confusion, "launches", {"logits": 0, "labels": 0})
    logits, gt, num_classes, ignore = make_inputs("flagship_c2", cuda)
    confusion.confusion_histograms(logits, gt, num_classes, ignore)
    confusion.confusion_histograms(logits, gt, num_classes, ignore)
    confusion.confusion_histograms_from_labels(gt, gt, num_classes, ignore)
    assert confusion.launches == {"logits": 2, "labels": 1}


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
# the last tile's 64 keys masked, Lk = 1 makes o equal v
FLASH_CASES = {
    "setr_f32": ((8, 6, 1601, 1601, 64), torch.float32),
    "setr_bf16": ((8, 6, 1601, 1601, 64), torch.bfloat16),
    "mit_f32": ((8, 1, 25600, 400, 32), torch.float32),
    "ragged_130": ((3, 1, 130, 130, 64), torch.float32),
    "d48": ((1, 2, 300, 300, 48), torch.float32),
    "masked_tail": ((2, 3, 63, 65, 32), torch.float32),
    "one_key_bf16": ((2, 2, 70, 1, 64), torch.bfloat16),
}
FLASH_TOL = {torch.float32: dict(atol=2e-6, rtol=1e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def flash_inputs(name, device):
    (n, h, lq, lk, d), dtype = FLASH_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(
        sorted(FLASH_CASES).index(name))
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
    """At SETR's shape and qkv layout: the default runs the kernel once,
    ``force="plain"`` runs no kernel, and the two agree."""
    monkeypatch.setattr(flash_attention, "launches", {"forward": 0})
    n, lq, h, d = 8, 1601, 6, 64
    g = torch.Generator(device="cpu").manual_seed(6)
    qkv = torch.randn(n, lq, 3 * h * d, generator=g).to(cuda)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    with torch.no_grad():
        out = attention.multihead_attention(q, k, v, d ** -0.5)
        plain = attention.multihead_attention(q, k, v, d ** -0.5,
                                              force="plain")
    assert flash_attention.launches == {"forward": 1}
    torch.testing.assert_close(out, plain, **FLASH_TOL[torch.float32])


def test_flash_counts_its_launches(cuda, monkeypatch):
    monkeypatch.setattr(flash_attention, "launches",
                        {"forward": 0, "forward_bf16": 0})
    q, k, v = flash_inputs("ragged_130", cuda)
    with torch.no_grad():
        for _ in range(3):
            flash_attention.flash_attention_forward(q, k, v, 0.125)
        flash_attention.attention_plain(q, k, v, 0.125)
    assert flash_attention.launches == {"forward": 3, "forward_bf16": 0}


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
    g = torch.Generator(device="cpu").manual_seed(
        sorted(BF16_CASES).index(name))
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


def test_bf16_kernel_refuses_rows_off_16_bytes(cuda):
    x = torch.zeros(1, 8, 1, 72, device=cuda, dtype=torch.bfloat16)
    q = x[..., 4:68]  # rows start 8 bytes in
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_attention_forward(q, q, q, 0.125)


# (N, h, Lq, Lk, d), dtype: the backward kernels at SETR's training shape,
# d = 32/48/64, Lq != Lk, ragged, and Lk = 65 (63 masked keys in the last
# tile); q, k, v are views of one fused projection (or q and a fused kv)
BWD_CASES = {
    "setr_f32": ((8, 6, 1601, 1601, 64), torch.float32),
    "setr_bf16": ((8, 6, 1601, 1601, 64), torch.bfloat16),
    "mit_f32": ((8, 1, 25600, 400, 32), torch.float32),
    "ragged_130": ((3, 1, 130, 130, 64), torch.float32),
    "d48_bf16": ((1, 2, 300, 300, 48), torch.bfloat16),
    "masked_tail": ((2, 3, 63, 65, 32), torch.float32),
    "lq_ne_lk_d48": ((2, 2, 100, 37, 48), torch.float32),
}


def bwd_tol(ref):
    """Float32: tests/test_flash_attention.py's gradient tolerance.
    Bfloat16: one rounding step of the value (2**-7 of it) plus 1e-3 of the
    tensor's largest value, so that a lost key tile or a wrong cast
    fails."""
    if ref.dtype == torch.float32:
        return dict(atol=2e-5, rtol=1e-4)
    return dict(atol=1e-3 * ref.float().abs().max().item(), rtol=2.0 ** -7)


def projection_views(name, device):
    (n, h, lq, lk, d), dtype = BWD_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(
        sorted(BWD_CASES).index(name))

    def proj(length, parts):
        x = torch.randn(n, length, parts * h * d, generator=g)
        x = x.to(device=device, dtype=dtype)
        return [t.unflatten(-1, (h, d)) for t in x.split(h * d, dim=-1)]

    qkv = proj(lq, 3) if lq == lk else proj(lq, 1) + proj(lk, 2)
    do = torch.randn(n, lq, h, d, generator=g).to(device=device, dtype=dtype)
    return (*qkv, do)


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_flash_backward_kernels_match_plain(cuda, name):
    q, k, v, do = projection_views(name, cuda)
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        o, lse = flash_attention.flash_attention_forward(q, k, v, scale)
        delta = flash_attention.backward_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        dq = flash_attention.flash_attention_backward_dq(*args)
        dk, dv = flash_attention.flash_attention_backward_dkv(*args)
        refs = flash_attention.attention_backward_plain(*args)
    for out, ref, t in zip((dq, dk, dv), refs, (q, k, v)):
        assert out.dtype == t.dtype and out.is_cuda and out.is_contiguous()
        assert out.shape == t.shape
        torch.testing.assert_close(out.float(), ref.float(),
                                   **bwd_tol(ref))


def test_grad_through_multihead_attention_launches_each_kernel_once(
        cuda, monkeypatch):
    """At SETR's qkv layout: one forward and one backward through the
    Function launch K3, K4 and K5 once each and agree with autograd
    through the plain version."""
    counts = {"forward": 0, "backward_dq": 0, "backward_dkv": 0}
    monkeypatch.setattr(flash_attention, "launches", dict(counts))
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
    assert flash_attention.launches == {"forward": 1, "backward_dq": 1,
                                        "backward_dkv": 1}
    torch.testing.assert_close(grads[None], grads["plain"],
                               **bwd_tol(grads["plain"]))


def test_flash_backward_counts_its_launches(cuda, monkeypatch):
    monkeypatch.setattr(flash_attention, "launches",
                        {"forward": 0, "backward_dq": 0, "backward_dkv": 0})
    q, k, v, do = projection_views("ragged_130", cuda)
    with torch.no_grad():
        o, lse = flash_attention.flash_attention_forward(q, k, v, 0.125)
        for _ in range(2):
            flash_attention.flash_attention_backward(q, k, v, o, lse, do,
                                                     0.125)
        delta = flash_attention.backward_delta(o, do)
        flash_attention.attention_backward_plain(q, k, v, do, lse, delta,
                                                 0.125)
    assert flash_attention.launches == {"forward": 1, "backward_dq": 2,
                                        "backward_dkv": 2}


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
    monkeypatch.setattr(flash_attention, "_lib", None)
    monkeypatch.setattr(flash_attention, "_sm90_lib", None)
    monkeypatch.setattr(flash_attention, "_bwd_lib", None)
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
