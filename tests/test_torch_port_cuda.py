"""The hand-written kernels against their plain versions, on the card.

Skipped without an NVIDIA GPU.  This file imports no jax, so it runs on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.  Confusion counts are integers: equality
is exact.  Flash attention: atol 2e-6 / rtol 1e-5 in float32 at
unit-normal inputs (float32 reduction order), 2e-2 / 2e-2 in bfloat16, as
in tests/test_flash_attention.py.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from image_segmentation_lab_tpu_torch.ops import (attention, confusion,
                                                  flash_attention, nvcc_build)

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
    monkeypatch.setattr(flash_attention, "launches", {"forward": 0})
    q, k, v = flash_inputs("ragged_130", cuda)
    with torch.no_grad():
        for _ in range(3):
            flash_attention.flash_attention_forward(q, k, v, 0.125)
        flash_attention.attention_plain(q, k, v, 0.125)
    assert flash_attention.launches == {"forward": 3}


def test_flash_under_grad_raises(cuda):
    q, k, v = flash_inputs("ragged_130", cuda)
    q.requires_grad_(True)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="no backward"):
        flash_attention.flash_attention_forward(q, k, v, 0.125)


def test_flash_unsupported_head_dim_raises(cuda):
    q = torch.zeros(1, 8, 1, 40, device=cuda)
    with pytest.raises(ValueError, match=r"\(32, 48, 64\)"):
        flash_attention.flash_attention_forward(q, q, q, 0.5)


def test_flash_without_library_raises(cuda, monkeypatch, tmp_path):
    """No compiler, no library: a CUDA tensor raises; the module has no
    try that could fall back to the plain version."""
    tree = ast.parse(inspect.getsource(flash_attention))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    monkeypatch.setattr(flash_attention, "_lib", None)
    monkeypatch.setattr(nvcc_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    q, k, v = flash_inputs("ragged_130", cuda)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attention.flash_attention_forward(q, k, v, 0.125)
