"""The hand-written confusion kernel against its plain version, on the card.

Skipped without an NVIDIA GPU.  This file imports no jax, so it runs on a
machine without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py``.  Counts are integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from image_segmentation_lab_tpu_torch.ops import confusion

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
    monkeypatch.setattr(confusion, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(confusion.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    logits, gt, num_classes, ignore = make_inputs("flagship_c2", cuda)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        confusion.confusion_histograms(logits, gt, num_classes, ignore)
