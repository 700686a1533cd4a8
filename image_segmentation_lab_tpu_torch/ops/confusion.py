"""Confusion histograms: the hand-written CUDA kernel and its plain version
(counterpart of ``image_segmentation_lab_tpu/ops/pallas/confusion.py``).

Two entries, one kernel (``csrc/confusion.cu``):

* ``confusion_histograms(logits, gt, ...)``: fused argmax over NCHW logits;
* ``confusion_histograms_from_labels(pred, gt, ...)``: from class maps.

Each returns ``(area_intersect, area_pred, area_label)``, three
``(num_classes,)`` float32 tensors, counted over valid pixels
(``gt != ignore_index`` and ``0 <= gt < num_classes``).  For a CPU tensor
the wrapper computes the plain PyTorch version; for a CUDA tensor it
launches the kernel or raises.  There is no regime gate: the JAX package's
gate was measured on a TPU.

The kernel is compiled at first use by ``ops/nvcc_build.py``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .nvcc_build import load_library

# per-block shared-memory bins [3][num_classes] stay within the 48 KB that
# needs no opt-in
MAX_CLASSES = 4096

# launches per entry, counted where the kernel is launched and nowhere else
launches = {"logits": 0, "labels": 0}
_lib = None


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("confusion.cu")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("confusion_from_logits_f32", "confusion_from_logits_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i64, i64, i32, i32, i32, ptr, ptr]
        fn.restype = i32
    lib.confusion_from_labels.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr]
    lib.confusion_from_labels.restype = i32
    lib.confusion_error_string.argtypes = [i32]
    lib.confusion_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


# ------------------------------------------------------------ plain version
def histograms_from_labels_plain(pred, gt, num_classes: int,
                                 ignore_index: int):
    """``torch.bincount`` version of the three counts."""
    valid = (gt != ignore_index) & (gt >= 0) & (gt < num_classes)
    p, g = pred[valid].long(), gt[valid].long()
    in_range = (p >= 0) & (p < num_classes)

    def hist(values):
        return torch.bincount(values, minlength=num_classes).to(torch.float32)

    return hist(g[p == g]), hist(p[in_range]), hist(g)


def histograms_plain(logits, gt, num_classes: int, ignore_index: int):
    """``torch.argmax`` over the class axis, then the plain counts."""
    return histograms_from_labels_plain(torch.argmax(logits, dim=1), gt,
                                        num_classes, ignore_index)


# ------------------------------------------------------------ wrappers
def _check_common(x, gt, num_classes: int):
    if gt.dtype != torch.int32:
        raise TypeError(f"gt must be int32, got {gt.dtype}")
    if x.device != gt.device:
        raise ValueError(f"inputs on different devices: {x.device}, "
                         f"{gt.device}")
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}], got "
                         f"{num_classes}")
    if gt.numel() >= 2 ** 31:
        raise ValueError(f"{gt.numel()} pixels overflow the int32 counts")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous()
                                        and gt.is_contiguous()):
        raise ValueError("the kernel needs contiguous inputs")


def _launch(entry: str, fn, args, device, num_classes: int):
    out = torch.zeros((3, num_classes), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"confusion kernel launch failed: "
            f"{build_library().confusion_error_string(err).decode()}")
    launches[entry] += 1
    out = out.to(torch.float32)
    return out[0], out[1], out[2]


def confusion_histograms(logits: torch.Tensor, gt: torch.Tensor,
                         num_classes: int,
                         ignore_index: int) -> Tuple[torch.Tensor, ...]:
    """Counts from ``(N, C, H, W)`` float32/bfloat16 logits (argmax over C,
    C >= num_classes) and ``(N, H, W)`` int32 labels."""
    if logits.dim() != 4 or gt.shape != (logits.shape[0], *logits.shape[2:]):
        raise ValueError(f"expected (N, C, H, W) logits and (N, H, W) gt, "
                         f"got {tuple(logits.shape)} and {tuple(gt.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if logits.shape[1] < num_classes:
        raise ValueError(f"{logits.shape[1]} channels < {num_classes} "
                         f"classes")
    _check_common(logits, gt, num_classes)
    if logits.device.type == "cpu":
        return histograms_plain(logits, gt, num_classes, ignore_index)
    lib = build_library()
    fn = (lib.confusion_from_logits_f32 if logits.dtype == torch.float32
          else lib.confusion_from_logits_bf16)
    n, c, h, w = logits.shape
    return _launch("logits", fn,
                   (logits.data_ptr(), gt.data_ptr(), n, h * w, c,
                    num_classes, ignore_index), logits.device, num_classes)


def confusion_histograms_from_labels(pred: torch.Tensor, gt: torch.Tensor,
                                     num_classes: int,
                                     ignore_index: int
                                     ) -> Tuple[torch.Tensor, ...]:
    """Counts from int32 class maps ``pred`` and ``gt`` of one shape."""
    if pred.shape != gt.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and gt "
                         f"{tuple(gt.shape)} differ in shape")
    if pred.dtype != torch.int32:
        raise TypeError(f"pred must be int32, got {pred.dtype}")
    _check_common(pred, gt, num_classes)
    if pred.device.type == "cpu":
        return histograms_from_labels_plain(pred, gt, num_classes,
                                            ignore_index)
    lib = build_library()
    return _launch("labels", lib.confusion_from_labels,
                   (pred.data_ptr(), gt.data_ptr(), gt.numel(), num_classes,
                    ignore_index), pred.device, num_classes)
