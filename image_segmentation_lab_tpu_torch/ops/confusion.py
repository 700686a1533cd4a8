"""Confusion histograms: the hand-written CUDA kernel and its plain version
(counterpart of ``image_segmentation_lab_tpu/ops/pallas/confusion.py``).

Two entries, one kernel (``csrc/confusion.cu``):

* ``confusion_histograms(logits, gt, ...)``: fused argmax over NCHW logits;
* ``confusion_histograms_from_labels(pred, gt, ...)``: from class maps.

Each returns one ``(3, num_classes)`` float32 tensor whose rows are
``area_intersect``, ``area_pred`` and ``area_label`` counted over valid
pixels (``gt != ignore_index`` and ``0 <= gt < num_classes``), so
``inter, pred, label = confusion_histograms(...)`` unpacks them.  For a
CPU tensor the wrapper computes the plain PyTorch version; for a CUDA
tensor it launches the kernel or raises: one device kernel per call,
which writes the float32 counts itself (no fill, no cast).  There is no regime gate: the JAX package's gate was measured on a
TPU.

The kernel is compiled at first use by ``ops/nvcc_build.py``.
"""

from __future__ import annotations

import ctypes
import torch

from .nvcc_build import load_library

# a CTA's shared-memory bins [3][num_classes] stay within 48 KB
MAX_CLASSES = 4096
# int32 of the CTAs' partial rows, allocated per call (the grid never has
# more rows than fit)
PARTIAL_INTS = 1 << 18
# the kernel's entry codes (csrc/confusion.cu)
_ENTRY = {torch.float32: 0, torch.bfloat16: 1, "labels": 2}

# launches per entry, counted where the kernel is launched and nowhere
# else, and per kernel instance (``instance_name``)
launches = {"logits": 0, "labels": 0}
instances = {}
_lib = None
# (device index, stream) -> the stream's ticket, one int32 the kernel's
# last CTA draws and resets to 0
_tickets = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``confusion.cu``."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.confusion_histograms.argtypes = [i32, ptr, ptr, i64, i64, i32, i32,
                                         i32, ptr, ptr, i64, ptr, i32, ptr,
                                         ctypes.POINTER(i32)]
    lib.confusion_histograms.restype = i32
    lib.confusion_error_string.argtypes = [i32]
    lib.confusion_error_string.restype = ctypes.c_char_p
    return lib


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = bind(load_library("confusion.cu"))
    return _lib


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
def instance_name(code: int) -> str:
    """The kernel instance of a launch's code (``csrc/confusion.cu``):
    entry, register slots or shared bins, 16-byte packets or one pixel."""
    entry, slots, vec = code // 100, code // 10 % 10, code % 10
    return (f"{('float32', 'bfloat16', 'labels')[entry]}/"
            f"{f'{slots} slots' if slots else 'shared'}/"
            f"{'packets' if vec else 'one pixel'}")


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


def _launch(entry: str, code: int, src, gt, hw: int, channels: int,
            num_classes: int, ignore_index: int) -> torch.Tensor:
    lib = build_library()
    device = gt.device
    stream = torch.cuda.current_stream(device).cuda_stream
    ticket = _tickets.get((device.index, stream))
    if ticket is None:  # the one fill, at a stream's first call
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
        _tickets[(device.index, stream)] = ticket
    partials = torch.empty(PARTIAL_INTS, dtype=torch.int32, device=device)
    out = torch.empty((3, num_classes), dtype=torch.float32, device=device)
    instance = ctypes.c_int(-1)
    err = lib.confusion_histograms(
        code, src.data_ptr(), gt.data_ptr(), gt.numel(), hw, channels,
        num_classes, ignore_index, ticket.data_ptr(), partials.data_ptr(),
        partials.numel(), out.data_ptr(), device.index, stream,
        ctypes.byref(instance))
    if err != 0:
        raise RuntimeError(
            f"confusion kernel launch failed: "
            f"{lib.confusion_error_string(err).decode()}")
    launches[entry] += 1
    name = instance_name(instance.value)
    instances[name] = instances.get(name, 0) + 1
    return out


def confusion_histograms(logits: torch.Tensor, gt: torch.Tensor,
                         num_classes: int, ignore_index: int) -> torch.Tensor:
    """``(3, num_classes)`` counts from ``(N, C, H, W)`` float32/bfloat16
    logits (argmax over C, C >= num_classes) and ``(N, H, W)`` int32
    labels."""
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
        return torch.stack(histograms_plain(logits, gt, num_classes,
                                            ignore_index))
    n, c, h, w = logits.shape
    return _launch("logits", _ENTRY[logits.dtype], logits, gt, h * w, c,
                   num_classes, ignore_index)


def confusion_histograms_from_labels(pred: torch.Tensor, gt: torch.Tensor,
                                     num_classes: int,
                                     ignore_index: int) -> torch.Tensor:
    """``(3, num_classes)`` counts from int32 class maps ``pred`` and
    ``gt`` of one shape."""
    if pred.shape != gt.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and gt "
                         f"{tuple(gt.shape)} differ in shape")
    if pred.dtype != torch.int32:
        raise TypeError(f"pred must be int32, got {pred.dtype}")
    _check_common(pred, gt, num_classes)
    if pred.device.type == "cpu":
        return torch.stack(histograms_from_labels_plain(
            pred, gt, num_classes, ignore_index))
    return _launch("labels", _ENTRY["labels"], pred, gt, gt.numel(), 1,
                   num_classes, ignore_index)

