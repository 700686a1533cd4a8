"""Flash-attention forward: the hand-written CUDA kernel and its plain
version (counterpart of ``image_segmentation_lab_tpu/ops/pallas/
flash_attention.py``, forward only).

``flash_attention_forward(q, k, v, scale) -> (o, lse)`` takes ``q (N, Lq,
h, d)`` and ``k/v (N, Lk, h, d)``, float32 or bfloat16, ``Lq != Lk``
allowed, and returns ``o = softmax(q kᵀ·scale) v`` as a contiguous ``(N,
Lq, h, d)`` tensor in q's dtype and the per-row logsumexp ``lse (N, h,
Lq)`` in float32.  Scores and the softmax are float32 and the
probabilities are cast to v's dtype for the PV product, as in the einsum
path of ``image_segmentation_lab_tpu/ops/attention.py``.

For a CPU tensor the wrapper computes the plain PyTorch version
(``attention_plain``); for a CUDA tensor it launches the kernel
(``csrc/flash_attention.cu``, built at first use by ``ops/nvcc_build.py``)
or raises.  The kernel reads q, k and v through their strides (the head
dim must be contiguous), so the slices of a fused qkv projection need no
copy.  It has no backward yet: a CUDA call that would need a gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .nvcc_build import load_library

SUPPORTED_HEAD_DIMS = (32, 48, 64)
_MAX_GRID_YZ = 65535  # heads and batch are the kernel's grid y and z

# launches, counted where the kernel is launched and nowhere else
launches = {"forward": 0}
_lib = None


def build_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("flash_attention.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("flash_attention_forward_f32",
                 "flash_attention_forward_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
                       ctypes.c_float, ptr]
        fn.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


# ------------------------------------------------------------ plain version
def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Einsum, float32 softmax, cast to v's dtype, einsum."""
    scores = torch.einsum("nlhd,nshd->nhls", q.float(), k.float()) * scale
    attn = torch.softmax(scores, dim=-1)
    o = torch.einsum("nhls,nshd->nlhd", attn.to(v.dtype), v)
    return o, torch.logsumexp(scores, dim=-1)


# ------------------------------------------------------------ wrapper
def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (N, Lq, h, d) and k, v (N, Lk, h, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                 k.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head dim")
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.float32,
                                                            torch.bfloat16):
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"inputs on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of softmax attention; see the module docstring."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel has no backward yet (the TPU "
            "kernels _bwd_dq_kernel and _bwd_dkv_kernel, ROADMAP Queue 2 "
            "items 4-5); run it under torch.no_grad()")
    n, lq, h, d = q.shape
    lk = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} is not supported by the kernel; "
                         f"supported: {SUPPORTED_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the kernel needs a contiguous head dim")
    if n > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {n} or heads {h} above {_MAX_GRID_YZ}")
    o = torch.empty((n, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, lq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = build_library()
    fn = (lib.flash_attention_forward_f32 if q.dtype == torch.float32
          else lib.flash_attention_forward_bf16)
    strides = (ctypes.c_int64 * 9)(*[t.stride(i) for t in (q, k, v)
                                     for i in (0, 1, 2)])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), n, h, lq, lk, d, strides, float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"flash-attention kernel launch failed: "
            f"{lib.flash_attention_error_string(err).decode()}")
    launches["forward"] += 1
    return o, lse
