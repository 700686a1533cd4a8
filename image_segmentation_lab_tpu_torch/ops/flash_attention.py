"""Flash attention: the hand-written CUDA kernels, forward and backward,
and their plain versions (counterpart of ``image_segmentation_lab_tpu/ops/
pallas/flash_attention.py``).

``flash_attention_forward(q, k, v, scale) -> (o, lse)`` takes ``q (N, Lq,
h, d)`` and ``k/v (N, Lk, h, d)``, float32 or bfloat16, ``Lq != Lk``
allowed, and returns ``o = softmax(q kᵀ·scale) v`` as a contiguous ``(N,
Lq, h, d)`` tensor in q's dtype and the per-row logsumexp ``lse (N, h,
Lq)`` in float32.  Scores and the softmax are float32 and the
probabilities are cast to v's dtype for the PV product, as in the einsum
path of ``image_segmentation_lab_tpu/ops/attention.py``.  When grad is on
and an input requires it, the call goes through ``FlashAttention``, a
``torch.autograd.Function`` whose backward is
``flash_attention_backward``: ``delta = rowsum(dO·O)`` in plain torch, as
the JAX ``_flash_backward`` computes it outside its kernels, then the dQ
kernel and the dK/dV kernel, which recompute the probabilities from the
saved lse.

For CPU tensors each wrapper computes the plain PyTorch version
(``attention_plain``, ``attention_backward_plain``, ``split_bf16x3_plain``);
for CUDA tensors it launches its kernel or raises.  Forward
(``csrc/flash_attention_sm90.cu``) and backward
(``csrc/flash_attention_bwd_sm90.cu``) run on the tensor cores (wgmma) in
both types: bfloat16 as it is (rows must start on 16 bytes), float32 split
into three bf16 parts (hi + mid + lo, exact) by ``split_bf16x3``, one launch
for q, k and v per forward call and one for q, k, v and dO per backward
call, with each float32 product taken as six bf16 products.  Each source is
built at first use by ``ops/nvcc_build.py``, and each kernel counts its own
launches.  The kernels (and the split) read q, k, v and dO through their
strides (the head dim must be contiguous), so the slices of a fused qkv
projection need no copy.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .nvcc_build import load_library

SUPPORTED_HEAD_DIMS = (32, 48, 64)
_MAX_GRID_YZ = 65535  # heads and batch are the kernels' grid y and z

# launches, counted where each kernel is launched and nowhere else
launches = {"forward": 0, "forward_bf16": 0, "backward_dq": 0,
            "backward_dkv": 0, "backward_dq_bf16": 0, "backward_dkv_bf16": 0,
            "split_bf16x3": 0}
SPLIT_PARTS = 3  # bf16 parts of a float32 operand in the kernels
_sm90_lib = None
_sm90_bwd_lib = None


def build_sm90_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the tensor-core forward
    kernels (bfloat16, and float32 as split bf16 parts) and the split of
    the forward's and the backward's float32 operands."""
    global _sm90_lib
    if _sm90_lib is None:
        lib = load_library("flash_attention_sm90.cu")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o, lse, n, h, lq, lk, d, [strides,] scale, stream;
        # float32 takes the split planes, which are contiguous, and no
        # strides
        head = [ptr] * 5 + [i32] * 5
        lib.flash_attention_forward_sm90_bf16.argtypes = head + [ptr, f32,
                                                                 ptr]
        lib.flash_attention_forward_sm90_f32.argtypes = head + [f32, ptr]
        # operand count, operands, their planes, lengths, n, h, d,
        # strides, stream
        lib.split_bf16x3_f32.argtypes = [i32, ptr, ptr, ptr] + [i32] * 3 + [
            ptr, ptr]
        for fn in (lib.flash_attention_forward_sm90_bf16,
                   lib.flash_attention_forward_sm90_f32,
                   lib.split_bf16x3_f32):
            fn.restype = i32
        lib.flash_attention_sm90_error_string.argtypes = [i32]
        lib.flash_attention_sm90_error_string.restype = ctypes.c_char_p
        _sm90_lib = lib
    return _sm90_lib


def build_sm90_backward_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the tensor-core dQ and dK/dV
    kernels (bfloat16, and float32 as split bf16 parts)."""
    global _sm90_bwd_lib
    if _sm90_bwd_lib is None:
        lib = load_library("flash_attention_bwd_sm90.cu")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, dO, lse, delta, outputs..., n, h, lq, lk, d, [strides,]
        # scale, stream; float32 takes the split planes, which are
        # contiguous, and no strides
        for name, outs in (("dq", 1), ("dkv", 2)):
            head = [ptr] * (6 + outs) + [i32] * 5
            bf16 = getattr(lib, f"flash_attention_backward_{name}_sm90_bf16")
            bf16.argtypes = head + [ptr, f32, ptr]
            f32_entry = getattr(lib,
                                f"flash_attention_backward_{name}_sm90_f32")
            f32_entry.argtypes = head + [f32, ptr]
            bf16.restype = f32_entry.restype = i32
        lib.flash_attention_backward_sm90_error_string.argtypes = [i32]
        lib.flash_attention_backward_sm90_error_string.restype = \
            ctypes.c_char_p
        _sm90_bwd_lib = lib
    return _sm90_bwd_lib


# ------------------------------------------------------------ plain versions
def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Einsum, float32 softmax, cast to v's dtype, einsum; outside any
    autocast region, which would round the float32 scores to bf16."""
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.einsum("nlhd,nshd->nhls", q.float(), k.float()) * scale
        attn = torch.softmax(scores, dim=-1)
        o = torch.einsum("nhls,nshd->nlhd", attn.to(v.dtype), v)
        return o, torch.logsumexp(scores, dim=-1)


def attention_backward_plain(q, k, v, do, lse, delta, scale):
    """``(dq, dk, dv)`` with the TPU backward kernels' arithmetic, whole:
    P from the saved lse, products in float32, P cast to dO's dtype for
    dV and dS to k's (q's) dtype for dQ (dK); outside any autocast
    region."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, dof = q.float(), k.float(), do.float()
        p = torch.exp(torch.einsum("nlhd,nshd->nhls", qf, kf) * scale
                      - lse[..., None])
        dp = torch.einsum("nlhd,nshd->nhls", dof, v.float())
        ds = p * (dp - delta[..., None]) * scale
        dq = torch.einsum("nhls,nshd->nlhd", ds.to(k.dtype).float(), kf)
        dk = torch.einsum("nhls,nlhd->nshd", ds.to(q.dtype).float(), qf)
        dv = torch.einsum("nhls,nlhd->nshd", p.to(do.dtype).float(), dof)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def split_bf16x3_plain(x: torch.Tensor) -> torch.Tensor:
    """``(3, *x.shape)`` contiguous bf16 parts hi, mid, lo of a float32
    ``x``: each part is the bf16 rounding of what the parts before it leave,
    so ``hi + mid + lo == x`` exactly for normal float32 values (8 + 8 + 8
    significant bits; each subtraction is exact)."""
    parts, rest = [], x.float()
    for _ in range(SPLIT_PARTS):
        parts.append(rest.to(torch.bfloat16))
        rest = rest - parts[-1].float()
    return torch.stack(parts)


def backward_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO·O)`` in float32, ``(N, h, Lq)`` like lse."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# ------------------------------------------------------------ wrappers
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


def _check_kernel_inputs(*tensors):
    """What the CUDA kernels take beyond ``_check``."""
    n, _, h, d = tensors[0].shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} is not supported by the kernel; "
                         f"supported: {SUPPORTED_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the kernel needs a contiguous head dim")
    if n > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {n} or heads {h} above {_MAX_GRID_YZ}")


def _check_row_alignment(*tensors):
    """The bf16 kernels copy 16-byte chunks: every (batch, position,
    head) row must start on 16 bytes."""
    for t in tensors:
        if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in (0, 1, 2)):
            raise ValueError(
                f"the bf16 kernel needs rows on 16 bytes: strides "
                f"{t.stride()} (multiples of 8) from a 16-byte aligned "
                f"pointer")


def _strides(*tensors):
    """(batch, position, head) element strides of each tensor, flat."""
    flat = [t.stride(i) for t in tensors for i in (0, 1, 2)]
    return (ctypes.c_int64 * len(flat))(*flat)


def _launch(fn, error_string, q, args):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: "
                           f"{error_string(err).decode()}")


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    _check_kernel_inputs(q, k, v)
    n, lq, h, d = q.shape
    lk = k.shape[1]
    o = torch.empty((n, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, lq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = build_sm90_library()
    if q.dtype == torch.float32:
        # the planes live until the kernel has read them; the backward
        # splits anew
        planes = split_bf16x3(q, k, v)
        _launch(lib.flash_attention_forward_sm90_f32,
                lib.flash_attention_sm90_error_string, q,
                (*(t.data_ptr() for t in planes), o.data_ptr(),
                 lse.data_ptr(), n, h, lq, lk, d, float(scale)))
        launches["forward"] += 1
        return o, lse
    _check_row_alignment(q, k, v)
    _launch(lib.flash_attention_forward_sm90_bf16,
            lib.flash_attention_sm90_error_string, q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), n, h, lq, lk, d, _strides(q, k, v),
             float(scale)))
    launches["forward_bf16"] += 1
    return o, lse


class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` with a backward through the dQ and dK/dV kernels; lse
    carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, o, lse, do, ctx.scale),
                None)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of softmax attention; see the module docstring."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


def _check_backward(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != rows or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {rows} "
                             f"tensor on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype}")


def split_bf16x3(q, k, v, do=None):
    """The bf16 parts of float32 q, k, v and (for the backward) dO, each
    ``(3, *t.shape)`` contiguous as ``split_bf16x3_plain`` gives them: one
    launch of the split kernel for all of them (the forward's library holds
    it)."""
    _check(q, k, v)
    operands = (q, k, v) if do is None else (q, k, v, do)
    if q.dtype != torch.float32 or (do is not None and (
            do.shape, do.dtype, do.device) != (q.shape, q.dtype, q.device)):
        raise ValueError(f"the split takes float32 q, k, v and a dO like q, "
                         f"got {q.dtype} q {tuple(q.shape)} and dO "
                         f"{None if do is None else (do.dtype, do.shape)}")
    if q.device.type == "cpu":
        return [split_bf16x3_plain(t) for t in operands]
    _check_kernel_inputs(*operands)
    if q.numel() >= 2 ** 31 or k.numel() >= 2 ** 31:
        raise ValueError("the split kernel indexes rows with 32-bit ints")
    planes = [torch.empty((SPLIT_PARTS, *t.shape), dtype=torch.bfloat16,
                          device=t.device) for t in operands]
    if k.numel() == 0:  # (and so q, which shares N, h and d)
        return planes
    n, lq, h, d = q.shape
    lens = (lq, k.shape[1], k.shape[1], lq)[:len(operands)]
    ptrs = [(ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
            for ts in (operands, planes)]
    lib = build_sm90_library()
    _launch(lib.split_bf16x3_f32, lib.flash_attention_sm90_error_string, q,
            (len(operands), *ptrs, (ctypes.c_int * len(lens))(*lens), n, h,
             d, _strides(*operands)))
    launches["split_bf16x3"] += 1
    return planes


def _kernel_args(q, k, v, do, planes):
    """The operand pointers and strides of a backward launch: bf16 inputs as
    they are, float32 ones as their split planes (``planes``, or made
    here), which are contiguous and need no strides."""
    if q.dtype == torch.bfloat16:
        _check_row_alignment(q, k, v, do)
        return [t.data_ptr() for t in (q, k, v, do)], (_strides(q, k, v, do),)
    if planes is None:
        planes = split_bf16x3(q, k, v, do)
    return [t.data_ptr() for t in planes], ()


def flash_attention_backward_dq(q, k, v, do, lse, delta, scale, planes=None):
    """dQ ``(N, Lq, h, d)`` in q's dtype, from the dQ kernel; for float32,
    ``planes`` are ``split_bf16x3(q, k, v, do)`` where the caller has them
    (else they are made here)."""
    _check_backward(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, do, lse, delta, scale)[0]
    _check_kernel_inputs(q, k, v, do)
    n, lq, h, d = q.shape
    dq = torch.empty((n, lq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    operands, strides = _kernel_args(q, k, v, do, planes)
    args = (*operands, lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), n, h,
            lq, k.shape[1], d, *strides, float(scale))
    lib = build_sm90_backward_library()
    if q.dtype == torch.float32:
        _launch(lib.flash_attention_backward_dq_sm90_f32,
                lib.flash_attention_backward_sm90_error_string, q, args)
        launches["backward_dq"] += 1
    else:
        _launch(lib.flash_attention_backward_dq_sm90_bf16,
                lib.flash_attention_backward_sm90_error_string, q, args)
        launches["backward_dq_bf16"] += 1
    return dq


def flash_attention_backward_dkv(q, k, v, do, lse, delta, scale,
                                 planes=None):
    """``(dK, dV)``, each ``(N, Lk, h, d)`` in k's dtype, from the dK/dV
    kernel; ``planes`` as for ``flash_attention_backward_dq``."""
    _check_backward(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, do, lse, delta, scale)[1:]
    _check_kernel_inputs(q, k, v, do)
    n, lq, h, d = q.shape
    lk = k.shape[1]
    dk = torch.empty((n, lk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    operands, strides = _kernel_args(q, k, v, do, planes)
    args = (*operands, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), n, h, lq, lk, d, *strides, float(scale))
    lib = build_sm90_backward_library()
    if q.dtype == torch.float32:
        _launch(lib.flash_attention_backward_dkv_sm90_f32,
                lib.flash_attention_backward_sm90_error_string, q, args)
        launches["backward_dkv"] += 1
    else:
        _launch(lib.flash_attention_backward_dkv_sm90_bf16,
                lib.flash_attention_backward_sm90_error_string, q, args)
        launches["backward_dkv_bf16"] += 1
    return dk, dv


def flash_attention_backward(q, k, v, o, lse, do, scale):
    """``(dq, dk, dv)`` of ``flash_attention_forward``'s ``o`` for the
    output gradient ``do``: delta in plain torch, for float32 on the card
    the split of q, k, v and dO once for both kernels, then both
    kernels."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = backward_delta(o, do)
    planes = None
    if q.device.type == "cuda" and q.dtype == torch.float32:
        _check_backward(q, k, v, do, lse, delta)
        planes = split_bf16x3(q, k, v, do)
    dq = flash_attention_backward_dq(q, k, v, do, lse, delta, scale, planes)
    return (dq, *flash_attention_backward_dkv(q, k, v, do, lse, delta,
                                              scale, planes))
