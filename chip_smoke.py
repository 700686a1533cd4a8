"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``, and imports no JAX.  Phases, each
printing its own lines; any failure raises and the exit code is not 0:

1. device: the card's name and power limit;
2. build: compile the four kernel libraries from ``csrc/`` (confusion,
   flash-attention forward in float32 and in bf16, flash-attention
   backward on the tensor cores in bf16 and in float32 with its split),
   one ``nvcc`` each, in parallel; count the tensor-core instructions
   (HGMMA, HMMA) in the bf16 forward's and the backward's SASS, which must
   not be 0, and read each backward kernel's registers, stack, shared and
   local memory (``cuobjdump -res-usage``): the twelve backward kernels
   (dQ and dK/dV, bf16 and float32, d = 32/48/64) and the split must all
   be there, with stack and local memory 0, so nothing spills;
3. confusion kernel: against its plain PyTorch version (exact equality) at
   the eval batches of both slices, at a Cityscapes-sized batch in float32
   and bfloat16, and at a ragged shape with ignored and out-of-range labels;
4. flash-attention forward kernels (float32 on the CUDA cores, bfloat16
   on the tensor cores): against their plain version at SETR ViT-S/16's
   shape at 640² and at SegFormer-B0 stage 1's ``Lq != Lk`` shape (each in
   float32 and bfloat16) and at a ragged small shape, with q, k and v strided
   views of a fused projection as the models pass them; beside it
   ``F.scaled_dot_product_attention`` as a yardstick (never on the path);
5. DeepLabV3 slice: full-width DeepLabV3-R50-d8 through ``init_model`` and
   ``inference_model`` (whole and slide inference) on four synthetic 512²
   images, then ``SegEvaluator`` on the logits; the confusion kernel's
   launch counts over this phase show that the evaluator went through it;
   then the device time per kernel of one batch of each from
   ``torch.profiler``;
6. SETR slice: full-width SETR-PUP ViT-S/16 through ``init_model``,
   ``inference_model`` (whole) and ``SegEvaluator`` on eight synthetic 640²
   images; exactly 12 flash launches per forward (one per layer), and the
   device time per kernel of one batch from ``torch.profiler``;
7. cpu agreement: one 320² window of each model, on the CPU and the card;
   then SETR serving under the kvasir schedule's ``amp=True`` (the bf16
   policy): 8 forwards with exactly 12 launches of the bf16 kernel each,
   the evaluator on bf16 logits, the logits against the same bf16 forward
   with plain attention, and the share of pixels whose class matches the
   float32 forward;
8. flash-attention backward kernels (dQ, dK/dV, on the tensor cores;
   bfloat16 as it is, float32 split into three bf16 parts by the split
   kernel, which must give the same bits as its plain version): against
   their plain version at SETR ViT-S/16's training shape, the MiT-like
   ``Lq != Lk`` shape, a ragged small shape, Lk = 65 (63 masked keys in
   the last tile) and a d = 48 shape, each in float32 and bfloat16, with
   q, k, v and dO as the model passes them; a second call must give the
   same bits; beside them the backward of
   ``F.scaled_dot_product_attention`` in the same dtype as a yardstick
   (never on the path) and the device time of ``backward_delta`` (the
   kernels' delta = rowsum(dO·O), plain torch);
9. SETR train slice: full-width SETR-PUP ViT-S/16 through ``init_model``,
   ``create_train_state`` and ``make_train_step`` (SGD and StepLR of the
   kvasir schedule, drop path 0.1 from a CUDA generator) for 10 steps on
   one batch of eight synthetic 640² images; exactly 12 launches of each
   flash kernel and of the split per step, finite and falling losses,
   moved parameters and BN statistics, gradients in the aux head; ms per
   step, peak memory and the device time per kernel class of one step
   from ``torch.profiler``;
10. cpu agreement (SETR train step): the full-size config without drop
   path, batch 2 at 320², one train step from the same weights on the card
   (kernels, float32) and on the CPU in float64 (plain versions, attention
   and LayerNorm without their float32 casts): loss, every gradient and
   every parameter after the update;
11. SETR train slice under amp: first one step's gradients from the
   same weights with the kernels and with plain attention on the card, each
   gradient tensor within 0.25 relative norm (the CPU amp test's bound);
   then phase 9's 10 steps under the bf16 policy, with 12 launches of the
   bf16 forward kernel and of each bf16 backward kernel per step and none
   of the float32 ones.

Kernel times: the wrapper's median of 20 calls by CUDA events and the
kernel's own device time from ``torch.profiler`` (for SDPA's forward, of
every kernel it launches), with a 96 MB write between calls so the inputs
come from device memory, not the L2 cache;
``bound_ms`` is the larger of bytes over 3.35 TB/s and operations over the
card's peak for their type (67 TFLOP/s float32 without tensor cores, 989
TFLOP/s bfloat16); the float32 backward kernels do six bf16 products per
float32 product, so their bound counts six times the bf16 operations at
989 TFLOP/s, and the rows also give float32's operations at 67 TFLOP/s.
The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Models run in float32 with
TF32 off, except in the amp phases.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from image_segmentation_lab_tpu_torch.core.dataset.synthetic import \
    make_synthetic_item
from image_segmentation_lab_tpu_torch.core.evaluation import SegEvaluator
from image_segmentation_lab_tpu_torch.core.fileio import load_python_config
from image_segmentation_lab_tpu_torch.core.inference import (inference_model,
                                                             init_model)
from image_segmentation_lab_tpu_torch.core.mixed_precision import \
    policy_scope
from image_segmentation_lab_tpu_torch.models.backbones import vit
from image_segmentation_lab_tpu_torch.models.basic import LayerNorm
from image_segmentation_lab_tpu_torch.ops import confusion, flash_attention
from image_segmentation_lab_tpu_torch.train_state import (create_train_state,
                                                          make_train_step)

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs/network/deeplabv3/deeplabv3_r50-d8.py"
SETR_CONFIG = ROOT / "configs/network/setr/setr_pup_vit-s.py"
VAL_TRANSFORM = ROOT / "configs/augmentation/kvasir_val_transform.yaml"
BATCH, IMAGE_SIZE = 4, 512
SETR_BATCH, SETR_IMAGE_SIZE, SETR_LAYERS = 8, 640, 12
SLIDE = dict(mode="slide", crop_size=(320, 320), stride=(192, 192))
KERNEL_SHAPES = [  # (N, C, H, W), num_classes, dtype
    ((8, 2, 512, 512), 2, torch.float32),
    ((8, 2, 640, 640), 2, torch.float32),      # the SETR slice's evaluator
    ((2, 19, 1024, 2048), 19, torch.float32),
    ((2, 19, 1024, 2048), 19, torch.bfloat16),
    ((3, 5, 97, 131), 5, torch.float32),
]
FLASH_SHAPES = [  # (N, h, Lq, Lk, d), dtype
    ((8, 6, 1601, 1601, 64), torch.float32),   # SETR ViT-S/16, 640², b8
    ((8, 6, 1601, 1601, 64), torch.bfloat16),  # the same under amp
    ((8, 1, 25600, 400, 32), torch.float32),   # SegFormer-B0 stage 1, 640²
    ((8, 1, 25600, 400, 32), torch.bfloat16),
    ((3, 1, 130, 130, 64), torch.float32),     # ragged, small
]
# the device kernel behind each dtype of the forward wrapper
FLASH_FWD_KERNEL = {torch.float32: "flash_fwd_kernel",
                    torch.bfloat16: "flash_fwd_sm90_kernel"}
# the device kernels (dQ, dK/dV) behind each dtype of the backward wrappers
FLASH_BWD_KERNEL = {
    torch.float32: ("flash_bwd_dq_bf16x3_kernel",
                    "flash_bwd_dkv_bf16x3_kernel"),
    torch.bfloat16: ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")}
# bf16 products per float32 product in the float32 backward kernels (the
# parts i + j <= 2 of three-part operands)
SPLIT_PRODUCTS = 6
# tests/test_flash_attention.py's tolerances against the plain version
FLASH_TOL = {torch.float32: (2e-6, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
IGNORE = 255
RTOL, ATOL = 1e-3, 3e-3  # the slice tolerance of tests/test_torch_port_slice
FLASH_BWD_SHAPES = [  # (N, h, Lq, Lk, d), dtype
    ((8, 6, 1601, 1601, 64), torch.float32),   # SETR ViT-S/16 train, 640², b8
    ((8, 6, 1601, 1601, 64), torch.bfloat16),  # the same under amp
    ((8, 1, 25600, 400, 32), torch.float32),   # MiT-like, Lq != Lk
    ((8, 1, 25600, 400, 32), torch.bfloat16),
    ((3, 1, 130, 130, 64), torch.float32),     # ragged, small
    ((3, 1, 130, 130, 64), torch.bfloat16),
    ((2, 3, 63, 65, 32), torch.float32),       # 63 masked keys in the last tile
    ((2, 3, 63, 65, 32), torch.bfloat16),
    ((1, 2, 300, 300, 48), torch.float32),     # d = 48
    ((1, 2, 300, 300, 48), torch.bfloat16),
]
SCHEDULE = ROOT / "configs/schedule/kvasir_training_schedule.py"
TRAIN_BATCH, TRAIN_IMAGE_SIZE, TRAIN_STEPS = 8, 640, 10
AGREE_BATCH, AGREE_IMAGE_SIZE = 2, 320
# per gradient tensor, against the step in float64 on the CPU: max |card -
# reference| <= GRAD_RTOL * max |reference| + GRAD_ATOL.  The card's float32
# gradients measured at most 1.13e-3 of max |g| off float64, with the flash
# kernels or with plain attention alike (PERF.md, Findings).  The parameters
# after the update get GRAD_RTOL of the largest update plus one float32
# rounding step of the largest parameter, which the card stores.
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-6
# the amp serving logits against the same bf16 forward with plain
# attention on the card: the two differ by the rounding of each layer's
# attention output to bf16 (kernel and plain version sum in other orders),
# carried through 12 layers of bf16 compute.  As the CPU test of the bf16
# policy against the JAX package: within 2**-4 of the largest |logit|, the
# same class at 98 % of the pixels
AMP_LOGIT_SHARE, AMP_ARGMAX_AGREE = 2.0 ** -4, 0.98
# one amp train step's gradients with the kernels against the same step
# with plain attention: per tensor, |g - g_plain| / |g_plain| (Frobenius)
# at most the CPU amp test's bound
AMP_GRAD_SHARE = 0.25
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def flash_bwd_tol(dtype, ref):
    """(atol, rtol) of a backward kernel's output against the plain
    version's ``ref``: in float32 tests/test_flash_attention.py's gradient
    tolerance; in bfloat16 one rounding step of the value (2**-7 of it)
    plus 1e-3 of the tensor's largest value."""
    if dtype == torch.float32:
        return 2e-5, 1e-4
    return 1e-3 * float(ref.float().abs().max()), 2.0 ** -7


def cuda_ms(fn, flush=None, warmup=3, runs=20):
    """Median milliseconds of ``fn()`` by CUDA events; ``flush()`` runs
    untimed before each call so the input comes from device memory, not
    the L2 cache."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_times(fn, flush=None, runs=1):
    """Device milliseconds per run of every CUDA kernel ``fn()`` launches,
    from ``torch.profiler`` (kernel name -> ms), and the wall milliseconds
    per run under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    times = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            times[evt.key] = evt.self_device_time_total / 1e3 / runs
    return times, wall


def device_ms(fn, kernel, flush, runs=20, attempts=3):
    """The device time of one call of ``fn``: of the kernel whose name
    contains ``kernel`` or, with ``kernel=None``, of every kernel but the
    flush's fill (of bytes), with ``flush()`` before each call.  A profile
    that holds no device activity at all (the profiler now and then returns
    an empty trace) is taken again, up to ``attempts`` times."""
    for _ in range(attempts):
        times, _ = kernel_times(fn, flush, runs)
        if times:
            break
    hits = [ms for name, ms in times.items()
            if (kernel in name if kernel
                else "FillFunctor<unsigned char>" not in name)]
    if not hits:
        raise AssertionError(f"the profiler saw no {kernel} kernel: "
                             f"{sorted(times)}")
    return sum(hits)


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_count_err(out, ref):
    return max(float((a - b).abs().max()) if a.numel() else 0.0
               for a, b in zip(out, ref))


def kernel_phase(device, l2_flush):
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for (n, c, h, w), num_classes, dtype in KERNEL_SHAPES:
        logits = torch.randn((n, c, h, w), generator=gen, device=device,
                             dtype=dtype)
        gt = torch.randint(-1, num_classes + 2, (n, h, w), generator=gen,
                           device=device, dtype=torch.int32)
        gt[torch.rand((n, h, w), generator=gen, device=device) < 0.1] = IGNORE
        args = (logits, gt, num_classes, IGNORE)
        err = max_count_err(confusion.confusion_histograms(*args),
                            confusion.histograms_plain(*args))
        pred = torch.argmax(logits, dim=1).to(torch.int32)
        label_args = (pred, gt, num_classes, IGNORE)
        label_err = max_count_err(
            confusion.confusion_histograms_from_labels(*label_args),
            confusion.histograms_from_labels_plain(*label_args))
        torch.cuda.synchronize()
        if err != 0 or label_err != 0:
            raise AssertionError(
                f"kernel != plain at {(n, c, h, w)} {dtype}: max count error "
                f"{err} (logits entry), {label_err} (labels entry)")
        flush = l2_flush.zero_
        counts_bytes = gt.numel() * 4 + 3 * num_classes * 4
        bound, bound_by = bound_ms(
            logits.numel() * logits.element_size() + counts_bytes,
            logits.numel(), PEAK_FLOPS[torch.float32])
        labels_bound, _ = bound_ms(pred.numel() * 4 + counts_bytes, 0,
                                   PEAK_FLOPS[torch.float32])
        row = dict(shape=[n, c, h, w], dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, labels_max_abs_err=label_err,
                   ms=cuda_ms(lambda: confusion.confusion_histograms(*args),
                              flush),
                   device_ms=device_ms(
                       lambda: confusion.confusion_histograms(*args),
                       "confusion_kernel", flush),
                   plain_ms=cuda_ms(lambda: confusion.histograms_plain(*args),
                                    flush),
                   labels_ms=cuda_ms(
                       lambda: confusion.confusion_histograms_from_labels(
                           *label_args), flush),
                   labels_device_ms=device_ms(
                       lambda: confusion.confusion_histograms_from_labels(
                           *label_args), "confusion_kernel", flush),
                   labels_plain_ms=cuda_ms(
                       lambda: confusion.histograms_from_labels_plain(
                           *label_args), flush),
                   bound_ms=bound, bound_by=bound_by,
                   labels_bound_ms=labels_bound)
        print("kernel:", json.dumps(row), flush=True)
        rows.append(row)
        del logits, gt, pred, args, label_args
    return rows


def projection_views(gen, device, dtype, n, h, lq, lk, d):
    """q, k and v as the models pass them: strided (N, L, h, d) views of one
    fused qkv projection (the ViT) when ``Lq == Lk``, else q alone and k, v
    views of one fused kv projection (SegFormer's spatial-reduction
    attention)."""
    def proj(length, parts):
        x = torch.randn((n, length, parts * h * d), generator=gen,
                        device=device).to(dtype)
        return [t.unflatten(-1, (h, d)) for t in x.split(h * d, dim=-1)]
    if lq == lk:
        return proj(lq, 3)
    return proj(lq, 1) + proj(lk, 2)


def tensor_core_instructions(lib):
    """Counts of warpgroup (HGMMA) and warp (HMMA) tensor-core
    instructions in a built library's SASS, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    return {"HGMMA": len(re.findall(r"\bHGMMA\.", sass)),
            "HMMA": len(re.findall(r"\bHMMA\.", sass))}


def kernel_name(mangled):
    """``kernel<64>`` (a kernel template's instance at one int) or
    ``kernel`` from a mangled name ``_Z[N]<len><scope>...<len><name>``
    with ``ILi64E`` after the name of a template."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (size := re.match(r"\d+", mangled[pos:])) is not None:
        pos += len(size[0])
        name = mangled[pos:pos + int(size[0])]
        pos += int(size[0])
    arg = re.match(r"ILi(\d+)E", mangled[pos:])
    return f"{name}<{arg[1]}>" if arg else name


def resource_usage(lib):
    """Registers, stack, static shared memory and local memory (bytes;
    stack and local memory above 0 when registers spill) of each kernel in
    a built library, from ``cuobjdump -res-usage``: kernel name ->
    {"REG": n, "STACK": n, "SHARED": n, "LOCAL": n}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", lib._name], capture_output=True,
                         text=True, check=True).stdout
    usage = {}
    for name, fields in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", out):
        usage[kernel_name(name)] = {
            key: int(val) for key, val in
            re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", fields)}
    return usage


def flash_phase(device, l2_flush):
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for (n, h, lq, lk, d), dtype in FLASH_SHAPES:
        q, k, v = projection_views(gen, device, dtype, n, h, lq, lk, d)
        scale = 1.0 / math.sqrt(d)
        args = (q, k, v, scale)
        o, lse = flash_attention.flash_attention_forward(*args)
        ref_o, ref_lse = flash_attention.attention_plain(*args)
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[dtype]
        o_err = float((o.float() - ref_o.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        within = bool(((o.float() - ref_o.float()).abs()
                       <= atol + rtol * ref_o.float().abs()).all()
                      and ((lse - ref_lse).abs()
                           <= 2e-6 + 1e-5 * ref_lse.abs()).all())
        if not within:
            raise AssertionError(
                f"flash kernel != plain at {(n, h, lq, lk, d)} {dtype}: max "
                f"abs error {o_err} (o), {lse_err} (lse)")
        del o, lse, ref_o, ref_lse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (N, h, L, d)
        flush = l2_flush.zero_
        n_bytes = (q.element_size() * d * n * h * (2 * lq + 2 * lk)
                   + 4 * n * h * lq)
        bound, bound_by = bound_ms(n_bytes, 4.0 * n * h * lq * lk * d,
                                   PEAK_FLOPS[dtype])
        row = dict(
            shape=[n, h, lq, lk, d], dtype=str(dtype).replace("torch.", ""),
            max_abs_err=o_err, lse_max_abs_err=lse_err,
            ms=cuda_ms(lambda: flash_attention.flash_attention_forward(*args),
                       flush),
            device_ms=device_ms(
                lambda: flash_attention.flash_attention_forward(*args),
                FLASH_FWD_KERNEL[dtype], flush),
            plain_ms=cuda_ms(lambda: flash_attention.attention_plain(*args),
                             flush),
            sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale), flush),
            sdpa_device_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale), None, flush),
            bound_ms=bound, bound_by=bound_by)
        print("flash kernel:", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, qt, kt, vt, args
    return rows


def normalize_constants():
    """mean/std of the Kvasir val transform (PyYAML is not required)."""
    text = VAL_TRANSFORM.read_text()

    def vec(key):
        match = re.search(rf"^\s*{key}:\s*\[([^\]]+)\]", text, re.M)
        return [float(v) for v in match.group(1).split(",")]

    scale = float(re.search(r"max_pixel_value:\s*([\d.]+)", text).group(1))
    return vec("mean"), vec("std"), scale


def synthetic_batch(device, batch, size):
    """Normalised NHWC images (the ``inference_model`` input), the same as
    NCHW, and the int32 masks."""
    items = [make_synthetic_item(i, (size, size)) for i in range(batch)]
    images = np.stack([im for im, _ in items])
    masks = np.stack([m for _, m in items]).astype(np.int32)
    mean, std, scale = normalize_constants()
    x = torch.from_numpy(images).to(device).float() / scale
    x = (x - torch.tensor(mean, device=device)) / torch.tensor(std,
                                                                device=device)
    return x, x.permute(0, 3, 1, 2).contiguous(), masks


def randomize_(model, seed):
    """Seeded weights under which every layer counts: the default init
    zeroes each block's last norm, the classifier's std 0.01 leaves logits
    near 0, and the ViT's std 0.02 linears leave attention near uniform.
    Norm affines and statistics are drawn at random, linear weights are
    N(0, 1/fan_in) and the classifiers get unit gain, so logits are of
    order one."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t, lo, hi):
        t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=gen))

    def unit_gain(w):
        w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w[0].numel()))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                fill(m.weight, 0.4, 0.8)
                fill(m.bias, -0.1, 0.1)
                fill(m.running_mean, -0.1, 0.1)
                fill(m.running_var, 0.5, 1.5)
            elif isinstance(m, torch.nn.LayerNorm):
                fill(m.weight, 0.5, 1.5)
                fill(m.bias, -0.1, 0.1)
            elif isinstance(m, torch.nn.Linear):
                unit_gain(m.weight)
                fill(m.bias, -0.1, 0.1)
        for head in (model.decode_head, model.auxiliary_head):
            unit_gain(head.conv_seg.weight)


def timed_batches(fn, runs=5):
    fn()  # warm-up: cuDNN picks its algorithms
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_metrics(metrics):
    for head, values in metrics.items():
        for key, val in values.items():
            arr = np.asarray(val, np.float64)
            bad = ~np.isnan(arr) & ((arr < 0) | (arr > 100))
            if bad.any():
                raise AssertionError(f"{head}.{key} out of [0, 100]: {val}")


def new_evaluator():
    return SegEvaluator(epoch=0, num_classes=2,
                        class_names=["background", "object"],
                        palette=[[0, 0, 0], [0, 63, 255]], show_result=False)


def summarize(metrics):
    return {mode: {k: float(metrics[mode][k]) for k in
                   ("aAcc", "mIoU", "mDice", "mFscore")} for mode in metrics}


def check_class_map(pred, shape, what):
    if pred.shape != shape or not np.isin(pred, (0, 1)).all():
        raise AssertionError(f"{what}: bad class map {pred.shape}")


def reset_counts():
    for counts in (flash_attention.launches, confusion.launches):
        for key in counts:
            counts[key] = 0


def slice_phase(device):
    model = init_model(CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("the flagship's aux head is missing")
    randomize_(model, seed=0)
    x, x_nchw, masks = synthetic_batch(device, BATCH, IMAGE_SIZE)

    reset_counts()
    latency = {}
    evaluator = new_evaluator()
    with torch.no_grad():
        for mode, test_cfg in (("whole", dict(mode="whole")),
                               ("slide", SLIDE)):
            model.test_cfg = test_cfg
            check_class_map(inference_model(model, x),
                            (BATCH, IMAGE_SIZE, IMAGE_SIZE), mode)
            latency[mode] = timed_batches(lambda: inference_model(model, x))
            probs = model.inference(x_nchw)
            if not bool(torch.isfinite(probs).all()):
                raise AssertionError(f"{mode}: non-finite output")
            evaluator.process(0, {mode: probs}, {"ori_gt": masks})
    torch.cuda.synchronize()
    launches = dict(confusion.launches)
    metrics = evaluator.compute_metrics()
    check_metrics(metrics)
    if launches["logits"] == 0:
        raise AssertionError("the evaluator never launched the kernel")
    print("slice: " + json.dumps(dict(
        batch=list(x_nchw.shape), ms_per_batch=latency, launches=launches,
        metrics=summarize(metrics))), flush=True)
    for mode, test_cfg in (("whole", dict(mode="whole")), ("slide", SLIDE)):
        model.test_cfg = test_cfg
        print_breakdown(f"deeplabv3 {mode}", lambda: model.inference(x_nchw))
    return model, x_nchw, launches


def kernel_class(name):
    """Coarse class of a CUDA kernel name for the time breakdown."""
    low = name.lower()
    for key, words in (("flash fwd", ("flash_fwd_kernel",)),
                       ("flash fwd bf16", ("flash_fwd_sm90_kernel",)),
                       ("flash dq", ("flash_bwd_dq_bf16x3_kernel",)),
                       ("flash dkv", ("flash_bwd_dkv_bf16x3_kernel",)),
                       ("flash split", ("split_bf16x3_kernel",)),
                       ("flash dq bf16", ("flash_bwd_dq_sm90_kernel",)),
                       ("flash dkv bf16", ("flash_bwd_dkv_sm90_kernel",)),
                       ("confusion", ("confusion_kernel",)),
                       ("batch norm", ("batch_norm", "bn_")),
                       # cuDNN's implicit-GEMM and FFT convolutions (the
                       # latter multiply in complex float, cf32 GEMMs),
                       # with their data- and weight-gradient kernels
                       ("conv", ("conv", "fprop", "dgrad", "wgrad", "fft",
                                 "flip_filter", "cf32",
                                 "pointwise_mult_and_sum_complex")),
                       # (cuBLAS's bf16 GEMMs on Hopper are nvjet_*)
                       ("matmul", ("gemm", "cutlass", "xmma", "splitk",
                                   "nvjet")),
                       ("layer norm", ("layer_norm",)),
                       ("upsample", ("upsample",)),
                       ("softmax", ("softmax",)),
                       ("optimizer", ("multi_tensor_apply", "foreach")),
                       ("reduction", ("reduce_kernel",)),
                       ("elementwise", ("elementwise",))):
        if any(w in low for w in words):
            return key
    return "other"


def print_breakdown(what, fn):
    """Device time per kernel class of one ``fn()`` under the profiler."""
    with torch.no_grad():
        times, wall = kernel_times(fn)
    busy = sum(times.values())
    classes = {}
    for name, ms in times.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0) + ms
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    print(f"{what} breakdown: " + json.dumps(dict(
        wall_ms=wall, device_ms=busy, busy_share=busy / wall,
        by_class=dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        top_kernels=[[name[:90], ms] for name, ms in top])), flush=True)


def serve_setr(model, amp):
    """SETR serving under the float32 or (``amp``) the bf16 policy: 8
    forwards through ``inference_model``, ``model.inference`` and
    ``SegEvaluator``, with exactly 12 launches per forward of the policy's
    flash forward kernel and none of the other one.  The batch, the
    latency, the launches and the metrics."""
    x, x_nchw, masks = synthetic_batch(next(model.parameters()).device,
                                       SETR_BATCH, SETR_IMAGE_SIZE)
    shape = (SETR_BATCH, SETR_IMAGE_SIZE, SETR_IMAGE_SIZE)
    dtype = torch.bfloat16 if amp else torch.float32
    forwards = 0

    def serve():
        nonlocal forwards
        forwards += 1
        return inference_model(model, x)

    reset_counts()
    evaluator = new_evaluator()
    with torch.no_grad(), policy_scope("bf16" if amp else "fp32"):
        check_class_map(serve(), shape, f"setr whole, {dtype}")
        latency = timed_batches(serve)
        forwards += 1
        probs = model.inference(x_nchw)
        if probs.dtype != dtype or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"setr: {probs.dtype} output, or not "
                                 f"finite")
        evaluator.process(0, {"whole": probs}, {"ori_gt": masks})
    torch.cuda.synchronize()
    flash, other = (flash_attention.launches[k] for k in
                    (("forward_bf16", "forward") if amp
                     else ("forward", "forward_bf16")))
    launches = dict(flash=flash, confusion=confusion.launches["logits"])
    metrics = evaluator.compute_metrics()
    check_metrics(metrics)
    if flash != SETR_LAYERS * forwards or other != 0:
        raise AssertionError(f"{flash} flash launches ({other} of the other "
                             f"forward kernel) for {forwards} forwards of "
                             f"{SETR_LAYERS} layers, {dtype}")
    if launches["confusion"] == 0:
        raise AssertionError("the evaluator never launched the kernel")
    return x_nchw, dict(batch=list(x_nchw.shape), ms_per_batch=latency,
                        forwards=forwards, launches=launches,
                        metrics=summarize(metrics))


def setr_slice_phase(device):
    model = init_model(SETR_CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("SETR's aux head is missing")
    if model.backbone.depth != SETR_LAYERS:
        raise AssertionError(f"ViT-S has {model.backbone.depth} layers")
    randomize_(model, seed=0)
    x_nchw, row = serve_setr(model, amp=False)
    print("setr slice: " + json.dumps(row), flush=True)
    print_breakdown("setr", lambda: model.inference(x_nchw))
    return model, x_nchw, row["launches"]


def setr_amp_slice_phase(model):
    """SETR serving under the schedule's bf16 policy (``serve_setr``),
    then its logits against the same bf16 forward with plain attention on
    the card, and the share of pixels whose class matches the float32
    forward."""
    x_nchw, row = serve_setr(model, amp=True)
    plain = functools.partial(vit.multihead_attention, force="plain")
    with torch.no_grad():
        fp32 = model.encode_decode(x_nchw).float()
        with policy_scope("bf16"):
            amp = model.encode_decode(x_nchw).float()
            with mock.patch.object(vit, "multihead_attention", plain):
                ref = model.encode_decode(x_nchw).float()
    scale = float(ref.abs().max())
    err = float((amp - ref).abs().max())
    agree = float((amp.argmax(1) == ref.argmax(1)).float().mean())
    if err > AMP_LOGIT_SHARE * scale or agree < AMP_ARGMAX_AGREE:
        raise AssertionError(f"amp logits vs plain attention: max abs error "
                             f"{err} of max |logit| {scale}, argmax agreement "
                             f"{agree}")
    row.update(vs_plain_attention=dict(max_abs_err=err, max_abs_logit=scale,
                                       argmax_agreement=agree),
               argmax_agreement_with_float32=float(
                   (amp.argmax(1) == fp32.argmax(1)).float().mean()))
    print("setr amp slice: " + json.dumps(row), flush=True)
    with policy_scope("bf16"):
        print_breakdown("setr amp", lambda: model.inference(x_nchw))
    return row["launches"]


def cpu_agreement_phase(model, x_nchw, h, w, what):
    window = x_nchw[:1, :, :h, :w]
    with torch.no_grad():
        gpu = model.encode_decode(window).cpu().numpy()
        cpu = copy.deepcopy(model).cpu().encode_decode(
            window.cpu()).numpy()
    np.testing.assert_allclose(gpu, cpu, rtol=RTOL, atol=ATOL)
    mism = gpu.argmax(1) != cpu.argmax(1)
    if mism.any():  # only genuine ties may differ
        top2 = np.sort(np.moveaxis(cpu, 1, -1)[mism], axis=-1)[:, -2:]
        gap = float((top2[:, 1] - top2[:, 0]).max())
        if mism.mean() >= 1e-4 or gap >= 2 * ATOL:
            raise AssertionError(f"{int(mism.sum())} argmax mismatches, "
                                 f"max top-2 gap {gap}")
    print(f"cpu agreement ({what}): " + json.dumps(dict(
        window=list(window.shape), max_abs_err=float(np.abs(gpu - cpu).max()),
        max_abs_logit=float(np.abs(cpu).max()),
        argmax_mismatches=int(mism.sum()))), flush=True)


def flash_backward_phase(device, l2_flush):
    """dQ and dK/dV kernels against the plain backward on the same inputs,
    and against their own second call (same bits); in float32 the split
    against its plain version (same bits); times of each kernel, the split,
    the plain backward (dQ, dK and dV together), SDPA's backward (the three
    together) and ``backward_delta``."""
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for (n, h, lq, lk, d), dtype in FLASH_BWD_SHAPES:
        q, k, v = projection_views(gen, device, dtype, n, h, lq, lk, d)
        do = torch.randn((n, lq, h, d), generator=gen, device=device).to(
            dtype)
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_attention.flash_attention_forward(q, k, v, scale)
        delta = flash_attention.backward_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        split = dtype == torch.float32
        # the split planes, as flash_attention_backward hands them to both
        # kernels (bf16 takes its inputs as they are)
        planes = flash_attention.split_bf16x3(q, k, v, do) if split else None

        def kernels():
            return (flash_attention.flash_attention_backward_dq(*args,
                                                                planes),
                    *flash_attention.flash_attention_backward_dkv(*args,
                                                                  planes))

        outs = kernels()
        refs = flash_attention.attention_backward_plain(*args)
        repeat = all(torch.equal(a, b) for a, b in zip(outs, kernels()))
        split_exact = not split or all(
            torch.equal(got, flash_attention.split_bf16x3_plain(t))
            for got, t in zip(planes, (q, k, v, do)))
        torch.cuda.synchronize()
        errs, tols = {}, {}
        for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
            atol, rtol = tols[name] = flash_bwd_tol(dtype, ref)
            diff = (out.float() - ref.float()).abs()
            errs[name] = float(diff.max())
            if not bool((diff <= atol + rtol * ref.float().abs()).all()):
                raise AssertionError(
                    f"flash backward kernel != plain at {(n, h, lq, lk, d)} "
                    f"{dtype}: max abs error of {name} {errs[name]}")
        if not repeat:
            raise AssertionError(f"flash backward kernels at "
                                 f"{(n, h, lq, lk, d)} {dtype} gave other "
                                 f"bits on a second call")
        if not split_exact:
            raise AssertionError(f"split kernel != plain at "
                                 f"{(n, h, lq, lk, d)}")
        del outs, refs
        flush = l2_flush.zero_
        size, work = q.element_size() * d * n * h, 2.0 * n * h * lq * lk * d
        rows_bytes = 2 * 4 * n * h * lq  # lse and delta
        # dQ: reads q, k, v, dO, lse, delta, writes dQ; three products.
        # dK/dV: reads q, k, v, dO, lse, delta, writes dK, dV; four
        # products.  Float32 takes six bf16 products per product on the
        # tensor cores (the route taken: the bound), where the CUDA cores
        # would do the float32 products at 67 TFLOP/s
        bounds = {}
        for part, n_bytes, products in (
                ("dq", size * (3 * lq + 2 * lk) + rows_bytes, 3),
                ("dkv", size * (2 * lq + 4 * lk) + rows_bytes, 4)):
            if split:
                bounds[part] = bound_ms(n_bytes, SPLIT_PRODUCTS * products
                                        * work, PEAK_FLOPS[torch.bfloat16])
                bounds[f"{part}_cuda_cores"] = bound_ms(
                    n_bytes, products * work, PEAK_FLOPS[torch.float32])
            else:
                bounds[part] = bound_ms(n_bytes, products * work,
                                        PEAK_FLOPS[dtype])
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        with torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        dot = do.transpose(1, 2)

        def sdpa_backward():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        def dq_call():
            return flash_attention.flash_attention_backward_dq(*args, planes)

        def dkv_call():
            return flash_attention.flash_attention_backward_dkv(*args,
                                                                planes)

        dq_kernel, dkv_kernel = FLASH_BWD_KERNEL[dtype]
        row = dict(
            shape=[n, h, lq, lk, d], dtype=str(dtype).replace("torch.", ""),
            max_abs_err=errs, tolerance=tols, repeats_bit_for_bit=repeat,
            dq_ms=cuda_ms(dq_call, flush),
            dq_device_ms=device_ms(dq_call, dq_kernel, flush),
            dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
            dkv_ms=cuda_ms(dkv_call, flush),
            dkv_device_ms=device_ms(dkv_call, dkv_kernel, flush),
            dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1],
            delta_device_ms=device_ms(
                lambda: flash_attention.backward_delta(o, do), None, flush),
            plain_ms=cuda_ms(
                lambda: flash_attention.attention_backward_plain(*args),
                flush),
            sdpa_backward_ms=cuda_ms(sdpa_backward, flush),
            sdpa_backward_device_ms=device_ms(sdpa_backward, None, flush))
        if split:
            def split_call():
                return flash_attention.split_bf16x3(q, k, v, do)

            def split_plain():
                return [flash_attention.split_bf16x3_plain(t)
                        for t in (q, k, v, do)]

            # reads q, k, v and dO once, writes three bf16 parts of each
            n_split = (4 + 3 * 2) * (q.numel() + k.numel() + v.numel()
                                     + do.numel())
            split_bound = bound_ms(n_split, 0, PEAK_FLOPS[torch.float32])
            row.update(
                split_exact=split_exact, split_ms=cuda_ms(split_call, flush),
                split_device_ms=device_ms(split_call, "split_bf16x3_kernel",
                                          flush),
                split_plain_ms=cuda_ms(split_plain, flush),
                split_bound_ms=split_bound[0],
                split_bound_by=split_bound[1],
                dq_cuda_core_bound_ms=bounds["dq_cuda_cores"][0],
                dkv_cuda_core_bound_ms=bounds["dkv_cuda_cores"][0])
        row["backward_device_ms"] = (row["dq_device_ms"]
                                     + row["dkv_device_ms"]
                                     + row.get("split_device_ms", 0.0)
                                     + row["delta_device_ms"])
        print("flash backward kernels:", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, o, qt, kt, vt, dot, sdpa_out, args, lse, delta
        del planes
    return rows


FLASH_KEYS = {False: ("forward", "backward_dq", "backward_dkv",
                      "split_bf16x3"),
              True: ("forward_bf16", "backward_dq_bf16", "backward_dkv_bf16")}


def flash_counts(amp=False):
    """Launches of the flash kernels (forward, dQ, dK/dV and, in float32,
    the split) of the policy's dtype: float32, or bf16 with ``amp``."""
    return {k: flash_attention.launches[k] for k in FLASH_KEYS[amp]}


def schedule_cfg():
    """The kvasir schedule's optimizer, LR schedule and ``amp`` flag."""
    schedule = load_python_config(SCHEDULE)
    return schedule["optimizer"], schedule["lr_config"], schedule["amp"]


def snapshot(model):
    return {name: t.detach().clone() for name, t in
            list(model.named_parameters()) + list(model.named_buffers())}


def setr_train_phase(device, amp=False):
    """TRAIN_STEPS steps in float32, or under the bf16 policy with
    ``amp``."""
    policy = "bf16" if amp else "fp32"
    model = init_model(SETR_CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("SETR's aux head is missing")
    if model.backbone.depth != SETR_LAYERS:
        raise AssertionError(f"ViT-S has {model.backbone.depth} layers")
    randomize_(model, seed=0)
    optimizer_cfg, lr_config, _ = schedule_cfg()
    state = create_train_state(model, optimizer_cfg, lr_config)
    train_step = make_train_step(state.model, state.optimizer,
                                 state.scheduler)
    _, x, masks = synthetic_batch(device, TRAIN_BATCH, TRAIN_IMAGE_SIZE)
    gt = torch.from_numpy(masks).to(device).long()
    vs_plain = amp_attention_agreement(model, x, gt, device) if amp else None
    generator = torch.Generator(device=device).manual_seed(0)
    before = snapshot(model)

    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    logs, step_ms, per_step, rates = [], [], [], []
    for _ in range(TRAIN_STEPS):
        rates.append(state.optimizer.param_groups[0]["lr"])
        counts = flash_counts(amp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with policy_scope(policy):
            logs.append(train_step(x, gt, generator))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        state.step += 1
        per_step.append({k: v - counts[k]
                         for k, v in flash_counts(amp).items()})
    launches = flash_counts(amp)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    other = {k: flash_attention.launches[k] for k in FLASH_KEYS[not amp]}
    if any(other.values()):
        raise AssertionError(f"{policy} steps launched the other dtype's "
                             f"flash kernels: {other}")

    losses = [{k: float(v) for k, v in log.items()} for log in logs]
    for i, (log, counts) in enumerate(zip(losses, per_step)):
        if any(n != SETR_LAYERS for n in counts.values()):
            raise AssertionError(f"step {i + 1} launched {counts}, not "
                                 f"{SETR_LAYERS} of each flash kernel")
        if not all(math.isfinite(v) for v in log.values()):
            raise AssertionError(f"step {i + 1}: non-finite log {log}")
    if not losses[-1]["loss"] < losses[0]["loss"]:
        raise AssertionError(f"the loss did not fall: "
                             f"{[log['loss'] for log in losses]}")
    after = snapshot(model)
    still = [name for name, t in before.items()
             if not name.endswith("num_batches_tracked")
             and torch.equal(t, after[name])]
    if still:
        raise AssertionError(f"unchanged after {TRAIN_STEPS} steps: {still}")
    aux_grads = [p.grad for p in model.auxiliary_head.parameters()]
    if any(g is None or not bool(g.abs().sum() > 0) for g in aux_grads):
        raise AssertionError("the aux head got no gradient")
    print(f"setr train slice ({policy}): " + json.dumps(dict(
        batch=list(x.shape), steps=TRAIN_STEPS, lr=rates,
        loss=[log["loss"] for log in losses],
        decode_loss_ce=[log["decode.loss_ce"] for log in losses],
        aux_loss_ce=[log["aux.loss_ce"] for log in losses],
        decode_acc_seg=[log["decode.acc_seg"] for log in losses],
        ms_per_step=statistics.median(step_ms[1:]), step_ms=step_ms,
        peak_memory_gb=peak_gb, launches=launches,
        **({} if vs_plain is None else
           {"vs_plain_attention": vs_plain}))), flush=True)
    with policy_scope(policy):
        print_breakdown(f"setr train step ({policy})",
                        lambda: train_step(x, gt, generator))
    return launches


def amp_attention_agreement(model, x, gt, device):
    """One amp train step from ``model``'s weights on copies, with the
    flash kernels and with plain attention; each gradient tensor's
    relative distance (Frobenius) from the plain one, at most
    AMP_GRAD_SHARE.  The worst three."""
    plain = functools.partial(vit.multihead_attention, force="plain")
    grads = []
    for patch in (contextlib.nullcontext(),
                  mock.patch.object(vit, "multihead_attention", plain)):
        copy_ = copy.deepcopy(model)
        counts = flash_counts(amp=True)
        with patch, policy_scope("bf16"):
            one_train_step(copy_, x, gt, device)
        torch.cuda.synchronize()
        launched = {k: v - counts[k]
                    for k, v in flash_counts(amp=True).items()}
        expected = 0 if grads else SETR_LAYERS
        if any(n != expected for n in launched.values()):
            raise AssertionError(f"the amp step launched {launched}")
        grads.append({name: p.grad.float() for name, p in
                      copy_.named_parameters() if p.grad is not None})
        del copy_
    kernel, ref = grads
    if kernel.keys() != ref.keys():
        raise AssertionError("the two amp steps gave gradients to other "
                             "parameters")
    shares = {name: float((kernel[name] - g).norm()
                          / g.norm().clamp_min(1e-30))
              for name, g in ref.items()}
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    if worst[0][1] > AMP_GRAD_SHARE:
        raise AssertionError(f"amp gradients with the kernels vs plain "
                             f"attention: {worst}")
    return dict(tensors=len(shares), worst_relative_distance=worst)


def agreement_inputs():
    """The full-size SETR config without drop path on the CPU, from seeded
    weights, and a batch of AGREE_BATCH synthetic images."""
    network = load_python_config(SETR_CONFIG)["model"]
    network["backbone"]["drop_path_rate"] = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        config = Path(tmp) / "setr_pup_vit-s_no_drop_path.py"
        config.write_text(f"model = {network!r}\n")
        model = init_model(config, device="cpu")
    randomize_(model, seed=1)
    _, x, masks = synthetic_batch("cpu", AGREE_BATCH, AGREE_IMAGE_SIZE)
    return model, x, torch.from_numpy(masks).long()


def one_train_step(model, x, gt, device):
    """One ``make_train_step`` step of ``model`` (already on ``device``)
    with the kvasir schedule; the loss."""
    optimizer_cfg, lr_config, _ = schedule_cfg()
    state = create_train_state(model, optimizer_cfg, lr_config)
    step = make_train_step(state.model, state.optimizer, state.scheduler)
    dtype = next(model.parameters()).dtype
    log = step(x.to(device=device, dtype=dtype), gt.to(device),
               torch.Generator(device=device).manual_seed(0))
    return float(log["loss"])


def attention_in_input_dtype(q, k, v, scale):
    """Plain attention with no float32 cast, for the float64 reference."""
    scores = torch.einsum("nlhd,nshd->nhls", q, k) * scale
    return torch.einsum("nhls,nshd->nlhd", torch.softmax(scores, dim=-1), v)


def layer_norm_in_input_dtype(self, x):
    return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                        self.eps)


def setr_train_agreement_phase(device):
    """One train step from the same weights on the card (the kernels, in
    float32) and on the CPU in float64 (the plain versions; attention and
    LayerNorm without the float32 casts the port shares with the JAX
    package, the losses with theirs)."""
    model, x, gt = agreement_inputs()
    gpu_model = copy.deepcopy(model).to(device)
    before = {k: t.double() for k, t in snapshot(model).items()}
    ref_model = model.double()
    with mock.patch.object(vit, "multihead_attention",
                           attention_in_input_dtype), \
            mock.patch.object(LayerNorm, "forward", layer_norm_in_input_dtype):
        ref_loss = one_train_step(ref_model, x, gt, torch.device("cpu"))
    reset_counts()
    gpu_loss = one_train_step(gpu_model, x, gt, device)
    torch.cuda.synchronize()
    launches = flash_counts()
    if any(n != SETR_LAYERS for n in launches.values()):
        raise AssertionError(f"the card's step launched {launches}")
    if abs(gpu_loss - ref_loss) > 1e-4 * abs(ref_loss):
        raise AssertionError(f"loss {gpu_loss} on the card, {ref_loss} in "
                             f"float64 on the CPU")
    used = {"grad": {}, "update": {}}  # error / allowed error, per tensor
    grad_shares = {}  # error / max |g|, the gradients' own scale
    gpu_params = dict(gpu_model.named_parameters())
    ulp = torch.finfo(torch.float32).eps
    for name, p in ref_model.named_parameters():
        q = gpu_params[name]
        g_max = float(p.grad.abs().max())
        for kind, ref, gpu, allowed in (
                ("grad", p.grad, q.grad, GRAD_RTOL * g_max + GRAD_ATOL),
                ("update", p.detach(), q.detach(),
                 GRAD_RTOL * float((p.detach() - before[name]).abs().max())
                 + ulp * float(before[name].abs().max()))):
            err = float((gpu.cpu().double() - ref).abs().max())
            used[kind][name] = err / allowed
            if kind == "grad":
                grad_shares[name] = err / (g_max + GRAD_ATOL)
            if used[kind][name] > 1.0:
                raise AssertionError(f"{kind} of {name}: max abs error {err} "
                                     f"against an allowed {allowed}")
    print("cpu agreement (setr train step): " + json.dumps(dict(
        batch=[AGREE_BATCH, 3, AGREE_IMAGE_SIZE, AGREE_IMAGE_SIZE],
        loss_float64=ref_loss, loss_gpu=gpu_loss, launches=launches,
        tensors=len(grad_shares),
        grads_over_1e_3_of_max=sum(v > 1e-3 for v in grad_shares.values()),
        worst_grad_share_of_max=sorted(grad_shares.items(),
                                       key=lambda kv: -kv[1])[:3],
        tolerance_used={k: max(v.values()) for k, v in used.items()})),
        flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing measured")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi, flush=True)

    t0 = time.perf_counter()
    builders = (confusion.build_library, flash_attention.build_library,
                flash_attention.build_sm90_library,
                flash_attention.build_sm90_backward_library)
    with ThreadPoolExecutor(len(builders)) as pool:  # nvcc runs outside the GIL
        libs = [build.result() for build in [pool.submit(b)
                                             for b in builders]]
    print(f"build: confusion, flash-attention forward (float32, bf16) and "
          f"backward kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    mma = tensor_core_instructions(libs[2])
    print("bf16 forward kernel SASS: " + json.dumps(mma), flush=True)
    bwd_mma = tensor_core_instructions(libs[3])
    print("backward kernels SASS: " + json.dumps(bwd_mma), flush=True)
    if not mma["HGMMA"] or not bwd_mma["HGMMA"]:
        raise AssertionError("a tensor-core kernel library has no wgmma "
                             "(HGMMA) instruction")
    bwd_usage = resource_usage(libs[3])
    print("backward kernels resources: " + json.dumps(bwd_usage), flush=True)
    # dQ and dK/dV in bf16 and float32 at d = 32, 48, 64, and the split
    expected = {f"{kernel}<{d}>" for kernel in
                (*FLASH_BWD_KERNEL[torch.float32],
                 *FLASH_BWD_KERNEL[torch.bfloat16]) for d in (32, 48, 64)}
    expected.add("split_bf16x3_kernel")
    spills = [name for name, use in bwd_usage.items()
              if use["LOCAL"] or use["STACK"]]
    if not expected <= set(bwd_usage) or spills:
        raise AssertionError(f"backward kernels: missing "
                             f"{sorted(expected - set(bwd_usage))}, stack or "
                             f"local memory (spills) in {spills}")

    l2_flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    rows = kernel_phase(device, l2_flush)
    flash_rows = flash_phase(device, l2_flush)
    bwd_rows = flash_backward_phase(device, l2_flush)
    del l2_flush
    model, x_nchw, launches = slice_phase(device)
    cpu_agreement_phase(model, x_nchw, *SLIDE["crop_size"], "deeplabv3")
    del model, x_nchw
    setr, setr_x, setr_launches = setr_slice_phase(device)
    cpu_agreement_phase(setr, setr_x, 320, 320, "setr")
    if not schedule_cfg()[2]:
        raise AssertionError("the kvasir schedule no longer sets amp")
    amp_launches = setr_amp_slice_phase(setr)
    del setr, setr_x
    train_launches = setr_train_phase(device)
    setr_train_agreement_phase(device)
    amp_train_launches = setr_train_phase(device, amp=True)

    flagship, setr_row = rows[0], flash_rows[0]
    setr_bf16_row = flash_rows[1]

    source = ("image_segmentation_lab_tpu_torch/csrc/"
              "flash_attention_bwd_sm90.cu")
    flash_py = "image_segmentation_lab_tpu/ops/pallas/flash_attention.py"
    f32_rows = [r for r in bwd_rows if r["dtype"] == "float32"]

    def backward_entries(dtype, train):
        """The kernels-line entries of the dQ and dK/dV kernels of one
        dtype, from its rows (the first is SETR's) and its train phase."""
        dtype_rows = [r for r in bwd_rows
                      if r["dtype"] == str(dtype).replace("torch.", "")]
        row, suffix = dtype_rows[0], ("_bf16" if dtype == torch.bfloat16
                                      else "")
        entries = []
        for part, line, grads in (("dq", 156, ("dq",)),
                                  ("dkv", 187, ("dk", "dv"))):
            entry = {
                "name": f"flash_attention_backward_{part}{suffix}",
                "route": "cuda",
                "source": source,
                "replaces": f"{flash_py}:{line}",
                "launches": train[f"backward_{part}{suffix}"],
                "max_abs_err": max(max(r["max_abs_err"][g] for g in grads)
                                   for r in dtype_rows),
                "ms": row[f"{part}_ms"],
                "device_ms": row[f"{part}_device_ms"],
                # the plain version and SDPA compute dQ, dK and dV in one
                # call
                "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{part}_bound_ms"],
                "bound_by": row[f"{part}_bound_by"],
                "library_ms": row["sdpa_backward_ms"],
                "library_device_ms": row["sdpa_backward_device_ms"],
                "delta_device_ms": row["delta_device_ms"],
                "backward_device_ms": row["backward_device_ms"],
                "sass": bwd_mma}
            if dtype == torch.float32:
                # the bound of the route taken, six bf16 products per
                # float32 product on the tensor cores; beside it float32's
                # products on the CUDA cores
                entry.update(
                    bound_route="6 bf16 tensor-core products per float32 "
                                "product, 989 TFLOP/s",
                    cuda_core_bound_ms=row[f"{part}_cuda_core_bound_ms"])
            entries.append(entry)
        return entries

    print(json.dumps({"kernels": [{
        "name": "confusion_histograms",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/confusion.cu",
        "replaces": "image_segmentation_lab_tpu/ops/pallas/confusion.py:49",
        "also_replaces": "image_segmentation_lab_tpu/ops/pallas/"
                         "confusion.py:98",
        "launches": launches["logits"] + launches["labels"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": flagship["ms"],
        "device_ms": flagship["device_ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention_forward",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/flash_attention.cu",
        "replaces": "image_segmentation_lab_tpu/ops/pallas/"
                    "flash_attention.py:61",
        "launches": setr_launches["flash"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                           if r["dtype"] == "float32"),
        "ms": setr_row["ms"],
        "device_ms": setr_row["device_ms"],
        "plain_ms": setr_row["plain_ms"],
        "bound_ms": setr_row["bound_ms"],
        "bound_by": setr_row["bound_by"],
        "library_ms": setr_row["sdpa_ms"],
        "library_device_ms": setr_row["sdpa_device_ms"],
    }, {
        "name": "flash_attention_forward_bf16",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/"
                  "flash_attention_sm90.cu",
        "replaces": "image_segmentation_lab_tpu/ops/pallas/"
                    "flash_attention.py:61",
        # the amp serving phase and the amp train steps
        "launches": amp_launches["flash"]
                    + amp_train_launches["forward_bf16"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                           if r["dtype"] == "bfloat16"),
        "ms": setr_bf16_row["ms"],
        "device_ms": setr_bf16_row["device_ms"],
        "plain_ms": setr_bf16_row["plain_ms"],
        "bound_ms": setr_bf16_row["bound_ms"],
        "bound_by": setr_bf16_row["bound_by"],
        "library_ms": setr_bf16_row["sdpa_ms"],
        "library_device_ms": setr_bf16_row["sdpa_device_ms"],
        "sass": mma,
    }] + backward_entries(torch.float32, train_launches) + [{
        # the float32 backward's operand split, part of the K4/K5 port
        "name": "split_bf16x3",
        "route": "cuda",
        "source": source,
        "replaces": f"{flash_py}:156",
        "also_replaces": f"{flash_py}:187",
        "launches": train_launches["split_bf16x3"],
        "max_abs_err": 0.0,  # phase 8 raises unless it gives plain's bits
        "ms": f32_rows[0]["split_ms"],
        "device_ms": f32_rows[0]["split_device_ms"],
        "plain_ms": f32_rows[0]["split_plain_ms"],
        "bound_ms": f32_rows[0]["split_bound_ms"],
        "bound_by": f32_rows[0]["split_bound_by"],
        "library_ms": None,
    }] + backward_entries(torch.bfloat16, amp_train_launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
