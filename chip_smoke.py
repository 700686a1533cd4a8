"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``, and imports no JAX.  Phases, each
printing its own lines; any failure raises and the exit code is not 0:

1. device: the card's name and power limit;
2. build: compile both kernels from ``csrc/``, one ``nvcc`` each, in
   parallel;
3. confusion kernel: against its plain PyTorch version (exact equality) at
   the eval batches of both slices, at a Cityscapes-sized batch in float32
   and bfloat16, and at a ragged shape with ignored and out-of-range labels;
4. flash-attention kernel: against its plain version at SETR ViT-S/16's
   shape at 640² (float32 and bfloat16), at SegFormer-B0 stage 1's
   ``Lq != Lk`` shape and at a ragged small shape, with q, k and v strided
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
7. cpu agreement: one 320² window of each model, on the CPU and the card.

Kernel times: the wrapper's median of 20 calls by CUDA events and the
kernel's own device time from ``torch.profiler``, with a 96 MB write
between calls so the inputs come from device memory, not the L2 cache;
``bound_ms`` is the larger of bytes over 3.35 TB/s and operations over the
card's peak for their type (67 TFLOP/s float32 without tensor cores, 989
TFLOP/s bfloat16).  The second-to-last line is a JSON object describing
each kernel; the last line is ``{"ok": true, "device": {...}}``.  Models
run in float32 with TF32 off.
"""

from __future__ import annotations

import copy
import json
import math
import re
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from image_segmentation_lab_tpu_torch.core.dataset.synthetic import \
    make_synthetic_item
from image_segmentation_lab_tpu_torch.core.evaluation import SegEvaluator
from image_segmentation_lab_tpu_torch.core.inference import (inference_model,
                                                             init_model)
from image_segmentation_lab_tpu_torch.ops import confusion, flash_attention

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
    ((8, 6, 1601, 1601, 64), torch.bfloat16),
    ((8, 1, 25600, 400, 32), torch.float32),   # SegFormer-B0 stage 1, 640²
    ((3, 1, 130, 130, 64), torch.float32),     # ragged, small
]
# tests/test_flash_attention.py's tolerances against the plain version
FLASH_TOL = {torch.float32: (2e-6, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
IGNORE = 255
RTOL, ATOL = 1e-3, 3e-3  # the slice tolerance of tests/test_torch_port_slice
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


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


def device_ms(fn, kernel, flush, runs=20):
    """The device time of one launch of the kernel whose name contains
    ``kernel``, with ``flush()`` before each call."""
    times, _ = kernel_times(fn, flush, runs)
    hits = [ms for name, ms in times.items() if kernel in name]
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
                "flash_fwd_kernel", flush),
            plain_ms=cuda_ms(lambda: flash_attention.attention_plain(*args),
                             flush),
            sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale), flush),
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


def slice_phase(device):
    model = init_model(CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("the flagship's aux head is missing")
    randomize_(model, seed=0)
    x, x_nchw, masks = synthetic_batch(device, BATCH, IMAGE_SIZE)

    for key in confusion.launches:
        confusion.launches[key] = 0
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
    for key, words in (("flash attention", ("flash_fwd_kernel",)),
                       ("confusion", ("confusion_kernel",)),
                       # cuDNN's implicit-GEMM and FFT convolutions
                       ("conv", ("conv", "fprop", "fft", "flip_filter",
                                 "pointwise_mult_and_sum_complex")),
                       ("matmul", ("gemm", "cutlass", "xmma")),
                       ("layer norm", ("layer_norm",)),
                       ("batch norm", ("batch_norm", "bn_")),
                       ("upsample", ("upsample",)),
                       ("softmax", ("softmax",))):
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


def setr_slice_phase(device):
    model = init_model(SETR_CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("SETR's aux head is missing")
    if model.backbone.depth != SETR_LAYERS:
        raise AssertionError(f"ViT-S has {model.backbone.depth} layers")
    randomize_(model, seed=0)
    x, x_nchw, masks = synthetic_batch(device, SETR_BATCH, SETR_IMAGE_SIZE)
    shape = (SETR_BATCH, SETR_IMAGE_SIZE, SETR_IMAGE_SIZE)
    forwards = 0

    def serve():
        nonlocal forwards
        forwards += 1
        return inference_model(model, x)

    for counts in (flash_attention.launches, confusion.launches):
        for key in counts:
            counts[key] = 0
    evaluator = new_evaluator()
    with torch.no_grad():
        check_class_map(serve(), shape, "setr whole")
        latency = timed_batches(serve)
        forwards += 1
        probs = model.inference(x_nchw)
        if not bool(torch.isfinite(probs).all()):
            raise AssertionError("setr: non-finite output")
        evaluator.process(0, {"whole": probs}, {"ori_gt": masks})
    torch.cuda.synchronize()
    launches = dict(flash=flash_attention.launches["forward"],
                    confusion=confusion.launches["logits"])
    metrics = evaluator.compute_metrics()
    check_metrics(metrics)
    if launches["flash"] != SETR_LAYERS * forwards:
        raise AssertionError(f"{launches['flash']} flash launches for "
                             f"{forwards} forwards of {SETR_LAYERS} layers")
    if launches["confusion"] == 0:
        raise AssertionError("the evaluator never launched the kernel")
    print("setr slice: " + json.dumps(dict(
        batch=list(x_nchw.shape), ms_per_batch=latency, forwards=forwards,
        launches=launches, metrics=summarize(metrics))), flush=True)

    print_breakdown("setr", lambda: model.inference(x_nchw))
    return model, x_nchw, launches


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
    with ThreadPoolExecutor(2) as pool:  # nvcc runs outside the GIL
        for build in [pool.submit(confusion.build_library),
                      pool.submit(flash_attention.build_library)]:
            build.result()
    print(f"build: confusion and flash-attention kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    l2_flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    rows = kernel_phase(device, l2_flush)
    flash_rows = flash_phase(device, l2_flush)
    del l2_flush
    model, x_nchw, launches = slice_phase(device)
    cpu_agreement_phase(model, x_nchw, *SLIDE["crop_size"], "deeplabv3")
    del model, x_nchw
    setr, setr_x, setr_launches = setr_slice_phase(device)
    cpu_agreement_phase(setr, setr_x, 320, 320, "setr")

    flagship, setr_row = rows[0], flash_rows[0]
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
        "sdpa_ms": setr_row["sdpa_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
