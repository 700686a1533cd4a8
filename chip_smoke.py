"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``, and imports no JAX.  Phases, each
printing its own lines; any failure raises and the exit code is not 0:

1. device: the card's name and power limit;
2. build: compile the confusion-histogram kernel from ``csrc/``;
3. kernel: the kernel against its plain PyTorch version (exact equality)
   at the flagship's eval batch, at a Cityscapes-sized batch in float32
   and bfloat16, and at a ragged shape with ignored and out-of-range
   labels; median times of both from CUDA events;
4. slice: full-width DeepLabV3-R50-d8 through ``init_model`` and
   ``inference_model`` (whole and slide inference) on four synthetic 512²
   images, then ``SegEvaluator`` on the logits; the kernel's launch counts
   over this phase show that the evaluator went through it;
5. cpu agreement: one 320² window at full width on the CPU and the card.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Everything runs in float32 with
TF32 off.
"""

from __future__ import annotations

import copy
import json
import math
import re
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from image_segmentation_lab_tpu_torch.core.dataset.synthetic import \
    make_synthetic_item
from image_segmentation_lab_tpu_torch.core.evaluation import SegEvaluator
from image_segmentation_lab_tpu_torch.core.inference import (inference_model,
                                                             init_model)
from image_segmentation_lab_tpu_torch.ops import confusion

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs/network/deeplabv3/deeplabv3_r50-d8.py"
VAL_TRANSFORM = ROOT / "configs/augmentation/kvasir_val_transform.yaml"
BATCH, IMAGE_SIZE = 4, 512
SLIDE = dict(mode="slide", crop_size=(320, 320), stride=(192, 192))
KERNEL_SHAPES = [  # (N, C, H, W), num_classes, dtype
    ((8, 2, 512, 512), 2, torch.float32),
    ((2, 19, 1024, 2048), 19, torch.float32),
    ((2, 19, 1024, 2048), 19, torch.bfloat16),
    ((3, 5, 97, 131), 5, torch.float32),
]
IGNORE = 255
RTOL, ATOL = 1e-3, 3e-3  # the slice tolerance of tests/test_torch_port_slice


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


def max_count_err(out, ref):
    return max(float((a - b).abs().max()) if a.numel() else 0.0
               for a, b in zip(out, ref))


def kernel_phase(device):
    gen = torch.Generator(device=device).manual_seed(0)
    l2_flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
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
        row = dict(shape=[n, c, h, w], dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, labels_max_abs_err=label_err,
                   ms=cuda_ms(lambda: confusion.confusion_histograms(*args),
                              flush),
                   plain_ms=cuda_ms(lambda: confusion.histograms_plain(*args),
                                    flush),
                   labels_ms=cuda_ms(
                       lambda: confusion.confusion_histograms_from_labels(
                           *label_args), flush),
                   labels_plain_ms=cuda_ms(
                       lambda: confusion.histograms_from_labels_plain(
                           *label_args), flush))
        print("kernel:", json.dumps(row), flush=True)
        rows.append(row)
        del logits, gt, pred, args, label_args
    return rows


def normalize_constants():
    """mean/std of the Kvasir val transform (PyYAML is not required)."""
    text = VAL_TRANSFORM.read_text()

    def vec(key):
        match = re.search(rf"^\s*{key}:\s*\[([^\]]+)\]", text, re.M)
        return [float(v) for v in match.group(1).split(",")]

    scale = float(re.search(r"max_pixel_value:\s*([\d.]+)", text).group(1))
    return vec("mean"), vec("std"), scale


def randomize_(model, seed):
    """Seeded weights under which every layer counts: the default init
    zeroes each block's last norm, and the classifier's std 0.01 leaves
    logits near 0.  Norm affines and statistics are drawn at random and the
    classifiers get unit gain, so logits are of order one."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t, lo, hi):
        t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=gen))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                fill(m.weight, 0.4, 0.8)
                fill(m.bias, -0.1, 0.1)
                fill(m.running_mean, -0.1, 0.1)
                fill(m.running_var, 0.5, 1.5)
        for head in (model.decode_head, model.auxiliary_head):
            w = head.conv_seg.weight
            w.copy_(torch.randn(w.shape, generator=gen)
                    / math.sqrt(w[0].numel()))


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


def slice_phase(device):
    model = init_model(CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("the flagship's aux head is missing")
    randomize_(model, seed=0)
    items = [make_synthetic_item(i, (IMAGE_SIZE, IMAGE_SIZE))
             for i in range(BATCH)]
    images = np.stack([im for im, _ in items])
    masks = np.stack([m for _, m in items]).astype(np.int32)
    mean, std, scale = normalize_constants()
    x = torch.from_numpy(images).to(device).float() / scale
    x = (x - torch.tensor(mean, device=device)) / torch.tensor(std,
                                                                device=device)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()

    for key in confusion.launches:
        confusion.launches[key] = 0
    latency = {}
    evaluator = SegEvaluator(epoch=0, num_classes=2,
                             class_names=["background", "object"],
                             palette=[[0, 0, 0], [0, 63, 255]],
                             show_result=False)
    with torch.no_grad():
        for mode, test_cfg in (("whole", dict(mode="whole")),
                               ("slide", SLIDE)):
            model.test_cfg = test_cfg
            pred = inference_model(model, x)
            if (pred.shape != (BATCH, IMAGE_SIZE, IMAGE_SIZE)
                    or not np.isin(pred, (0, 1)).all()):
                raise AssertionError(f"{mode}: bad class map {pred.shape}")
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
    summary = {mode: {k: float(metrics[mode][k]) for k in
                      ("aAcc", "mIoU", "mDice", "mFscore")}
               for mode in metrics}
    print("slice: " + json.dumps(dict(
        batch=list(x_nchw.shape), ms_per_batch=latency, launches=launches,
        metrics=summary)), flush=True)
    return model, x_nchw, launches


def cpu_agreement_phase(model, x_nchw):
    h, w = SLIDE["crop_size"]
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
    print("cpu agreement: " + json.dumps(dict(
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
    confusion.build_library()
    print(f"build: confusion kernel in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rows = kernel_phase(device)
    model, x_nchw, launches = slice_phase(device)
    cpu_agreement_phase(model, x_nchw)

    flagship = rows[0]
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
        "plain_ms": flagship["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
