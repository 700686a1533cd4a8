"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``, and imports no JAX.  Phases, each
printing its own lines; any failure raises and the exit code is not 0:

1. device: the card's name and power limit;
2. build: compile the four kernel libraries from ``csrc/`` (confusion,
   flash-attention forward and backward on the tensor cores, each in bf16
   and in float32 with its split, resize backward), one ``nvcc`` each, in
   parallel; count the tensor-core instructions (HGMMA, HMMA) in the
   forward's and the backward's SASS, which must not be 0, and read each
   kernel's registers, stack, shared and local memory (``cuobjdump
   -res-usage``): the six forward kernels (bf16 and float32, d =
   32/48/64), the twelve backward kernels (dQ and dK/dV, bf16 and
   float32), the split (in the forward's library), the resize backward and
   the confusion kernel (the most of its 24 instances) must all be there,
   with stack and local memory 0, so nothing spills;
3. confusion kernel, both entries (logits, K1; labels, K2): against its
   plain PyTorch version (exact equality) at the eval batches of both
   slices, at a Cityscapes-sized batch in float32 and bfloat16, at a
   ragged shape with ignored and out-of-range labels, and at the smallest
   and largest Kvasir image of phase 17's ragged path; one call of each
   entry must be exactly one device kernel (no fill, no cast), and every
   kernel instance that a main path launches (phases 6-8) must have been
   held here; beside it ``torch.argmax`` + ``torch.bincount`` of the (gt,
   pred) pairs (K1) and the ``bincount`` alone (K2) as yardsticks, whose
   confusion matrix must hold the same counts; the kernel's device time
   also after a flush that reads 96 MB and leaves the L2 clean
   (``*_clean_l2``);
4. flash-attention forward kernels (on the tensor cores; bfloat16 as it
   is, float32 split into three bf16 parts by the split kernel): against
   their plain version at SETR ViT-S/16's shape at 640², at SegFormer-B0
   stage 1's ``Lq != Lk`` shape, at a ragged small shape and at the four
   stages of each MiT path of phases 18 and 19 (MIT_CASES: MiT-B2 and
   MiT-B0 at 16 x 640², MiT-B2 at 8 x 640², MiT-B0 at 8 x 512², in the
   dtypes each runs, with each launch's CTA count), with q, k and v
   strided views of a fused
   projection as the models pass them (MiT: q alone and k, v views of the
   fused kv, also at sr 1); in float32 a second call must give the same
   bits and the split of q, k and v its plain version's bits; beside it
   ``F.scaled_dot_product_attention`` as a yardstick (never on the path),
   timed with the plain version at the rows of fixed shapes (at the MiT
   and phase 22 rows both stand in PERF.md's kernel table);
5. DeepLabV3 slice: full-width DeepLabV3-R50-d8 through ``init_model`` and
   ``inference_model`` (whole and slide inference) on four synthetic 512²
   images, then ``SegEvaluator`` on the logits; the confusion kernel's
   launch counts over this phase show that the evaluator went through it;
   then the device time per kernel of one batch of each from
   ``torch.profiler``;
6. SETR slice: full-width SETR-PUP ViT-S/16 through ``init_model``,
   ``inference_model`` (whole) and ``SegEvaluator`` on eight synthetic 640²
   images; exactly 12 flash launches per forward (one per layer) and as
   many splits, and the device time per kernel of one batch from
   ``torch.profiler``;
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
   the last tile), a d = 48 shape and the four stages of MiT-B2 and
   MiT-B0 at 16 x 640² (with each kernel's CTA count), each in float32
   and bfloat16, with
   q, k, v and dO as the model passes them (in bfloat16 an element beyond
   the gate holds if the kernel is no further from the float64 gradient of
   the same inputs than the plain version is, plus one bf16 step: two
   roundings of float32 sums in other orders part by two steps where a sum
   cancels); a second call must give the same bits; beside them the
   backward of
   ``F.scaled_dot_product_attention`` in the same dtype as a yardstick
   (never on the path; with the plain version, not retimed at the MiT and
   phase 22 rows) and the device time of ``backward_delta`` (the
   kernels' delta = rowsum(dO·O), plain torch);
8b. resize backward kernel (the gradient of the bilinear resize, two
   separable passes through shared memory, no atomics): against its plain
   version (the same bits) at SETR's six upsamples in its train step,
   DeepLabV3's at 512² and 640² (the 8x logits and the 1 x 1 ASPP image
   pool, wide tables), SegFormer-B2's at 16 x 640² (the head's 768
   channels to 160², the logits to 640²) and PSPNet's pyramid pooling (1 x
   1 and 6 x 6 to 80²) and Mask2Former's pixel decoder at 8 x 640²
   (M2F_RESIZE_SHAPES), in float32 and bfloat16, the rest of the pyramid
   heads' amp steps in bfloat16 (PYRAMID_RESIZE_SHAPES), phase 22's
   (DECODER_RESIZE_SHAPES), an align_corners upsample
   (ALIGN_CORNERS_RESIZES) and phase 23's in bfloat16
   (REALTIME_RESIZE_SHAPES); one launch a call, the bf16 result the
   kernel's float32 result rounded once and a second call the same bits;
   beside it ``F.interpolate``'s own backward
   (``aten::upsample_bilinear2d_backward``) as a yardstick, and each row's
   device time over the library's and its bound over its device time
   (yardsticks timed at phase 23's and 24's rows and RESIZE_HEADLINES; at
   the others they stand in PERF.md's kernel table);
9. SETR train slice: full-width SETR-PUP ViT-S/16 through ``init_model``,
   ``create_train_state`` and ``make_train_step`` (SGD and StepLR of the
   kvasir schedule, drop path 0.1 from a CUDA generator) for 10 steps on
   one batch of eight synthetic 640² images; exactly 12 launches of each
   flash kernel per step, 24 of the split (12 forward, 12 backward) and 6
   of the resize backward (SETR_RESIZES), finite and falling losses,
   moved parameters and BN statistics, gradients in the aux head; ms per
   step, peak memory and the device time per kernel class of one step
   from ``torch.profiler``;
10. cpu agreement (SETR train step): the full-size config without drop
   path, batch 2 at 320², one train step from the same weights on the card
   (kernels, float32) and on the CPU in float64 (plain versions, attention
   and LayerNorm without their float32 casts), there with every ReLU and
   max-pool taking the branch it took on the card: loss, every gradient
   and every parameter after the update; beside it the distance from the
   float64 step on its own branches and the number of flipped branches;
11. SETR train slice under amp: first one step's gradients from the
   same weights with the kernels and with plain attention on the card, each
   gradient tensor within 0.25 relative norm (the CPU amp test's bound);
   then phase 9's 10 steps under the bf16 policy, with 12 launches of the
   bf16 forward kernel and of each bf16 backward kernel per step and none
   of the float32 ones;
12. DeepLabV3 train slice: full-width DeepLabV3-R50-d8 (sigmoid CE, aux
   weight 1.0, head dropout 0.1 from a CUDA generator, SyncBN as BN on one
   card) through ``init_model``, ``create_train_state`` (the kvasir SGD and
   StepLR) and ``train_one_epoch``: 10 steps on one batch of the schedule's
   ``train_batch_size`` (16) synthetic 512² images; exactly 3 resize
   backward launches per step (DEEPLAB_RESIZES) and no flash launch,
   finite and falling losses, moved parameters and BN statistics; ms per
   step, peak memory and one step's breakdown from ``torch.profiler``;
   then ``validate_one_epoch`` through ``make_eval_step`` over two batches
   of the schedule's ``val_batch_size`` (8): exactly 2 launches of the
   confusion kernel's logits entry per batch (decode and aux heads) and
   none of its labels entry, and the evaluator's counts equal to
   ``torch.argmax`` + ``torch.bincount`` on the same logits; then
   ``make_tta_step`` at (0.75, 1.0, 1.25) on one batch (6 forwards at
   384², 512² and 640²), ``binarize_channels`` and the evaluator, as
   ``val.py --tta`` composes them: 1 launch, probabilities that sum to 1
   per pixel within 1e-5; ms per batch of each;
13. cpu agreement (DeepLabV3 train step): the full-width config without
   head dropout, batch 4 at 256², one step from the same weights on the
   card (the resize kernel, float32) and on the CPU in float64 (its plain
   version), held as phase 10;
14. DeepLabV3 train slice under amp: first one step's gradients from the
   same weights with the resize kernel and with its plain version on the
   card under ``torch.use_deterministic_algorithms`` (the same bits, or
   within 1e-6 relative norm where an op has no deterministic
   implementation, which is named); then phase 12's steps and validation
   under the bf16 policy, with 3 bf16 resize backward launches per step
   and no float32 one;
15. the Kvasir augmentation pipeline alone: ``Pipeline.from_yaml`` of
   ``configs/augmentation/kvasir_train_transform.yaml`` on the card at the
   schedule's 16 × 640² uint8 from ``SyntheticDataset``: shapes, dtypes,
   finite values, each OneOf child's and p < 1 leaf's sub-batch equal to
   ``_apportion``; the pinned copy of the YAML
   (``tests/data/kvasir_train_transform_pinned.yaml``) on the card against
   the port on the CPU (2e-4 after Normalize; Rotate's nearest mask taps
   off only at half-integer source coordinates, at most 0.1 %); GlassBlur
   and ISONoise with draws made on the CPU, card against CPU (1e-2 on the
   0-255 scale); device ms a batch, busy share and the device time by
   transform (``record_function`` ranges), each transform alone on its
   sub-batch, and each blur's grouped convolution against shifted adds;
   the same for the val YAML at 8 × 640² (= Normalize on the CPU);
16. the flagship's loop with the augmentation fused into the step:
   DeepLabV3-R50-d8 (phase 12's model) for 10 steps of
   ``train_one_epoch(..., fused_aug=True)`` over a 4-thread
   ``DataLoader`` of ``SyntheticDataset`` 640² items through the Kvasir
   train YAML at the schedule's batch of 16, in float32 and under amp:
   uint8 batches to the card, exactly 3 resize-backward launches a step
   in the policy's dtype, finite losses whose last three steps' mean is
   below the first three's, moved parameters; step time (median of steps
   2-10), the epoch's wall time and the loader's share of it, peak
   memory, host-to-device MB a step, over a profiled epoch of three
   batches the busy share and the augmentation's device ms a step by
   transform, and one step's breakdown by kernel class; then ``validate_one_epoch(..., pipeline=
   val_dataset.device_pipeline)`` over two batches of 8 × 640², held as
   phase 12's validation (2 K1 launches a batch, counts = argmax +
   bincount);
17. the CLIs: ``image_segmentation_lab_tpu_torch.train.main`` in this
   process under ``torch.profiler`` on a Kvasir-shaped synthetic dataset
   (``SyntheticDataset`` 640² items through the Kvasir YAMLs,
   ``ignore_index=-1``, 48 train items: 3 steps of the schedule's 16, 8
   val items, one batch, with ``return_ori_seg_gt``) at the flagship's
   full width with the kvasir schedule as it is (amp, deterministic, SGD
   and StepLR) and ``--epochs 1``: step and epoch times, the checkpoints'
   sizes and write times, validation ms a batch, the launches (2 of K1, 9 of the
   bf16 resize backward, no other), device time by kernel class;
   ``last.pth`` and ``best.pth`` load back strictly into fresh port
   models; then ``val.main`` on ``best.pth`` with ``--amp`` (its mIoU
   within 0.05 points of the train run's validation recorded in
   ``best.pth``; 2 K1 launches a batch) and with ``--tta`` (1 a batch);
   then the ragged evaluator path on the card: the model's bf16 logits for
   eight synthetic images of Kvasir sizes (529 × 622 to 1072 × 1350)
   brought to 640² by the val YAML, with labels at their own sizes, through
   ``SegEvaluator.process``: 16 K2 launches, counts equal to the same path
   on the CPU exactly, and each image's K2 counts equal to argmax +
   bincount; then the fused amp step with deterministic algorithms off and
   on (the schedule's ``deterministic=True``), with a breakdown of each.
   The run directory is deleted after;
18. the SegFormer path at MiT-B2's full width (16 attention layers, head
   dims 64): serving at 8 x 640² through ``init_model``,
   ``inference_model`` and ``SegEvaluator`` in float32 (16 launches of the
   float32 forward and of the split a forward) and under amp (16 of the
   bf16 forward; logits against the same bf16 forward with plain
   attention), one 320² window against the port on the CPU; the fused
   train loop (phase 16's, through the Kvasir YAML from a 4-thread
   ``DataLoader``) at the SegFormer schedule's 16 x 640² with its AdamW
   and WarmScheduler from the seeded default init, in float32 and under
   amp: 16 launches of each flash kernel a step (the split twice) and 4
   of the resize backward, finite and falling losses, moved parameters,
   validation through the val YAML (1 K1 launch a batch); one float32
   step of SegFormer-B0 (d = 32) at 4 x 256² against float64 on the CPU
   on the card's branches, as phase 10; the train CLI on the SegFormer
   schedule as it is (amp, ``deterministic=True``, AdamW) for one epoch
   of 3 steps on phase 17's Kvasir-shaped dataset, ``val.main --amp`` on
   its ``best.pth`` (mIoU within 0.05 of the train run's), and the fused
   amp step with deterministic algorithms off and on;
19. the pyramid heads at full width: UPerNet on MiT-B0 (8 attention
   layers), UPerNet on ResNetV1c-50 and PSPNet on ResNetV1c-50-d8, each
   served at 8 x 512² (held
   against the port on the CPU on a 320² window), validated over two
   batches of 8 (2 K1 launches a batch), then two amp train steps at 16
   x 640² (the first lets cuDNN choose) under
   ``torch.use_deterministic_algorithms``: 12 (UPerNet) and 6 (PSPNet)
   bf16 resize-backward launches a step, 8 of each bf16 flash kernel
   (UPerNet), step ms and peak memory;
20. UPerNet's backbone family at full width: UPerNet on Swin-T (window 7
   and window 8), ConvNeXt-T, BEiT-B and MAE-B (the last two through the
   Feature2Pyramid neck), each served at 8 x 512² in float32 (held against
   the port on the CPU on a 320² window; no flash launch: their attention
   adds a relative-position bias and runs as two matrix products),
   validated over two batches of the schedule's val batch (2 K1 launches
   a batch), then two amp train steps at the schedule's train batch of
   640² (Swin and ConvNeXt: the SegFormer schedule; BEiT and MAE: the BEiT
   fine-tuning schedule with its layer-decay param groups) under
   ``torch.use_deterministic_algorithms``: 12 bf16 resize-backward
   launches a step, step ms and peak memory; BEiT-B's table work at 640²
   (the bicubic resample as matrix products against ``F.interpolate``'s,
   whose backward has no deterministic implementation, and the bias
   gather's backward) with deterministic algorithms off and on; one
   float32 step of Swin-T (the kvasir SGD) and of BEiT-B (its schedule's
   AdamW param groups, each group's lr checked) at 2 x 224² against
   float64 on the CPU, as phase 10 (BEiT's updates reported, not held:
   Adam's first update is about lr · sign(g)); the train CLI on
   UPerNet-BEiT-B with the BEiT schedule as it is for 3 steps (the param
   groups in ``last.pth``), then ``val.main --amp`` on its ``best.pth``
   (mIoU within 0.05 of the train run's);
21. the mask-classification family: Mask2Former-R50 at full width (100
   queries, width 256, 9 decoder layers over 3 scales, FFN 2048, 12544
   points a pair) served at 16 x 640² (bench.py's whole-image geometry) in
   float32 and under amp (float32 probabilities: the head combines its
   queries in float32), no flash launch, held against the port on the CPU
   on a 320² window with the card's blocked maps; validated over two
   batches of 8 (1 K1 launch a batch); 10 steps of ``train_one_epoch`` at
   8 x 640² (bench.py's train geometry) under the SegFormer schedule's
   AdamW (the kvasir SGD diverges here, MASK_TRAIN_SCHEDULE) from the
   seeded default init, in float32, under amp, and under amp with
   deterministic algorithms: 3 resize-backward launches a step in the
   policy's dtype, the auction's ms, rounds and host synchronisations a
   step, the loss points' ms a step, peak memory and a breakdown; one
   float32 step at 2 x 256² against float64 on the CPU on the card's
   branches, assignments, loss points and blocked maps, and the auction on
   the CPU on the step's cost matrices equal to the card's; the train CLI
   on Mask2Former-R50 for 3 steps, then ``val.main --amp --panoptic
   --instances --score`` (mIoU as the train run's; PQ/SQ/RQ, mask AP,
   ``instances.json``) and ``val.main --panoptic --tta`` at thresholds 0
   on its ``best.pth`` and on a seeded checkpoint (there at least one kept
   segment and one exported instance); MaskFormer-R50 and Mask2Former-Swin-T served at 8 x 512²,
   each held against the CPU on a 320² window;
22. the ViT decoders, Twins, PoolFormer-FPN and ResNetV1d (DECODER_CASES):
   SETR-MLA and DPT on ViT-S, UPerNet on ViT-B with the MultiLevelNeck,
   Segmenter on ViT-S, UPerNet on Twins-PCPVT-S and -SVT-S, PoolFormer-S12
   with the FPN neck and head, PSPNet on ResNetV1d-50-d8, each served at 8
   x 512² in float32 and under amp with the flash launches of its global
   attention layers a forward (Segmenter's float32 probabilities under
   amp), one 320² window held against the port on the CPU, validated over
   two val batches of 8 (1 K1 launch a batch and head), then two
   deterministic amp steps at the schedule's train batch of 640² (the
   kvasir SGD for the ViT family and PSPNet, the SegFormer schedule's
   AdamW for Twins and PoolFormer) with each step's flash and bf16
   resize-backward launches and a profiled third step; one float32 step
   of SVT-S (local windows padded at every stage, global layers at d =
   32) and of DPT (the class-token readout, the transposed convs) at 2 x
   256² against float64 on the CPU on the card's branches, as phase 10;
   the train CLI on SETR-MLA with the kvasir schedule as it is for 3
   steps, then ``val.main --amp`` on its ``best.pth`` (mIoU within 0.05 of
   the train run's).  Phases 4, 8 and 8b hold the flash kernels and the
   resize backward at this phase's shapes too (DECODER_FLASH_CASES,
   DECODER_RESIZE_SHAPES, MultiLevelNeck's levels with the user's scale);
23. SegNeXt-T (MSCAN and LightHamHead's NMF), PIDNet-S and DDRNet-23-slim
   (REALTIME_CASES), the last two with their OHEM and boundary losses:
   each served whole at 16 x 640² (bench.py's geometry) in float32 and
   under amp with a breakdown of each, no flash launch, SegNeXt's serving
   twice with the same bits (the NMF's eval bases), one 320² window held
   against the port on the CPU (with the card's NMF bases), validated over
   two val batches of 8 (1 K1 launch a batch, counts = argmax +
   bincount), two deterministic amp steps at the schedule's train batch
   of 640² (SegNeXt: the SegFormer schedule's AdamW; PIDNet and DDRNet:
   the kvasir SGD) with 3, 14 and 9 bf16 resize-backward launches a step
   and a profiled third, every OHEM threshold and NMF on the card, every
   resize backward's shape one that phase 8b holds
   (REALTIME_RESIZE_SHAPES); ``torch.sort``'s ms at the step's 6.55 M
   pixels; one float32 step of PIDNet-S at 2 x 256² against float64 on
   the CPU on the card's ReLU branches, OHEM kept sets and boundary
   masks (``RealtimeChoices``);
24. the non-local head family and DeepLabV3+ on the flagship's
   ResNetV1c-50-d8 (NONLOCAL_CASES: DeepLabV3+'s separable ASPP, NL,
   DNL, GC, CC, DA, ANN, ISA, EMA and PSA heads with the FCN aux head), one
   seeded backbone shared by the ten: each served whole at 16 x 640² in
   float32 and under amp (one timed batch each, a breakdown each), one
   320² window held against the port on the CPU, one validation batch of
   8 (2 K1 launches, counts = argmax + bincount), two deterministic amp
   steps at the kvasir schedule's 16 x 640² with each step's bf16
   resize-backward launches and a profiled third, every resize shape one
   that phase 8b holds.  The wall seconds of each phase are printed at
   the end (``phase seconds``).

Kernel times: the wrapper's median of 20 calls by CUDA events and the
kernel's own device time from ``torch.profiler`` (for SDPA's forward, of
every kernel it launches), with a 96 MB write between calls so the inputs
come from device memory, not the L2 cache;
``bound_ms`` is the larger of bytes over 3.35 TB/s and operations over the
card's peak for their type (67 TFLOP/s float32 without tensor cores, 989
TFLOP/s bfloat16); the float32 flash kernels do six bf16 products per
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
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from image_segmentation_lab_tpu_torch.core.dataset import (DataLoader,
                                                           SyntheticDataset)
from image_segmentation_lab_tpu_torch.core.dataset.synthetic import \
    make_synthetic_item
from image_segmentation_lab_tpu_torch import train as train_cli
from image_segmentation_lab_tpu_torch import val as val_cli
from image_segmentation_lab_tpu_torch.core.builder import (LR_SCHEDULER,
                                                          build_from_cfg)
from image_segmentation_lab_tpu_torch.core.evaluation import SegEvaluator
from image_segmentation_lab_tpu_torch.core.fileio import load_python_config
from image_segmentation_lab_tpu_torch.core.initialize import init_weights
from image_segmentation_lab_tpu_torch.core.initialize.checkpoint import (
    load_file, save_checkpoint)
from image_segmentation_lab_tpu_torch.core.inference import (inference_model,
                                                             init_model)
from image_segmentation_lab_tpu_torch.core.mixed_precision import (
    amp_policy, policy_scope)
from image_segmentation_lab_tpu_torch.data import transforms as aug
from image_segmentation_lab_tpu_torch.data.pipeline import Pipeline
from image_segmentation_lab_tpu_torch.models.backbones import mit, vit
from image_segmentation_lab_tpu_torch.models.backbones.poolformer import \
    PoolFormerBlock
from image_segmentation_lab_tpu_torch.models.basic import LayerNorm
from image_segmentation_lab_tpu_torch.models.backbones.mscan import \
    MSCABlock
from image_segmentation_lab_tpu_torch.models.builder import build_segmentor
from image_segmentation_lab_tpu_torch.models.decode_heads import (
    CAM, PAM, CrissCrossAttention, Mask2FormerHead, MaskFormerHead,
    SegmenterMaskTransformerHead, ham_head, pid_head)
from image_segmentation_lab_tpu_torch.models.losses import \
    ohem_cross_entropy
from image_segmentation_lab_tpu_torch.ops import (confusion, flash_attention,
                                                  matching, resize_backward)
from image_segmentation_lab_tpu_torch.train_state import (
    TrainState, binarize_channels, create_train_state, head_threshold,
    make_eval_step, make_train_step, make_tta_step)
from image_segmentation_lab_tpu_torch.utils import ops as resize_ops
from image_segmentation_lab_tpu_torch.utils.train_utils import (
    train_one_epoch, validate_one_epoch)

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
    ((8, 2, 640, 640), 2, torch.bfloat16),     # the same under amp
    ((2, 19, 1024, 2048), 19, torch.float32),
    ((2, 19, 1024, 2048), 19, torch.bfloat16),
    ((3, 5, 97, 131), 5, torch.float32),
    # K2's shapes on the ragged evaluator path: one Kvasir image at its own
    # size, the smallest (odd pixel count: one pixel a thread) and the
    # largest (16-byte packets)
    ((1, 2, 529, 622), 2, torch.float32),
    ((1, 2, 1072, 1350), 2, torch.float32),
]
FLASH_SHAPES = [  # (N, h, Lq, Lk, d), dtype
    ((8, 6, 1601, 1601, 64), torch.float32),   # SETR ViT-S/16, 640², b8
    ((8, 6, 1601, 1601, 64), torch.bfloat16),  # the same under amp
    ((8, 1, 25600, 400, 32), torch.float32),   # SegFormer-B0 stage 1, 640²
    ((8, 1, 25600, 400, 32), torch.bfloat16),
    ((3, 1, 130, 130, 64), torch.float32),     # ragged, small
]
# the device kernel behind each dtype of the forward wrapper
FLASH_FWD_KERNEL = {torch.float32: "flash_fwd_bf16x3_kernel",
                    torch.bfloat16: "flash_fwd_sm90_kernel"}
# the device kernels (dQ, dK/dV) behind each dtype of the backward wrappers
FLASH_BWD_KERNEL = {
    torch.float32: ("flash_bwd_dq_bf16x3_kernel",
                    "flash_bwd_dkv_bf16x3_kernel"),
    torch.bfloat16: ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")}
# bf16 products per float32 product in the float32 flash kernels (the
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
# SETR-PUP's bilinear resizes under grad in its train step at 8 x 640²
# (align_corners False): the decode head's three 2x steps on 256 channels
# and its last on the class map, the aux head's 4x step and its loss's
# resize to 640²; (N, C, h, w) -> (H, W)
SETR_RESIZES = [((8, 256, 40, 40), (80, 80)),
                ((8, 256, 80, 80), (160, 160)),
                ((8, 256, 160, 160), (320, 320)),
                ((8, 2, 320, 320), (640, 640)),
                ((8, 2, 40, 40), (160, 160)),
                ((8, 2, 160, 160), (640, 640))]
# DeepLabV3-R50-d8's bilinear resizes under grad in its train step at 16 x
# 512² (align_corners False): the decode and aux heads' logits (8x, 16 taps
# an axis) and the ASPP image pool (a 1 x 1 input, 64 taps an axis)
DEEPLAB_RESIZES = [((16, 2, 64, 64), (512, 512)),
                   ((16, 2, 64, 64), (512, 512)),
                   ((16, 512, 1, 1), (64, 64))]
# the same at the kvasir schedule's 16 x 640² (phase 16): the logits from
# 80², the image pool to 80²
DEEPLAB_RESIZES_640 = [((16, 2, 80, 80), (640, 640)),
                       ((16, 2, 80, 80), (640, 640)),
                       ((16, 512, 1, 1), (80, 80))]
SCHEDULE = ROOT / "configs/schedule/kvasir_training_schedule.py"
TRAIN_TRANSFORM = ROOT / "configs/augmentation/kvasir_train_transform.yaml"
# the train YAML with every draw pinned (tests/test_torch_port_data.py)
PINNED_TRANSFORM = ROOT / "tests/data/kvasir_train_transform_pinned.yaml"
AUG_SIZE = 640  # the Kvasir YAMLs' Resize
LOADER_WORKERS = 4  # the reference's DataLoader(num_workers=4)
# the pipeline's tolerances of tests/test_torch_port_data.py: images on the
# 0-255 scale before Normalize, after it; Rotate's nearest mask taps may
# differ only where the source coordinate is within 1e-3 of a half-integer
# (the card's sin and cos may round it the other way), at most 0.1 %
RAW_ATOL, NORM_ATOL, MASK_FLIP_SHARE = 1e-2, 2e-4, 1e-3
TTA_SCALES = (0.75, 1.0, 1.25)  # val.py's --tta-scales default
# the flagship's float64 agreement step: at 256² the stride-8 map is 32²,
# so the ASPP's dilation-12 and -24 taps land inside it.  Four images, not
# two: over few values a channel (the ASPP's image pool normalises one an
# image) train-mode BN's input gradient is the difference of terms up to
# |x - mean|² / eps times larger than itself, and at two images float32's
# own rounding, on the same branches, comes to about GRAD_RTOL
DEEPLAB_AGREE_BATCH, DEEPLAB_AGREE_SIZE = 4, 256
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
# one amp flagship step's gradients with the resize backward kernel against
# the same step with its plain version, under deterministic algorithms:
# the same bits, or, where an op has no deterministic implementation, this
# relative norm per tensor
AMP_DETERMINISTIC_SHARE = 1e-6
# phase 17: the CLIs on a Kvasir-shaped synthetic dataset at AUG_SIZE²;
# CLI_TRAIN_STEPS steps of the schedule's batch, one val batch
CLI_TRAIN_STEPS = 3
CLI_VAL_BATCHES = 1
CLI_DATASET = """
dataset = dict(
    train=dict(type='SyntheticDataset', length={train}, ignore_index=-1,
               image_size=({size}, {size}), pipeline='{train_yaml}'),
    val=dict(type='SyntheticDataset', length={val}, ignore_index=-1,
             image_size=({size}, {size}), seed=1, return_ori_seg_gt=True,
             pipeline='{val_yaml}'))
"""
# the val CLI's mIoU on the train run's best.pth against the train run's
# own validation (the same bf16 forward on the same images), in points
CLI_MIOU_TOL = 0.05
# Kvasir-SEG image sizes (rows, columns) for the ragged evaluator path on
# the card, from the smallest to the largest this check takes; K2 runs one
# pixel a thread where rows x columns is not a multiple of 4
KVASIR_SIZES = [(529, 622), (576, 720), (622, 529), (720, 576),
                (913, 1002), (1010, 1280), (1024, 1280), (1072, 1350)]
# train steps a block when timing the fused amp step with deterministic
# algorithms on and off
DETERMINISM_STEPS = 3
# phase 18, SegFormer: MiT-B2 (16 attention layers) serving at 8 x 640²,
# training at the SegFormer schedule's 16 x 640²; the float64 agreement
# step at MiT-B0 (8 layers) on 4 x 256²; each train step's bilinear
# resizes under grad: SegFormerHead's three coarser scales to the 1/4 map
# and the loss's resize of the logits
SEGFORMER_CONFIG = ROOT / "configs/network/segformer/segformer_mit-b2.py"
SEGFORMER_AGREE_CONFIG = ROOT / "configs/network/segformer/segformer_mit-b0.py"
SEGFORMER_SCHEDULE = ROOT / "configs/schedule/segformer_schedule.py"
SEGFORMER_BATCH, SEGFORMER_IMAGE_SIZE = 8, 640
MIT_B2_LAYERS, MIT_B0_LAYERS = 16, 8
SEGFORMER_AGREE_BATCH, SEGFORMER_AGREE_SIZE = 4, 256
SEGFORMER_RESIZES = 4
# MiT's attention per stage: (N, h, Lq, Lk, d) of the paths phases 18 and
# 19 drive, in the dtypes each runs, with or without the backward:
# SegFormer-B2's float32 and amp train steps and UPerNet-MiT-B0's amp steps
# (and its float32 step beside them) at 16 x 640², SegFormer-B2's serving,
# validation and val CLI at 8 x 640² (float32, amp), UPerNet-MiT-B0's
# serving and validation at 8 x 512² (float32)
MIT_CASES = [  # name, batch, image size, head dim, dtypes, backward
    ("MiT-B2 train", 16, 640, 64, (torch.float32, torch.bfloat16), True),
    ("MiT-B0 train", 16, 640, 32, (torch.float32, torch.bfloat16), True),
    ("MiT-B2 serve", 8, 640, 64, (torch.float32, torch.bfloat16), False),
    ("MiT-B0 serve", 8, 512, 32, (torch.float32,), False),
]
# rows of q (K3, K4) or of k (K5) a CTA of the flash kernels owns
FLASH_ROWS_PER_CTA = 128
# phase 19, the pyramid heads: serving at 8 x 512², two amp train steps at
# 16 x 640² under deterministic algorithms; a step's bilinear resizes
# under grad: UPerHead's four PPM upsamples, three top-down and three
# fpn-output resizes and the decode and aux losses' two; PSPHead's four
# PPM upsamples and the two losses'
UPERNET_CONFIG = ROOT / "configs/network/upernet/upernet_mit-b0.py"
UPERNET_R50_CONFIG = ROOT / "configs/network/upernet/upernet_r50.py"
PSPNET_CONFIG = ROOT / "configs/network/pspnet/pspnet_r50-d8.py"
PYRAMID_BATCH, PYRAMID_IMAGE_SIZE = 8, 512
UPERNET_RESIZES, PSPNET_RESIZES = 12, 6
# SegFormer-B2's resizes at 16 x 640² (the head's 768 channels to 160²,
# the logits to 640²) and PSPNet's PPM at 16 x 640² (scales 1 and 6 to
# the 80² map); (N, C, h, w) -> (H, W)
SEGFORMER_RESIZE_SHAPES = [((16, 768, 80, 80), (160, 160)),
                           ((16, 768, 40, 40), (160, 160)),
                           ((16, 768, 20, 20), (160, 160)),
                           ((16, 2, 160, 160), (640, 640))]
PSPNET_RESIZE_SHAPES = [((16, 512, 1, 1), (80, 80)),
                        ((16, 512, 6, 6), (80, 80))]


def upernet_resizes(channels, n=16):
    """UPerHead's resizes under grad at n x 640² on ``channels``: the PPM's
    four upsamples to the 20² map, the three top-down steps and the three
    fpn outputs to the 160² map."""
    return ([((n, channels, s, s), (20, 20)) for s in (1, 2, 3, 6)]
            + [((n, channels, s, s), (2 * s, 2 * s)) for s in (20, 40, 80)]
            + [((n, channels, s, s), (160, 160)) for s in (80, 40, 20)])


# the rest of the pyramid heads' amp steps (bf16 only): UPerNet's on MiT-B0
# (256 channels) and on ResNet-50 (512; Swin-T's and ConvNeXt-T's are the
# same shapes), its aux loss's resize from 40², PSPNet's PPM at scales 2
# and 3; UPerNet-BEiT-B's and MAE-B's at their schedule's 8 x 640² (768
# channels) with their losses' resizes
PYRAMID_RESIZE_SHAPES = [*upernet_resizes(256), *upernet_resizes(512),
                         ((16, 2, 40, 40), (640, 640)),
                         ((16, 512, 2, 2), (80, 80)),
                         ((16, 512, 3, 3), (80, 80)),
                         *upernet_resizes(768, n=8),
                         ((8, 2, 160, 160), (640, 640)),
                         ((8, 2, 40, 40), (640, 640))]
# phase 20, UPerNet's backbone family: each config served at 8 x 512²,
# validated over two val batches, two amp train steps at its schedule's
# train batch of 640² (Swin and ConvNeXt: the SegFormer schedule; BEiT and
# MAE: the BEiT fine-tuning schedule, AdamW with layer decay), each step
# UPerHead's 12 bilinear resizes under grad (BEiT's and MAE's bicubic
# table resamples are matrix products, no kernel)
BEIT_SCHEDULE = ROOT / "configs/schedule/beit_finetune_schedule.py"
BEIT_CONFIG = ROOT / "configs/network/beit/upernet_beit-b.py"
SWIN_CONFIG = ROOT / "configs/network/upernet/upernet_swin-t.py"
BACKBONE_CASES = [  # name, config, schedule
    ("upernet_swin-t", SWIN_CONFIG, SEGFORMER_SCHEDULE),
    ("upernet_swin-t-w8", ROOT / "configs/network/upernet/"
     "upernet_swin-t-w8.py", SEGFORMER_SCHEDULE),
    ("upernet_convnext-t", ROOT / "configs/network/upernet/"
     "upernet_convnext-t.py", SEGFORMER_SCHEDULE),
    ("upernet_beit-b", BEIT_CONFIG, BEIT_SCHEDULE),
    ("upernet_mae-b", ROOT / "configs/network/mae/upernet_mae-b.py",
     BEIT_SCHEDULE)]
# the float32 agreement steps of Swin-T and BEiT-B (phases 10 and 13)
BACKBONE_AGREE_BATCH, BACKBONE_AGREE_SIZE = 2, 224
# BEiT-B's relative-position tables at 640²: a 27² field of 12 heads to 79²,
# gathered by a (1601, 1601) index from 79² + 3 rows
BEIT_TABLE_FIELD, BEIT_TABLE_GRID = (1, 12, 27, 27), (79, 79)
BEIT_TOKENS = 1601
# phase 21, mask classification: Mask2Former-R50 serving at bench.py's
# whole-image geometry (16 x 640²), training at its train geometry (8 x
# 640²) under the kvasir schedule, validation over two batches of 8, the
# float64 agreement step at 2 x 256²; MaskFormer-R50 and Mask2Former-Swin-T
# served at 8 x 512².  Each train step's bilinear resizes whose backward
# runs: the pixel decoder's three top-down upsamples (the semantic logits'
# resize to the labels feeds only the accuracy, and the blocked maps' level
# resizes take no gradient)
MASK2FORMER_CONFIG = ROOT / "configs/network/maskformer/mask2former_r50.py"
MASK_SERVE_CONFIGS = [
    ("maskformer_r50", ROOT / "configs/network/maskformer/maskformer_r50.py"),
    ("mask2former_swin-t",
     ROOT / "configs/network/maskformer/mask2former_swin-t.py")]
M2F_SERVE_BATCH, M2F_SERVE_SIZE = 16, 640
M2F_TRAIN_BATCH, M2F_TRAIN_SIZE = 8, 640
M2F_VAL_BATCH = 8
M2F_AGREE_BATCH, M2F_AGREE_SIZE = 2, 256
MASK_SERVE_BATCH, MASK_SERVE_SIZE = 8, 512
M2F_RESIZES = 3
# those three upsamples at M2F_TRAIN_BATCH, on the pixel decoder's 256
# channels (the last two are also SETR's)
M2F_RESIZE_SHAPES = [((M2F_TRAIN_BATCH, 256, s, s), (2 * s, 2 * s))
                     for s in (M2F_TRAIN_SIZE // 32, M2F_TRAIN_SIZE // 16,
                               M2F_TRAIN_SIZE // 8)]
# the 10-step loop's optimizer: under the kvasir SGD (lr 0.01, momentum
# 0.9) the full-width Mask2Former diverges from its default init within a
# few steps (loss 85 -> 141 -> 853 -> 1363 -> 1.8e9 -> 6e28 -> nan on the
# card), and a non-finite cost leaves the auction bidding to max_iters.
# The JAX package diverges the same way from the same weights (its losses
# and the port's agree step for step while both grow 10⁴-fold in four
# steps: tests/test_torch_port_maskformer.py, the slow
# test_kvasir_sgd_diverges_as_in_the_jax_package).  The SegFormer
# schedule's AdamW (the transformer heads' optimizer of this repo) trains
# it.  The agreement step and the train CLI keep the kvasir schedule: one
# to three steps stay finite
MASK_TRAIN_SCHEDULE = ROOT / "configs/schedule/segformer_schedule.py"
# phase 22, the ViT decoders, Twins, PoolFormer-FPN and ResNetV1d: each
# config served at PYRAMID_BATCH x PYRAMID_IMAGE_SIZE² in float32 and under
# amp (held against the port on the CPU on a 320² window), validated over
# two val batches, two deterministic amp steps at its schedule's train
# batch of AUG_SIZE² (the kvasir SGD for the ViT family and PSPNet, the
# SegFormer schedule's AdamW for Twins and PoolFormer); per config its
# attention layers (flash launches a forward: the ViT's 12, Segmenter's
# decoder's 2 more, PCPVT-S's 16 and SVT-S's 9 global layers; SVT's local
# windows take biased_attention) and its bilinear resizes under grad a
# step: SETR-MLA's four 4x upsamples and two losses; MLN's 4x, 2x and
# 0.5x levels and UPerHead's 12; DPT's four 2x fusion upsamples and its
# loss; Segmenter's loss; UPerHead's 12 on Twins; the FPN head's six 2x
# upsamples and its loss (the FPN's own top-down resizes are nearest);
# PSPNet's 6; and of those, the ones that stay float32 under amp:
# Segmenter's loss, on the float32 masks its head makes, as the JAX head's
DECODER_CASES = [  # name, config, schedule, attention layers, resizes,
    # float32 resizes under amp
    ("setr_mla_vit-s", ROOT / "configs/network/setr/setr_mla_vit-s.py",
     SCHEDULE, 12, 6, 0),
    ("upernet_vit-b_mln",
     ROOT / "configs/network/upernet/upernet_vit-b_mln.py", SCHEDULE, 12,
     15, 0),
    ("dpt_vit-s", ROOT / "configs/network/dpt/dpt_vit-s.py", SCHEDULE, 12,
     5, 0),
    ("segmenter_vit-s",
     ROOT / "configs/network/segmenter/segmenter_vit-s.py", SCHEDULE, 14,
     1, 1),
    ("twins_pcpvt-s_upernet",
     ROOT / "configs/network/twins/twins_pcpvt-s_upernet.py",
     SEGFORMER_SCHEDULE, 16, 12, 0),
    ("twins_svt-s_upernet",
     ROOT / "configs/network/twins/twins_svt-s_upernet.py",
     SEGFORMER_SCHEDULE, 9, 12, 0),
    ("fpn_poolformer_s12",
     ROOT / "configs/network/poolformer/fpn_poolformer_s12.py",
     SEGFORMER_SCHEDULE, 0, 7, 0),
    ("pspnet_r50-v1d-d8", ROOT / "configs/network/pspnet/pspnet_r50-v1d-d8.py",
     SCHEDULE, 0, 6, 0)]
# the float64 agreement steps (the kvasir SGD, as SETR's): SVT-S (windows
# padded at every stage of 256², the global layers at d = 32) and DPT (the
# class-token readout, the transposed convs)
DECODER_AGREE = ("twins_svt-s_upernet", "dpt_vit-s")
DECODER_AGREE_BATCH, DECODER_AGREE_SIZE = 2, 256
DECODER_CLI = "setr_mla_vit-s"
# the flash kernels on phase 22's paths: name, (N, h, Lq, Lk, d), the
# forward's dtypes, the backward's: the ViT-S and ViT-B (MLN) encoders and
# Segmenter's decoder (L + 2 class tokens) served at 8 x 512² and trained
# at 16 x 640², PCPVT-S's and SVT-S's stage 1 (sr 8) likewise, and
# PCPVT-S's stage 1 backward at 8 x 512², where K5 has 16 CTAs
DECODER_FLASH_CASES = [
    ("ViT-S serve", (8, 6, 1025, 1025, 64), (torch.float32, torch.bfloat16),
     ()),
    ("ViT-B serve", (8, 12, 1025, 1025, 64),
     (torch.float32, torch.bfloat16), ()),
    ("ViT-B train", (16, 12, 1601, 1601, 64), (),
     (torch.float32, torch.bfloat16)),
    ("Segmenter decoder serve", (8, 6, 1026, 1026, 64),
     (torch.float32, torch.bfloat16), ()),
    ("Segmenter decoder train", (16, 6, 1602, 1602, 64), (),
     (torch.float32, torch.bfloat16)),
    ("PCPVT-S stage 1 serve", (8, 1, 16384, 256, 64),
     (torch.float32, torch.bfloat16), ()),
    ("PCPVT-S stage 1 train", (16, 1, 25600, 400, 64), (),
     (torch.float32, torch.bfloat16)),
    ("PCPVT-S stage 1 at 8 x 512²", (8, 1, 16384, 256, 64), (),
     (torch.bfloat16,)),
    ("SVT-S stage 1 serve", (8, 2, 16384, 256, 32),
     (torch.float32, torch.bfloat16), ()),
    ("SVT-S stage 1 train", (16, 2, 25600, 400, 32), (),
     (torch.float32, torch.bfloat16))]
# the bilinear resizes of phase 22's amp steps at 16 x 640² that no earlier
# phase holds: (N, C, h, w), (H, W), the user's scale (MultiLevelNeck's
# levels, also on the odd grid of 400², 25 -> 12 at step 2), dtypes;
# SETR-MLA's 4x upsamples of 128 channels, MLN's levels of 768, DPT's
# fusion upsamples of 256, the FPN head's of 128, and the 2-class logits
# from 160² and 320² to 640²
DECODER_RESIZE_SHAPES = [
    ((16, 128, 40, 40), (160, 160), None, (torch.bfloat16,)),
    ((16, 768, 40, 40), (160, 160), (4.0, 4.0),
     (torch.float32, torch.bfloat16)),
    ((16, 768, 40, 40), (80, 80), (2.0, 2.0), (torch.bfloat16,)),
    ((16, 768, 40, 40), (20, 20), (0.5, 0.5),
     (torch.float32, torch.bfloat16)),
    ((16, 768, 25, 25), (12, 12), (0.5, 0.5),
     (torch.float32, torch.bfloat16)),
    *(((16, 256, s, s), (2 * s, 2 * s), None, (torch.bfloat16,))
      for s in (20, 40, 80, 160)),
    *(((16, 128, s, s), (2 * s, 2 * s), None, (torch.bfloat16,))
      for s in (20, 40, 80)),
    ((16, 2, 160, 160), (640, 640), None, (torch.bfloat16,)),
    ((16, 2, 320, 320), (640, 640), None, (torch.bfloat16,))]
# align_corners=True, which no config of the main paths takes: UPerNet's
# 2x top-down step on 256 channels, in both dtypes
ALIGN_CORNERS_RESIZES = [((16, 256, 40, 40), (80, 80))]
# the resize-backward rows of the kernels line: SETR's largest upsample
# and DeepLabV3's 640² image pool
RESIZE_HEADLINES = [((8, 256, 160, 160), (320, 320)),
                    ((16, 512, 1, 1), (80, 80))]
# phase 23, SegNeXt-T, PIDNet-S and DDRNet-23-slim: each served whole at
# REALTIME_BATCH x REALTIME_IMAGE_SIZE² (bench.py's geometry) in float32
# and under amp, validated over two val batches, two deterministic amp
# steps at its schedule's train batch of AUG_SIZE² (SegNeXt: the SegFormer
# schedule's AdamW; PIDNet and DDRNet: the kvasir SGD) and a profiled
# third; per config its bilinear resizes under grad a step: SegNeXt's
# LightHamHead levels 2-3 to level 1 and its loss; PIDNet-S's two PagFMs
# (the gate's f_i and x_i each), its two diff taps, PAPPM's four pools, the
# context and the three heads' logits; DDRNet's two compressions, DAPPM's
# four pools, the context and the two heads' logits
REALTIME_CASES = [  # name, config, schedule, resizes a step
    ("segnext_mscan-t", ROOT / "configs/network/segnext/segnext_mscan-t.py",
     SEGFORMER_SCHEDULE, 3),
    ("pidnet-s", ROOT / "configs/network/pidnet/pidnet-s.py", SCHEDULE, 14),
    ("ddrnet_23-slim", ROOT / "configs/network/ddrnet/ddrnet_23-slim.py",
     SCHEDULE, 9)]
REALTIME_BATCH, REALTIME_IMAGE_SIZE = 16, 640
REALTIME_AGREE = "pidnet-s"
REALTIME_AGREE_BATCH, REALTIME_AGREE_SIZE = 2, 256
# those resizes at 16 x 640² in bf16 (the amp steps) that no earlier phase
# holds; the logits' (16, 2, 80²) -> 640² is DeepLabV3's
REALTIME_RESIZE_SHAPES = [
    ((16, 160, 40, 40), (80, 80)), ((16, 256, 20, 20), (80, 80)),
    *(((16, c, s, s), (80, 80)) for c in (32, 64) for s in (40, 20)),
    *(((16, c, s, s), (10, 10)) for c in (96, 128) for s in (5, 3, 2, 1)),
    ((16, 128, 10, 10), (80, 80)), ((16, 1, 80, 80), (640, 640))]
# phase 24, the non-local head family and DeepLabV3+ on ResNetV1c-50-d8:
# per config its bilinear resizes under grad in an amp step at 16 x 640²:
# the decode and aux logits 80² -> 640² (DA's three decode logits, each
# with its loss), DeepLabV3+'s image pool 1² -> 80², ASPP output 80² ->
# 160² (c1's size) and logits 160² -> 640², PSA's two shrinks 80² -> 40²
# and its projection 40² -> 80²
NONLOCAL_CASES = [  # name, config, resizes a step
    (Path(config).name[:-3], ROOT / "configs/network" / config, resizes)
    for config, resizes in (("deeplabv3/deeplabv3plus_r50-d8.py", 4),
                            ("nonlocal_net/nonlocal_r50-d8.py", 2),
                            ("dnlnet/dnl_r50-d8.py", 2),
                            ("gcnet/gcnet_r50-d8.py", 2),
                            ("ccnet/ccnet_r50-d8.py", 2),
                            ("danet/danet_r50-d8.py", 4),
                            ("ann/ann_r50-d8.py", 2),
                            ("isanet/isanet_r50-d8.py", 2),
                            ("emanet/emanet_r50-d8.py", 2),
                            ("psanet/psanet_r50-d8.py", 5))]
NONLOCAL_BATCH, NONLOCAL_IMAGE_SIZE = 16, 640
NONLOCAL_AGREE_SIZE = 320
# those resizes in bf16 that no earlier phase holds
NONLOCAL_RESIZE_SHAPES = [((16, 512, 80, 80), (160, 160)),
                          ((16, 512, 80, 80), (40, 40)),
                          ((16, 2048, 40, 40), (80, 80))]
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


def kernel_events(prof):
    """A profile's device activities (kernels, copies, fills) without the
    device ranges of ``record_function`` annotations (the augmentation's
    and each transform's, the optimizer's step), which span kernels that
    are counted on their own."""
    ranges = set(aug.TRANSFORMS) | {"augmentation"}
    return [evt for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and evt.key not in ranges]


def kernel_times(fn, flush=None, runs=1):
    """Device milliseconds per run of every CUDA kernel ``fn()`` launches,
    from ``torch.profiler`` (kernel name -> ms), the wall milliseconds per
    run under the profiler, and each kernel's launches (name -> count)."""
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
    times, counts = {}, {}
    for evt in kernel_events(prof):
        times[evt.key] = evt.self_device_time_total / 1e3 / runs
        counts[evt.key] = evt.count
    return times, wall, counts


def device_ms(fn, kernel, flush, runs=20, attempts=5, profiles=1):
    """The device time of one call of ``fn``: of the kernel whose name
    contains ``kernel`` (launched once a call) or, with ``kernel=None``, of
    every kernel but the flush's own, with ``flush()`` before each call.
    A profile that holds no device activity at all, or fewer launches of
    ``kernel`` than calls (the profiler now and then drops a trace or part
    of one), is taken again, up to ``attempts`` times, and said so.  Each
    kernel's time is the mean of the launches it recorded times its
    launches in one call (``kernel``: one; else as a profile of one call
    counts them), so launches the profiler dropped count at their mean.
    With ``profiles`` > 1, the median of that many profiles' times: now and
    then one profile of a kernel reads about half of the time of the
    others and of its CUDA events."""
    skip = flush_kernels(flush) if flush is not None else ()
    per_call = {} if kernel else one_call_kernels(fn)
    totals = []
    for _ in range(profiles):
        for attempt in range(attempts):
            times, _, counts = kernel_times(fn, flush, runs)
            launched = sum(n for name, n in counts.items()
                           if kernel and kernel in name)
            if times and (not kernel or launched >= runs):
                break
            print(f"profile {attempt + 1} of {kernel}: {len(times)} kernels, "
                  f"{launched} of {runs} launches", flush=True)
        hits = [ms * runs / counts[name]
                * (1 if kernel else per_call.get(name, counts[name] / runs))
                for name, ms in times.items()
                if (kernel in name if kernel else name not in skip)]
        if not hits:
            raise AssertionError(f"the profiler saw no {kernel} kernel: "
                                 f"{sorted(times)}")
        totals.append(sum(hits))
    return statistics.median(totals)


@functools.lru_cache(maxsize=None)
def flush_kernels(flush):
    """The names of the kernels that ``flush()`` launches."""
    names = set(one_call_kernels(flush))
    if not names:
        raise AssertionError("the profiler saw no kernel of the L2 flush")
    return names


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_count_err(out, ref):
    return max(float((a - b).abs().max()) if a.numel() else 0.0
               for a, b in zip(out, ref))


def one_call_kernels(fn, attempts=3):
    """The device activities of one warm call of ``fn`` (kernels, and
    copies or fills if any), name -> count, from ``torch.profiler``; an
    empty trace is taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {evt.key: evt.count for evt in kernel_events(prof)}
        if kernels:
            break
    return kernels


def confusion_library(logits, pred, gt, num_classes):
    """The yardsticks of the confusion kernel: ``torch.argmax`` over the
    classes (K1's first call) and ``torch.bincount`` of gt * C + pred over
    the valid pixels (K1's second call, and K2's one), whose (C, C)
    confusion matrix holds the three counts.  Each as a function of no
    arguments, and the counts from the matrix."""
    valid = (gt != IGNORE) & (gt >= 0) & (gt < num_classes)
    pairs = gt[valid].long() * num_classes + pred[valid].long()

    def argmax():
        return torch.argmax(logits, dim=1)

    def bincount():
        return torch.bincount(pairs, minlength=num_classes ** 2)

    matrix = bincount().view(num_classes, num_classes).float()  # [gt, pred]
    return argmax, bincount, (matrix.diagonal(), matrix.sum(0),
                              matrix.sum(1))


def kernel_phase(device, l2_flush, l2_read):
    """The confusion kernel against its plain version and its yardsticks,
    each timed call after the 96 MB write of ``l2_flush`` (as in the other
    phases).  That write leaves the L2 full of dirty lines, which a kernel
    reading 17-40 MB (C = 2) must write back as it reads; so the kernel's
    device time is also taken after a read of ``l2_read`` that leaves the
    L2 clean (``*_clean_l2``).  The rows, and the kernel instances
    launched (name -> launches)."""
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    confusion.instances.clear()
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
        argmax, bincount, library_counts = confusion_library(
            logits, pred, gt, num_classes)
        library_err = max_count_err(library_counts,
                                    confusion.histograms_plain(*args))
        torch.cuda.synchronize()
        if err != 0 or label_err != 0 or library_err != 0:
            raise AssertionError(
                f"kernel != plain at {(n, c, h, w)} {dtype}: max count error "
                f"{err} (logits entry), {label_err} (labels entry), "
                f"{library_err} (argmax + bincount)")

        def logits_call():
            return confusion.confusion_histograms(*args)

        def labels_call():
            return confusion.confusion_histograms_from_labels(*label_args)

        # one call of each entry is one device kernel: no fill, no cast
        calls = {}
        for entry, fn in (("logits", logits_call), ("labels", labels_call)):
            calls[entry] = one_call_kernels(fn)
            if (len(calls[entry]) != 1
                    or "confusion_kernel" not in next(iter(calls[entry]))
                    or list(calls[entry].values()) != [1]):
                raise AssertionError(f"one {entry} call at {(n, c, h, w)} "
                                     f"{dtype} ran {calls[entry]}, not one "
                                     f"confusion kernel")
        flush, clean = l2_flush.zero_, l2_read.max
        counts_bytes = gt.numel() * 4 + 3 * num_classes * 4
        bound, bound_by = bound_ms(
            logits.numel() * logits.element_size() + counts_bytes,
            logits.numel(), PEAK_FLOPS[torch.float32])
        labels_bound, _ = bound_ms(pred.numel() * 4 + counts_bytes, 0,
                                   PEAK_FLOPS[torch.float32])
        row = dict(shape=[n, c, h, w], dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, labels_max_abs_err=label_err,
                   one_call=calls,
                   ms=cuda_ms(logits_call, flush),
                   device_ms=device_ms(logits_call, "confusion_kernel",
                                       flush),
                   device_ms_clean_l2=device_ms(logits_call,
                                                "confusion_kernel", clean),
                   plain_ms=cuda_ms(lambda: confusion.histograms_plain(*args),
                                    flush),
                   argmax_ms=cuda_ms(argmax, flush),
                   argmax_device_ms=device_ms(argmax, None, flush),
                   bincount_ms=cuda_ms(bincount, flush),
                   bincount_device_ms=device_ms(bincount, None, flush),
                   labels_ms=cuda_ms(labels_call, flush),
                   labels_device_ms=device_ms(labels_call, "confusion_kernel",
                                              flush),
                   labels_device_ms_clean_l2=device_ms(
                       labels_call, "confusion_kernel", clean),
                   labels_plain_ms=cuda_ms(
                       lambda: confusion.histograms_from_labels_plain(
                           *label_args), flush),
                   bound_ms=bound, bound_by=bound_by,
                   labels_bound_ms=labels_bound)
        # K1's yardstick is two calls (argmax, then bincount), K2's one
        row.update(
            library_ms=row["argmax_ms"] + row["bincount_ms"],
            library_device_ms=(row["argmax_device_ms"]
                               + row["bincount_device_ms"]),
            labels_library_ms=row["bincount_ms"],
            labels_library_device_ms=row["bincount_device_ms"],
            bound_share=bound / row["device_ms"],
            bound_share_clean_l2=bound / row["device_ms_clean_l2"],
            labels_bound_share=labels_bound / row["labels_device_ms"],
            labels_bound_share_clean_l2=(labels_bound
                                         / row["labels_device_ms_clean_l2"]))
        print("kernel:", json.dumps(row), flush=True)
        shares = {k: v for k, v in row.items() if "bound_share" in k}
        if max(shares.values()) > 1:
            raise AssertionError(f"a bound share above 100 % at "
                                 f"{(n, c, h, w)} {dtype}: {shares}")
        rows.append(row)
        del logits, gt, pred, args, label_args, argmax, bincount
    return rows, dict(confusion.instances)


def projection_views(gen, device, dtype, n, h, lq, lk, d, fused_kv):
    """q, k and v as the models pass them: strided (N, L, h, d) views of one
    fused qkv projection (the ViT), or with ``fused_kv`` q alone and k, v
    views of one fused kv projection (MiT's spatially reduced attention,
    also at sr 1)."""
    def proj(length, parts):
        x = torch.randn((n, length, parts * h * d), generator=gen,
                        device=device).to(dtype)
        return [t.unflatten(-1, (h, d)) for t in x.split(h * d, dim=-1)]
    if not fused_kv:
        return proj(lq, 3)
    return proj(lq, 1) + proj(lk, 2)


def mit_rows(backward):
    """The flash phases' MiT rows: ((N, h, Lq, Lk, d), dtype, name) for
    each stage of each case of MIT_CASES (with a backward when
    ``backward``); stage i runs on the map at stride 4 · 2^(i-1), its keys
    on the map at stride 32 (sr ratios 8, 4, 2, 1), heads 1, 2, 5, 8."""
    return [((n, h, (size // stride) ** 2, (size // 32) ** 2, d), dtype,
             f"{case} stage {i + 1}")
            for case, n, size, d, dtypes, bwd in MIT_CASES
            if bwd or not backward
            for i, (h, stride) in enumerate(zip((1, 2, 5, 8), (4, 8, 16, 32)))
            for dtype in dtypes]


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
    {"REG": n, "STACK": n, "SHARED": n, "LOCAL": n}, the most of any
    instance where several share a name (instances on a type)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", lib._name], capture_output=True,
                         text=True, check=True).stdout
    usage = {}
    for name, fields in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", out):
        use = usage.setdefault(kernel_name(name), {})
        for key, val in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                   fields):
            use[key] = max(int(val), use.get(key, 0))
    return usage


def decoder_rows(backward):
    """The flash phases' rows of phase 22's paths: ((N, h, Lq, Lk, d),
    dtype, None, name) for each case of DECODER_FLASH_CASES and each of
    its forward's (or, with ``backward``, its backward's) dtypes."""
    return [(shape, dtype, None, name)
            for name, shape, fwd, bwd in DECODER_FLASH_CASES
            for dtype in (bwd if backward else fwd)]


def yardstick(restated, timer, *args):
    """``timer(*args)``, the time of a yardstick (the plain version, SDPA,
    ``F.interpolate``'s backward) beside a kernel's row, or None for a
    ``restated`` row, which keeps every check and the kernel's own times
    while its yardsticks stand in PERF.md's kernel table: the flash
    kernels' MiT and phase 22 rows, the resize backward's rows of the
    phases before 23."""
    return None if restated else timer(*args)


def flash_phase(device, l2_flush):
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for (n, h, lq, lk, d), dtype, mit, path in (
            [(*row, None, None) for row in FLASH_SHAPES]
            + [(*row, None) for row in mit_rows(backward=False)]
            + decoder_rows(backward=False)):
        q, k, v = projection_views(gen, device, dtype, n, h, lq, lk, d,
                                   lq != lk or mit is not None)
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
        split = dtype == torch.float32
        repeat = not split or all(
            torch.equal(a, b) for a, b in zip(
                (o, lse), flash_attention.flash_attention_forward(*args)))
        split_exact = not split or all(
            torch.equal(got, flash_attention.split_bf16x3_plain(t))
            for got, t in zip(flash_attention.split_bf16x3(q, k, v),
                              (q, k, v)))
        torch.cuda.synchronize()
        if not within or not repeat or not split_exact:
            raise AssertionError(
                f"flash kernel != plain at {(n, h, lq, lk, d)} {dtype}: max "
                f"abs error {o_err} (o), {lse_err} (lse); the same bits on "
                f"a second call {repeat}; split = plain {split_exact}")
        del o, lse, ref_o, ref_lse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (N, h, L, d)
        flush = l2_flush.zero_
        n_bytes = (q.element_size() * d * n * h * (2 * lq + 2 * lk)
                   + 4 * n * h * lq)
        work = 4.0 * n * h * lq * lk * d
        # float32 takes six bf16 products per product on the tensor cores
        # (the route taken: the bound), where the CUDA cores would do the
        # float32 products at 67 TFLOP/s
        bound, bound_by = (bound_ms(n_bytes, SPLIT_PRODUCTS * work,
                                    PEAK_FLOPS[torch.bfloat16]) if split
                           else bound_ms(n_bytes, work, PEAK_FLOPS[dtype]))
        row = dict(
            shape=[n, h, lq, lk, d], dtype=str(dtype).replace("torch.", ""),
            max_abs_err=o_err, lse_max_abs_err=lse_err,
            ms=cuda_ms(lambda: flash_attention.flash_attention_forward(*args),
                       flush),
            device_ms=device_ms(
                lambda: flash_attention.flash_attention_forward(*args),
                FLASH_FWD_KERNEL[dtype], flush),
            plain_ms=yardstick(mit or path, cuda_ms, lambda: (
                flash_attention.attention_plain(*args)), flush),
            sdpa_ms=yardstick(mit or path, cuda_ms, lambda: (
                F.scaled_dot_product_attention(qt, kt, vt, scale=scale)),
                flush),
            sdpa_device_ms=yardstick(mit or path, device_ms, lambda: (
                F.scaled_dot_product_attention(qt, kt, vt, scale=scale)),
                None, flush),
            bound_ms=bound, bound_by=bound_by,
            ctas=math.ceil(lq / FLASH_ROWS_PER_CTA) * h * n,
            mit=mit, path=path)
        if split:
            def split_call():
                return flash_attention.split_bf16x3(q, k, v)

            # reads q, k and v once, writes three bf16 parts of each
            split_bound = bound_ms(
                (4 + 3 * 2) * (q.numel() + k.numel() + v.numel()), 0,
                PEAK_FLOPS[torch.float32])
            row.update(
                repeats_bit_for_bit=repeat, split_exact=split_exact,
                cuda_core_bound_ms=bound_ms(n_bytes, work,
                                            PEAK_FLOPS[torch.float32])[0],
                split_ms=cuda_ms(split_call, flush),
                split_device_ms=device_ms(split_call, "split_bf16x3_kernel",
                                          flush),
                split_bound_ms=split_bound[0], split_bound_by=split_bound[1])
            row["forward_device_ms"] = (row["device_ms"]
                                        + row["split_device_ms"])
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


@functools.lru_cache(maxsize=None)
def synthetic_item(idx, size):
    """``make_synthetic_item(idx, (size, size))``, drawn once a run: drawn
    anew for every batch (about 60 ms an item at 640² on the host), the
    items took up to a third of a phase's wall time."""
    return make_synthetic_item(idx, (size, size))


def synthetic_batch(device, batch, size):
    """Normalised NHWC images (the ``inference_model`` input), the same as
    NCHW, and the int32 masks."""
    items = [synthetic_item(i, size) for i in range(batch)]
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
    order one.  PoolFormer's layer scales (1e-5 at init, which would leave
    every block near the identity) are drawn in [0.5, 1], Segmenter's raw
    patch and class projections at unit gain, MSCAN's layer scales (1e-2
    at init) in [0.1, 0.3], the classifiers of PIDNet's and DDRNet's
    segmentheads at unit gain (at std 0.01 no boundary logit would reach
    the 0.8 gate), and the scalar ``gamma`` of CCNet's and DANet's
    attention (0 at init, which would leave the attention out of the
    output) in [0.5, 1]."""
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
                if m.bias is not None:
                    fill(m.bias, -0.1, 0.1)
            elif isinstance(m, PoolFormerBlock) and m.scaled:
                fill(m.layer_scale_1, 0.5, 1.0)
                fill(m.layer_scale_2, 0.5, 1.0)
            elif isinstance(m, SegmenterMaskTransformerHead):
                unit_gain(m.proj_patch)
                unit_gain(m.proj_classes)
            elif isinstance(m, MSCABlock):
                fill(m.layer_scale_1, 0.1, 0.3)
                fill(m.layer_scale_2, 0.1, 0.3)
            elif isinstance(m, pid_head._BasePIDHead):
                unit_gain(m.cls.weight)
            elif isinstance(m, (CrissCrossAttention, PAM, CAM)):
                fill(m.gamma, 0.5, 1.0)
        for head in (model.decode_head, model.auxiliary_head):
            if getattr(head, "conv_seg", None) is not None:
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
    for counts in (flash_attention.launches, confusion.launches,
                   resize_backward.launches):
        for key in counts:
            counts[key] = 0
    confusion.instances.clear()


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
    instances = dict(confusion.instances)
    metrics = evaluator.compute_metrics()
    check_metrics(metrics)
    if launches["logits"] == 0:
        raise AssertionError("the evaluator never launched the kernel")
    print("slice: " + json.dumps(dict(
        batch=list(x_nchw.shape), ms_per_batch=latency, launches=launches,
        confusion_instances=instances, metrics=summarize(metrics))),
        flush=True)
    for mode, test_cfg in (("whole", dict(mode="whole")), ("slide", SLIDE)):
        model.test_cfg = test_cfg
        print_breakdown(f"deeplabv3 {mode}", lambda: model.inference(x_nchw))
    return model, x_nchw, launches, instances


def kernel_class(name):
    """Coarse class of a CUDA kernel name for the time breakdown."""
    low = name.lower()
    for key, words in (("flash fwd", ("flash_fwd_bf16x3_kernel",)),
                       ("flash fwd bf16", ("flash_fwd_sm90_kernel",)),
                       ("flash dq", ("flash_bwd_dq_bf16x3_kernel",)),
                       ("flash dkv", ("flash_bwd_dkv_bf16x3_kernel",)),
                       ("flash split", ("split_bf16x3_kernel",)),
                       ("flash dq bf16", ("flash_bwd_dq_sm90_kernel",)),
                       ("flash dkv bf16", ("flash_bwd_dkv_sm90_kernel",)),
                       ("confusion", ("confusion_kernel",)),
                       ("resize backward", ("resize_backward_kernel",)),
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
        times, wall, _ = kernel_times(fn)
    busy = sum(times.values())
    classes = {}
    for name, ms in times.items():
        classes[kernel_class(name)] = classes.get(kernel_class(name), 0) + ms
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    print(f"{what} breakdown: " + json.dumps(dict(
        wall_ms=wall, device_ms=busy, busy_share=busy / wall,
        by_class=dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        top_kernels=[[name[:90], ms] for name, ms in top])), flush=True)


def serve(model, amp, batch, size, layers, what, out_dtype=None, runs=5):
    """Serving under the float32 or (``amp``) the bf16 policy: ``runs`` + 3
    forwards of ``batch`` synthetic ``size``² images through
    ``inference_model``, ``model.inference`` and ``SegEvaluator``, with
    exactly ``layers`` launches per forward of the policy's flash forward
    kernel (and as many splits in float32) and none of the other one; the
    probabilities in
    ``out_dtype`` (by default the policy's).  The batch, the latency, the
    launches, the peak memory and the metrics."""
    x, x_nchw, masks = synthetic_batch(next(model.parameters()).device,
                                       batch, size)
    shape = (batch, size, size)
    dtype = out_dtype or (torch.bfloat16 if amp else torch.float32)
    forwards = 0

    def serve():
        nonlocal forwards
        forwards += 1
        return inference_model(model, x)

    reset_counts()
    evaluator = new_evaluator()
    device = next(model.parameters()).device
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad(), policy_scope("bf16" if amp else "fp32"):
        check_class_map(serve(), shape, f"{what} whole, {dtype}")
        latency = timed_batches(serve, runs)
        forwards += 1
        probs = model.inference(x_nchw)
        if probs.dtype != dtype or not bool(torch.isfinite(probs).all()):
            raise AssertionError(f"{what}: {probs.dtype} output, or not "
                                 f"finite")
        evaluator.process(0, {"whole": probs}, {"ori_gt": masks})
    torch.cuda.synchronize()
    flash, other = (flash_attention.launches[k] for k in
                    (("forward_bf16", "forward") if amp
                     else ("forward", "forward_bf16")))
    splits = flash_attention.launches["split_bf16x3"]
    launches = dict(flash=flash, split=splits,
                    confusion=confusion.launches["logits"],
                    confusion_instances=dict(confusion.instances))
    metrics = evaluator.compute_metrics()
    check_metrics(metrics)
    if (flash != layers * forwards or other != 0
            or splits != (0 if amp else flash)):
        raise AssertionError(f"{what}: {flash} flash launches ({other} of "
                             f"the other forward kernel, {splits} splits) "
                             f"for {forwards} forwards of {layers} layers, "
                             f"{dtype}")
    if launches["confusion"] == 0:
        raise AssertionError("the evaluator never launched the kernel")
    return x_nchw, dict(batch=list(x_nchw.shape), ms_per_batch=latency,
                        peak_memory_gb=torch.cuda.max_memory_allocated(
                            device) / 1e9,
                        forwards=forwards, launches=launches,
                        metrics=summarize(metrics))


def setr_slice_phase(device):
    model = init_model(SETR_CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("SETR's aux head is missing")
    if model.backbone.depth != SETR_LAYERS:
        raise AssertionError(f"ViT-S has {model.backbone.depth} layers")
    randomize_(model, seed=0)
    x_nchw, row = serve(model, False, SETR_BATCH, SETR_IMAGE_SIZE,
                        SETR_LAYERS, "setr")
    print("setr slice: " + json.dumps(row), flush=True)
    print_breakdown("setr", lambda: model.inference(x_nchw))
    return model, x_nchw, row["launches"]


def amp_slice_phase(model, backbone, batch, size, layers, what):
    """Serving under the schedule's bf16 policy (``serve``), then the
    logits against the same bf16 forward with plain attention on the card
    (``backbone``'s ``multihead_attention`` forced plain), and the share
    of pixels whose class matches the float32 forward."""
    x_nchw, row = serve(model, True, batch, size, layers, what)
    plain = functools.partial(backbone.multihead_attention, force="plain")
    with torch.no_grad():
        fp32 = model.encode_decode(x_nchw).float()
        with policy_scope("bf16"):
            amp = model.encode_decode(x_nchw).float()
            with mock.patch.object(backbone, "multihead_attention", plain):
                ref = model.encode_decode(x_nchw).float()
    scale = float(ref.abs().max())
    err = float((amp - ref).abs().max())
    agree = float((amp.argmax(1) == ref.argmax(1)).float().mean())
    if err > AMP_LOGIT_SHARE * scale or agree < AMP_ARGMAX_AGREE:
        raise AssertionError(f"{what} amp logits vs plain attention: max abs "
                             f"error {err} of max |logit| {scale}, argmax "
                             f"agreement {agree}")
    row.update(vs_plain_attention=dict(max_abs_err=err, max_abs_logit=scale,
                                       argmax_agreement=agree),
               argmax_agreement_with_float32=float(
                   (amp.argmax(1) == fp32.argmax(1)).float().mean()))
    print(f"{what} amp slice: " + json.dumps(row), flush=True)
    with policy_scope("bf16"):
        print_breakdown(f"{what} amp", lambda: model.inference(x_nchw))
    return row["launches"]


def cpu_agreement_phase(model, x_nchw, h, w, what):
    """One window on the card and on the CPU at the slice tolerance; the
    CPU takes the card's blocked maps of a masked attention
    (``MaskBranches``) and its NMF bases (``NMFBases``: the two devices'
    generators give other bits)."""
    window = x_nchw[:1, :, :h, :w]
    record = MaskBranches()
    bases = NMFBases()
    with torch.no_grad():
        with record.recording(), bases.recording():
            gpu = model.encode_decode(window).cpu().numpy()
        with record.replaying(), bases.replaying():
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


def attention_backward_float64(q, k, v, do, scale):
    """dQ, dK and dV of softmax attention in float64 from the same inputs
    (``(N, L, h, d)``), the reference that two bf16 results are both held
    against where they part."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum("nlhd,nshd->nhls", q, k) * scale, -1)
    o = torch.einsum("nhls,nshd->nlhd", p, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("nlhd,nshd->nhls", do, v) - delta) * scale
    return (torch.einsum("nhls,nshd->nlhd", ds, k),
            torch.einsum("nhls,nlhd->nshd", ds, q),
            torch.einsum("nhls,nlhd->nshd", p, do))


def flash_backward_phase(device, l2_flush):
    """dQ and dK/dV kernels against the plain backward on the same inputs,
    and against their own second call (same bits); in float32 the split
    against its plain version (same bits); times of each kernel, the split,
    the plain backward (dQ, dK and dV together), SDPA's backward (the three
    together) and ``backward_delta``."""
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for (n, h, lq, lk, d), dtype, mit, path in (
            [(*row, None, None) for row in FLASH_BWD_SHAPES]
            + [(*row, None) for row in mit_rows(backward=True)]
            + decoder_rows(backward=True)):
        q, k, v = projection_views(gen, device, dtype, n, h, lq, lk, d,
                                   lq != lk or mit is not None)
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
        errs, tols, adjudicated = {}, {}, {}
        truth = None
        for i, (name, out, ref) in enumerate(zip(("dq", "dk", "dv"), outs,
                                                 refs)):
            atol, rtol = tols[name] = flash_bwd_tol(dtype, ref)
            diff = (out.float() - ref.float()).abs()
            errs[name] = float(diff.max())
            outside = diff > atol + rtol * ref.float().abs()
            if bool(outside.any()) and dtype == torch.bfloat16:
                # two bf16 roundings of float32 sums taken in other orders
                # may land two steps apart where the sum cancels: such an
                # element holds if the kernel is no further from the
                # float64 gradient than the plain version is, plus one
                # bf16 step of the value
                if truth is None:
                    truth = attention_backward_float64(q, k, v, do, scale)
                t = truth[i][outside]
                got, want = out.double()[outside], ref.double()[outside]
                step = torch.finfo(torch.bfloat16).eps * want.abs()
                held = (got - t).abs() <= (want - t).abs() + step
                adjudicated[name] = int(outside.sum())
                outside[outside.clone()] = ~held
            if bool(outside.any()):
                raise AssertionError(
                    f"flash backward kernel != plain at {(n, h, lq, lk, d)} "
                    f"{dtype}: max abs error of {name} {errs[name]}")
        del truth
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
            max_abs_err=errs, tolerance=tols,
            held_against_float64=adjudicated, repeats_bit_for_bit=repeat,
            dq_ms=cuda_ms(dq_call, flush),
            dq_device_ms=device_ms(dq_call, dq_kernel, flush),
            dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
            dkv_ms=cuda_ms(dkv_call, flush),
            dkv_device_ms=device_ms(dkv_call, dkv_kernel, flush),
            dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1],
            delta_device_ms=device_ms(
                lambda: flash_attention.backward_delta(o, do), None, flush),
            plain_ms=yardstick(mit or path, cuda_ms, lambda: (
                flash_attention.attention_backward_plain(*args)), flush),
            sdpa_backward_ms=yardstick(mit or path, cuda_ms, sdpa_backward,
                                       flush),
            sdpa_backward_device_ms=yardstick(mit or path, device_ms,
                                              sdpa_backward, None, flush),
            dq_ctas=math.ceil(lq / FLASH_ROWS_PER_CTA) * h * n,
            dkv_ctas=math.ceil(lk / FLASH_ROWS_PER_CTA) * h * n,
            mit=mit, path=path)
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
                split_plain_ms=yardstick(mit or path, cuda_ms, split_plain,
                                         flush),
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


def resize_backward_phase(device, l2_flush):
    """The resize backward kernel against its plain version (the same
    bits), its own float32 result rounded once (bf16) and its second call
    (the same bits), one launch a call, at each shape of SETR's,
    DeepLabV3's and SegFormer's train steps and Mask2Former's pixel decoder
    in both dtypes and of the pyramid heads' amp steps in bf16, phase 22's
    (DECODER_RESIZE_SHAPES, MultiLevelNeck's with the user's scale) and
    ALIGN_CORNERS_RESIZES, and of phase 23's amp steps in bf16; times of
    the kernel, the bound, and at phase 23's rows and RESIZE_HEADLINES
    those of the plain version and ``F.interpolate``'s own backward and
    the kernel's device time over the library's."""
    gen = torch.Generator(device=device).manual_seed(3)
    rows = []
    # the rows whose yardsticks are timed: phase 23's and the two of the
    # kernels line; the others keep every check and the kernel's own
    # times, while their plain and library times stand in PERF.md's kernel
    # table
    timed_in_full = {*RESIZE_HEADLINES, *REALTIME_RESIZE_SHAPES,
                     *NONLOCAL_RESIZE_SHAPES}
    both = dict.fromkeys((*SETR_RESIZES, *DEEPLAB_RESIZES,
                          *DEEPLAB_RESIZES_640, *SEGFORMER_RESIZE_SHAPES,
                          *PSPNET_RESIZE_SHAPES, *M2F_RESIZE_SHAPES))
    f32_bf16 = (torch.float32, torch.bfloat16)
    cases = ([(shape, size, None, f32_bf16, False) for shape, size in both]
             + [(shape, size, None, (torch.bfloat16,), False)
                for shape, size in dict.fromkeys(PYRAMID_RESIZE_SHAPES)]
             + [(*case, False) for case in DECODER_RESIZE_SHAPES]
             + [(shape, size, None, f32_bf16, True)
                for shape, size in ALIGN_CORNERS_RESIZES]
             + [(shape, size, None, (torch.bfloat16,), False)
                for shape, size in (*REALTIME_RESIZE_SHAPES,
                                    *NONLOCAL_RESIZE_SHAPES)])
    for (n, c, h, w), size, scales, dtypes, ac in cases:
        restated = ((n, c, h, w), size) not in timed_in_full
        for dtype in dtypes:
            gy = torch.randn((n, c, *size), generator=gen,
                             device=device).to(dtype)

            def kernel():
                return resize_backward.resize_backward(gy, (h, w), ac,
                                                       scales)

            def plain():
                return resize_backward.resize_backward_plain(gy, (h, w), ac,
                                                             scales)

            def library():
                return torch.ops.aten.upsample_bilinear2d_backward(
                    gy, list(size), [n, c, h, w], ac,
                    *(scales or (None, None)))

            before = dict(resize_backward.launches)
            got = kernel()
            one_launch = sum(resize_backward.launches.values()) \
                - sum(before.values()) == 1
            exact = torch.equal(got, plain())
            repeat = torch.equal(got, kernel())
            rounded_once = dtype == torch.float32 or torch.equal(
                got, resize_backward.resize_backward(
                    gy.float(), (h, w), ac, scales).to(dtype))
            ref = library().float()
            lib_err = float((got.float() - ref).abs().max())
            torch.cuda.synchronize()
            if not (exact and repeat and rounded_once and one_launch):
                raise AssertionError(
                    f"resize backward at {(n, c, h, w)}->{size} {dtype} "
                    f"align_corners {ac}: same bits as plain {exact}, on "
                    f"a second call {repeat}, bf16 = float32 rounded once "
                    f"{rounded_once}, one launch {one_launch}")
            # reads g once, writes dx once (and the small tables); two
            # operations a tap (the product with the weight, the add) of
            # the W pass (every g row's column taps) and the H pass (every
            # dx column's row taps)
            taps = [int((resize_backward.axis_table(i, o, ac, sc)[0]
                         >= 0).sum())
                    for i, o, sc in zip((h, w), size, scales or (None, None))]
            ops = 2.0 * n * c * (size[0] * taps[1] + w * taps[0])
            bound, bound_by = bound_ms(
                (gy.numel() + got.numel()) * gy.element_size(), ops,
                PEAK_FLOPS[torch.float32])
            flush = l2_flush.zero_
            # the library's atomic backward takes up to 0.26 s a call at
            # the image pools: 5 calls a measurement where one takes 5 ms
            lib_runs = yardstick(restated, lambda: (
                20 if cuda_ms(library, flush, 1, 1) < 5.0 else 5))
            row = dict(
                shape=[n, c, h, w], size=list(size), scales=scales,
                align_corners=ac, dtype=str(dtype).replace("torch.", ""),
                same_bits_as_plain=exact, repeats_bit_for_bit=repeat,
                bf16_is_float32_rounded_once=rounded_once,
                max_abs_err=0.0, vs_library_max_abs_err=lib_err,
                max_abs_grad=float(ref.abs().max()),
                ms=cuda_ms(kernel, flush),
                device_ms=device_ms(kernel, "resize_backward_kernel",
                                    flush, profiles=1 if restated else 3),
                plain_ms=yardstick(restated, cuda_ms, plain, flush, 1, 5),
                library_ms=yardstick(restated, cuda_ms, library, flush, 1,
                                     lib_runs),
                library_device_ms=yardstick(restated, lambda: device_ms(
                    library, None, flush, runs=lib_runs)),
                library_runs=lib_runs, bound_ms=bound, bound_by=bound_by)
            row["vs_library"] = yardstick(
                restated, lambda: row["device_ms"] / row["library_device_ms"])
            row["bound_share"] = bound / row["device_ms"]
            print("resize backward:", json.dumps(row), flush=True)
            rows.append(row)
            del gy, got, ref
    return rows


FLASH_KEYS = {False: ("forward", "backward_dq", "backward_dkv",
                      "split_bf16x3"),
              True: ("forward_bf16", "backward_dq_bf16", "backward_dkv_bf16")}


def flash_counts(amp=False):
    """Launches of the flash kernels (forward, dQ, dK/dV and, in float32,
    the split) of the policy's dtype: float32, or bf16 with ``amp``."""
    return {k: flash_attention.launches[k] for k in FLASH_KEYS[amp]}


RESIZE_KEY = {False: "resize_backward", True: "resize_backward_bf16"}


def step_counts(amp=False):
    """``flash_counts`` and the resize backward's launches in both dtypes:
    the kernels of a train step."""
    return dict(flash_counts(amp), **resize_backward.launches)


def per_step_launches(key, amp=False, layers=SETR_LAYERS,
                      resizes=len(SETR_RESIZES)):
    """A train step's launches of a flash kernel, the split or the resize
    backward (SETR's by default): each flash kernel once an attention
    layer, the split twice (q, k, v for the forward; q, k, v, dO for the
    backward), the resize backward of the policy's dtype once per bilinear
    resize and of the other none."""
    if key in RESIZE_KEY.values():
        return resizes if key == RESIZE_KEY[amp] else 0
    return 2 * layers if key == "split_bf16x3" else layers


def schedule_cfg(path=SCHEDULE):
    """A schedule's (the kvasir one's by default) optimizer, LR schedule
    and ``amp`` flag."""
    schedule = load_python_config(path)
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
        counts = step_counts(amp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with policy_scope(policy):
            logs.append(train_step(x, gt, generator))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        state.step += 1
        per_step.append({k: v - counts[k]
                         for k, v in step_counts(amp).items()})
    launches = step_counts(amp)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    other = {k: flash_attention.launches[k] for k in FLASH_KEYS[not amp]}
    if any(other.values()):
        raise AssertionError(f"{policy} steps launched the other dtype's "
                             f"flash kernels: {other}")

    losses = [{k: float(v) for k, v in log.items()} for log in logs]
    expected = {k: per_step_launches(k, amp) for k in launches}
    for i, (log, counts) in enumerate(zip(losses, per_step)):
        if counts != expected:
            raise AssertionError(f"step {i + 1} launched {counts}, not "
                                 f"{expected}")
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


def agreement_inputs(config, batch, size):
    """A full-size config without drop path and head dropout (the two
    devices' generators draw other masks) on the CPU, from seeded weights,
    and a batch of ``batch`` synthetic ``size``² images and their labels."""
    network = load_python_config(config)["model"]
    if "drop_path_rate" in network["backbone"]:
        network["backbone"]["drop_path_rate"] = 0.0
    for head in ("decode_head", "auxiliary_head"):
        if network.get(head):
            network[head]["dropout_ratio"] = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"{Path(config).stem}_no_dropout.py"
        path.write_text(f"model = {network!r}\n")
        model = init_model(path, device="cpu")
    randomize_(model, seed=1)
    _, x, masks = synthetic_batch("cpu", batch, size)
    return model, x, torch.from_numpy(masks).long()


def one_train_step(model, x, gt, device, schedule=SCHEDULE):
    """One ``make_train_step`` step of ``model`` (already on ``device``)
    with ``schedule`` (the kvasir one by default); the loss and each param
    group's lr after the step against ``base_lr · lr_mult`` times the
    schedule's rate at step 1 (its largest relative difference)."""
    optimizer_cfg, lr_config, _ = schedule_cfg(schedule)
    state = create_train_state(model, optimizer_cfg, lr_config)
    step = make_train_step(state.model, state.optimizer, state.scheduler)
    dtype = next(model.parameters()).dtype
    log = step(x.to(device=device, dtype=dtype), gt.to(device),
               torch.Generator(device=device).manual_seed(0))
    rate = build_from_cfg(lr_config, LR_SCHEDULER).schedule(
        optimizer_cfg["lr"], 1)(1)
    lr_err = max(abs(g["lr"] / (g.get("lr_mult", 1.0) * rate) - 1.0)
                 for g in state.optimizer.param_groups)
    return float(log["loss"]), lr_err


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
    model, x, gt = agreement_inputs(SETR_CONFIG, AGREE_BATCH,
                                    AGREE_IMAGE_SIZE)
    patches = (mock.patch.object(vit, "multihead_attention",
                                 attention_in_input_dtype),
               mock.patch.object(LayerNorm, "forward",
                                 layer_norm_in_input_dtype))
    train_agreement(device, "setr train step", model, x, gt, patches,
                    {k: per_step_launches(k) for k in step_counts()})


@contextlib.contextmanager
def recorded_branches(branches):
    """``F.relu`` and ``F.max_pool2d`` as they are, each call appending its
    branch to ``branches``: the mask of the inputs above 0 (those whose
    gradient the ReLU passes), or the max-pool's argmax."""
    relu, max_pool2d = F.relu, F.max_pool2d

    def relu_recorded(x, inplace=False):
        branches.append(x.detach() > 0)
        return relu(x, inplace=inplace)

    def max_pool2d_recorded(x, *args, **kwargs):
        out, index = max_pool2d(x, *args, return_indices=True, **kwargs)
        branches.append(index)
        return out

    with mock.patch.object(F, "relu", relu_recorded), \
            mock.patch.object(F, "max_pool2d", max_pool2d_recorded):
        yield


@contextlib.contextmanager
def replayed_branches(branches):
    """Every ReLU and max-pool takes the branch that ``recorded_branches``
    recorded for its call, in call order: the same piecewise-linear
    function the recorded step differentiated."""
    taken = iter(branches)

    def relu_replayed(x, inplace=False):
        return torch.where(next(taken).to(x.device), x, x.new_zeros(()))

    def max_pool2d_replayed(x, *args, **kwargs):
        index = next(taken).to(x.device)
        return x.flatten(2).gather(2, index.flatten(2)).view_as(index)

    with mock.patch.object(F, "relu", relu_replayed), \
            mock.patch.object(F, "max_pool2d", max_pool2d_replayed):
        yield
    if next(taken, None) is not None:
        raise AssertionError("the replayed step took fewer branches than "
                             "the recorded one")


def train_agreement(device, what, model, x, gt, patches, expected,
                    schedule=SCHEDULE, hold_updates=True, run_own=True,
                    card_context=contextlib.nullcontext):
    """One train step of ``model`` (on the CPU) from the same weights on
    the card, in float32, which must launch the ``expected`` kernels
    (``step_counts()``), and twice on the CPU in float64 under
    ``patches``: on the card's branches (``replayed_branches``) and on its
    own.  Against the first: the loss within 1e-4, every gradient within
    GRAD_RTOL of its largest value and every parameter after the update
    within GRAD_RTOL of the largest update plus one float32 rounding step.
    A ReLU input within float32's rounding of 0, or a max-pool window
    with two values that close, takes the other branch in float64, and the
    gradient jumps there; the second step's distance and the number of
    such flipped branches are reported.  ``schedule`` (the kvasir one by
    default) gives the optimizer; each param group's lr after the card's
    step must be its ``base_lr · lr_mult`` times the schedule (1e-6).
    Without ``hold_updates`` (an Adam-family first step, whose update is
    about ``lr · sign(g)``, so a gradient within rounding of 0 may flip
    it) the parameters after the update are reported, not held.  Without
    ``run_own`` the float64 step on its own branches is skipped.
    ``card_context()`` is entered around the card's step (to record what
    the ``patches`` replay)."""
    gpu_model = copy.deepcopy(model).to(device)
    own_model = copy.deepcopy(model).double() if run_own else None
    before = {k: t.double() for k, t in snapshot(model).items()}
    ref_model = model.double()
    reset_counts()
    card_branches, own_branches = [], []
    with recorded_branches(card_branches), card_context():
        gpu_loss, lr_err = one_train_step(gpu_model, x, gt, device, schedule)
    torch.cuda.synchronize()
    launches = step_counts()
    if launches != expected:
        raise AssertionError(f"the card's step launched {launches}, not "
                             f"{expected}")
    card_branches = [b.cpu() for b in card_branches]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        with replayed_branches(card_branches):
            ref_loss, _ = one_train_step(ref_model, x, gt,
                                         torch.device("cpu"), schedule)
        own_loss = None
        if run_own:
            with recorded_branches(own_branches):
                own_loss, _ = one_train_step(own_model, x, gt,
                                             torch.device("cpu"), schedule)
    cpu_s = time.perf_counter() - t0
    if lr_err > 1e-6:
        raise AssertionError(f"{what}: a param group's lr is off its "
                             f"lr_mult times the schedule by {lr_err}")
    if abs(gpu_loss - ref_loss) > 1e-4 * abs(ref_loss):
        raise AssertionError(f"loss {gpu_loss} on the card, {ref_loss} in "
                             f"float64 on the CPU")
    ulp = torch.finfo(torch.float32).eps

    def shares(reference):
        """Per kind ("grad", "update") and tensor: the max abs error of
        the card's step against ``reference``, the scale it is held to
        (max |g|, the largest update), and that scale's floor (GRAD_ATOL,
        one float32 rounding step of the largest parameter)."""
        out = {"grad": {}, "update": {}}
        ref_params = dict(reference.named_parameters())
        for name, q in gpu_model.named_parameters():
            p = ref_params[name]
            for kind, ref, got, scale, floor in (
                    ("grad", p.grad, q.grad, float(p.grad.abs().max()),
                     GRAD_ATOL),
                    ("update", p.detach(), q.detach(),
                     float((p.detach() - before[name]).abs().max()),
                     ulp * float(before[name].abs().max()))):
                err = float((got.cpu().double() - ref).abs().max())
                out[kind][name] = (err, scale, floor)
        return out

    def worst_grads(errors):
        share = {name: err / (scale + floor)
                 for name, (err, scale, floor) in errors["grad"].items()}
        return share, sorted(share.items(), key=lambda kv: -kv[1])[:3]

    gpu = shares(ref_model)
    used = {kind: {name: err / (GRAD_RTOL * scale + floor)
                   for name, (err, scale, floor) in gpu[kind].items()}
            for kind in gpu}
    over = sorted(((share, kind, name) for kind in used
                   for name, share in used[kind].items()
                   if share > 1.0 and (hold_updates or kind == "grad")),
                  reverse=True)
    if over:
        raise AssertionError(f"{len(over)} tensors beyond the allowed error "
                             f"(error / allowed, kind, name): {over[:5]}")
    grad_shares, worst = worst_grads(gpu)
    _, worst_own = (worst_grads(shares(own_model)) if run_own
                    else (None, None))
    print(f"cpu agreement ({what}): " + json.dumps(dict(
        batch=list(x.shape), loss_float64=ref_loss,
        loss_float64_own_branches=own_loss, loss_gpu=gpu_loss,
        launches=launches, cpu_float64_seconds=cpu_s,
        updates_held=hold_updates, lr_group_error=lr_err,
        branches=len(card_branches),
        flipped_branches=sum(int((a != b).sum()) for a, b in
                             zip(card_branches, own_branches, strict=True))
        if run_own else None,
        tensors=len(grad_shares),
        grads_over_1e_3_of_max=sum(v > 1e-3 for v in grad_shares.values()),
        worst_grad_share_of_max=worst,
        own_branches_worst_grad_share_of_max=worst_own,
        tolerance_used={k: max(v.values()) for k, v in used.items()})),
        flush=True)


def flagship_schedule():
    """The kvasir schedule: the flagship's train and val batch sizes."""
    return load_python_config(SCHEDULE)


def deeplab_train_phase(device, amp=False):
    """The flagship's train-and-validate loop at full width: TRAIN_STEPS
    steps of ``train_one_epoch`` on one batch of the schedule's
    ``train_batch_size`` synthetic 512² images (float32, or under the bf16
    policy with ``amp``), then ``validate_one_epoch`` through
    ``make_eval_step`` and, in float32, the TTA step.  Under amp, first one
    step's gradients with the kernel and with the plain resize backward
    (``amp_resize_agreement``).  Exactly 3 resize-backward launches a step
    in the policy's dtype, none in the other and no flash launch; finite,
    falling losses; moved parameters and BN statistics.  The launches of
    each path."""
    policy = "bf16" if amp else "fp32"
    model = init_model(CONFIG, device=device)
    if model.auxiliary_head is None:
        raise AssertionError("the flagship's aux head is missing")
    randomize_(model, seed=0)
    optimizer_cfg, lr_config, _ = schedule_cfg()
    state = create_train_state(model, optimizer_cfg, lr_config)
    train_step = make_train_step(state.model, state.optimizer,
                                 state.scheduler)
    _, x, masks = synthetic_batch(device, flagship_schedule()[
        "train_batch_size"], IMAGE_SIZE)
    gt = torch.from_numpy(masks).to(device)
    vs_plain = amp_resize_agreement(model, x, gt, device) if amp else None
    before = snapshot(model)
    logs, step_ms, per_step = [], [], []

    def timed_step(img, labels, generator):
        counts = step_counts(amp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = train_step(img, labels, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - counts[k]
                         for k, v in step_counts(amp).items()})
        logs.append({k: float(v) for k, v in log.items()})
        return log

    generator = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    with policy_scope(policy):
        state, mean_log = train_one_epoch(
            0, timed_step, state, [(x, gt, {})] * TRAIN_STEPS,
            generator=generator)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    launches = step_counts(amp)
    expected = {k: 0 for k in launches}
    expected[RESIZE_KEY[amp]] = len(DEEPLAB_RESIZES)
    for i, (log, counts) in enumerate(zip(logs, per_step)):
        if counts != expected:
            raise AssertionError(f"step {i + 1} launched {counts}, not "
                                 f"{expected}")
        if not all(math.isfinite(v) for v in log.values()):
            raise AssertionError(f"step {i + 1}: non-finite log {log}")
    if any(flash_attention.launches.values()):
        raise AssertionError(f"the flagship launched flash kernels: "
                             f"{flash_attention.launches}")
    if state.step != TRAIN_STEPS or len(logs) != TRAIN_STEPS:
        raise AssertionError(f"{len(logs)} steps, state at {state.step}")
    if not logs[-1]["loss"] < logs[0]["loss"]:
        raise AssertionError(f"the loss did not fall: "
                             f"{[log['loss'] for log in logs]}")
    after = snapshot(model)
    still = [name for name, t in before.items()
             if not name.endswith("num_batches_tracked")
             and torch.equal(t, after[name])]
    tracked = {int(t) for name, t in after.items()
               if name.endswith("num_batches_tracked")}
    if still or tracked != {TRAIN_STEPS}:
        raise AssertionError(f"unchanged after {TRAIN_STEPS} steps: {still}; "
                             f"BN batches tracked {tracked}")
    aux_grads = [p.grad for p in model.auxiliary_head.parameters()]
    if any(g is None or not bool(g.abs().sum() > 0) for g in aux_grads):
        raise AssertionError("the aux head got no gradient")
    print(f"deeplabv3 train slice ({policy}): " + json.dumps(dict(
        batch=list(x.shape), steps=TRAIN_STEPS,
        loss=[log["loss"] for log in logs],
        decode_loss_ce=[log["decode.loss_ce"] for log in logs],
        aux_loss_ce=[log["aux.loss_ce"] for log in logs],
        decode_acc_seg=[log["decode.acc_seg"] for log in logs],
        epoch_mean=mean_log, ms_per_step=statistics.median(step_ms[1:]),
        step_ms=step_ms, peak_memory_gb=peak_gb, launches=launches,
        **({} if vs_plain is None else
           {"vs_plain_resize_backward": vs_plain}))), flush=True)
    with policy_scope(policy):
        print_breakdown(f"deeplabv3 train step ({policy})",
                        lambda: train_step(x, gt, generator))
    n = flagship_schedule()["val_batch_size"]
    paths = {"train": launches,
             "validate": validate_batches(
                 state, [(x[i:i + n], gt[i:i + n], {}) for i in (0, n)],
                 policy)}
    if not amp:
        paths["tta"] = deeplab_tta(state, x, gt)
    return paths


def validate_batches(state, loader, policy, pipeline=None,
                     what="deeplabv3 validate"):
    """``validate_one_epoch`` through ``make_eval_step`` over ``loader``
    (two batches of the schedule's ``val_batch_size``; raw, through
    ``pipeline``, where given) under ``policy``: exactly one K1 launch a
    batch and head (decode, and aux where the model has one) and no K2,
    and the evaluator's counts equal to ``torch.argmax`` +
    ``torch.bincount`` on the same logits.  Timed over a second pass.  The
    confusion launches and instances."""
    heads = 1 if state.model.auxiliary_head is None else 2
    eval_step = make_eval_step(state.model)
    seen = []

    def recorded(img, labels):
        seg_logits, log_vars = eval_step(img, labels)
        seen.append((seg_logits, labels))
        return seg_logits, log_vars

    evaluator = new_evaluator()
    reset_counts()
    with policy_scope(policy):
        val_log, metrics = validate_one_epoch(0, recorded, state, loader,
                                              evaluator, pipeline=pipeline)
    torch.cuda.synchronize()
    launches = dict(confusion.launches, instances=dict(confusion.instances))
    if (launches["logits"] != heads * len(loader)
            or launches["labels"] != 0):
        raise AssertionError(f"{what}: validation over {len(loader)} "
                             f"batches of {heads} heads launched "
                             f"{launches}")
    check_metrics(metrics)
    for head, sums in evaluator.results.items():
        counts = [torch.zeros(2, dtype=torch.float64) for _ in range(3)]
        for seg_logits, labels in seen:
            logits = seg_logits[head]
            _, _, library = confusion_library(
                logits, torch.argmax(logits, dim=1), labels, 2)
            for total, part in zip(counts, library):
                total += part.double().cpu()
        if not all(np.array_equal(sums[i], counts[j].numpy())
                   for i, j in ((0, 0), (2, 1), (3, 2))):
            raise AssertionError(f"{head}: evaluator counts {sums} != "
                                 f"argmax + bincount {counts}")
    with policy_scope(policy), contextlib.redirect_stdout(io.StringIO()):
        batch_ms = timed_batches(lambda: validate_one_epoch(
            0, eval_step, state, loader, new_evaluator(), pipeline=pipeline),
            runs=3) / len(loader)
    print(f"{what} ({policy}): " + json.dumps(dict(
        batches=len(loader), batch=list(seen[0][1].shape),
        pipeline=pipeline is not None,
        ms_per_batch=batch_ms, val_log=val_log, launches=launches,
        counts_equal_argmax_bincount=True, metrics=summarize(metrics),
        logits_dtype=str(seen[0][0]["decode"].dtype))), flush=True)
    return launches


def deeplab_tta(state, x, gt):
    """``make_tta_step`` at TTA_SCALES on one batch of the schedule's
    ``val_batch_size``, then ``binarize_channels`` on the probabilities and
    the evaluator on the decode head, as ``val.py --tta`` composes them,
    through ``validate_one_epoch``: 1 K1 launch a batch; probabilities that
    sum to 1 per pixel within 1e-5.  The confusion launches and
    instances."""
    n = flagship_schedule()["val_batch_size"]
    loader = [(x[:n], gt[:n], {})]
    tta_step = make_tta_step(state.model, TTA_SCALES)
    threshold = head_threshold(state.model)
    seen = []

    def tta_eval_step(img, labels):
        probs = binarize_channels(tta_step(img), threshold, is_probs=True)
        seen.append(probs)
        return {"decode": probs}, {}

    evaluator = new_evaluator()
    reset_counts()
    _, metrics = validate_one_epoch(0, tta_eval_step, state, loader,
                                    evaluator)
    torch.cuda.synchronize()
    launches = dict(confusion.launches, instances=dict(confusion.instances))
    if launches["logits"] != len(loader) or launches["labels"] != 0:
        raise AssertionError(f"TTA over {len(loader)} batch launched "
                             f"{launches}")
    check_metrics(metrics)
    probs = seen[0]
    sum_err = float((probs.sum(dim=1) - 1).abs().max())
    if (tuple(probs.shape) != (n, 2, IMAGE_SIZE, IMAGE_SIZE)
            or not bool(torch.isfinite(probs).all()) or sum_err > 1e-5):
        raise AssertionError(f"TTA probabilities {tuple(probs.shape)}: sum "
                             f"off 1 by {sum_err}")
    with contextlib.redirect_stdout(io.StringIO()):
        batch_ms = timed_batches(lambda: validate_one_epoch(
            0, tta_eval_step, state, loader, new_evaluator()),
            runs=3)
    print("deeplabv3 tta: " + json.dumps(dict(
        scales=TTA_SCALES, batch=list(loader[0][0].shape),
        forwards=2 * len(TTA_SCALES), ms_per_batch=batch_ms,
        launches=launches, probability_sum_max_err=sum_err,
        metrics=summarize(metrics))), flush=True)
    return launches


def amp_resize_agreement(model, x, gt, device):
    """One amp train step from ``model``'s weights on copies, with the
    resize backward kernel and with its plain version on the card, under
    ``torch.use_deterministic_algorithms`` (warning, not raising, where an
    op has no deterministic implementation): every gradient the same bits,
    or, where an op refused, within AMP_DETERMINISTIC_SHARE relative norm
    per tensor.  The refusing ops, whether the bits are equal, and the
    worst distance."""
    grads = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for patch in (contextlib.nullcontext(),
                          mock.patch.object(
                              resize_ops, "resize_backward",
                              resize_backward.resize_backward_plain)):
                copy_ = copy.deepcopy(model)
                counts = dict(resize_backward.launches)
                with patch, policy_scope("bf16"):
                    one_train_step(copy_, x, gt, device)
                torch.cuda.synchronize()
                launched = {k: v - counts[k]
                            for k, v in resize_backward.launches.items()}
                expected = {k: 0 for k in launched}
                if not grads:
                    expected[RESIZE_KEY[True]] = len(DEEPLAB_RESIZES)
                if launched != expected:
                    raise AssertionError(f"the amp step launched {launched}, "
                                         f"not {expected}")
                grads.append({name: p.grad.clone() for name, p in
                              copy_.named_parameters() if p.grad is not None})
                del copy_
        finally:
            torch.use_deterministic_algorithms(False)
    refusing = sorted({str(w.message).split(" does not have")[0]
                       for w in caught
                       if "does not have a deterministic" in str(w.message)})
    kernel, plain = grads
    if kernel.keys() != plain.keys():
        raise AssertionError("the two amp steps gave gradients to other "
                             "parameters")
    same_bits = all(torch.equal(kernel[k], g) for k, g in plain.items())
    shares = {k: float((kernel[k].float() - g.float()).norm()
                       / g.float().norm().clamp_min(1e-30))
              for k, g in plain.items()}
    worst = max(shares.items(), key=lambda kv: kv[1])
    if not same_bits and (not refusing
                          or worst[1] > AMP_DETERMINISTIC_SHARE):
        raise AssertionError(f"amp gradients with the resize kernel vs its "
                             f"plain version: same bits {same_bits}, ops "
                             f"without a deterministic implementation "
                             f"{refusing}, worst {worst}")
    return dict(tensors=len(shares), same_bits=same_bits,
                nondeterministic_ops=refusing, worst_relative_distance=worst)


def deeplab_train_agreement_phase(device):
    """One flagship train step at full width without head dropout, batch
    DEEPLAB_AGREE_BATCH at DEEPLAB_AGREE_SIZE² (the stride-8 map then holds
    the ASPP's dilation-12 and -24 taps), on the card (the resize kernel,
    float32) against the same step in float64 on the CPU (its plain
    version)."""
    model, x, gt = agreement_inputs(CONFIG, DEEPLAB_AGREE_BATCH,
                                    DEEPLAB_AGREE_SIZE)
    expected = {k: 0 for k in step_counts()}
    expected[RESIZE_KEY[False]] = len(DEEPLAB_RESIZES)
    train_agreement(device, "deeplabv3 train step", model, x, gt, (),
                    expected)


def half_integer_pixels(shape, angle_deg):
    """Where a rotation's source coordinate (float64) lies within 1e-3 of
    a half-integer: there the nearest mask tap may go either way."""
    h, w = shape
    a = math.radians(angle_deg)
    yy, xx = np.meshgrid(np.arange(h) - (h - 1) / 2,
                         np.arange(w) - (w - 1) / 2, indexing="ij")
    src_y = math.cos(a) * yy + math.sin(a) * xx + (h - 1) / 2
    src_x = -math.sin(a) * yy + math.cos(a) * xx + (w - 1) / 2

    def near_half(v):
        return np.abs(v - np.floor(v) - 0.5) < 1e-3
    return near_half(src_y) | near_half(src_x)


def check_mask_flips(out, ref, angle, what):
    """Masks equal, or off only at Rotate's half-integer taps, at most
    MASK_FLIP_SHARE of the pixels; the share that is off."""
    off = out.cpu().numpy() != ref.cpu().numpy()
    excused = half_integer_pixels(off.shape[1:], angle)[None]
    if (off & ~excused).any() or off.mean() > MASK_FLIP_SHARE:
        raise AssertionError(f"{what}: {int(off.sum())} mask pixels off, "
                             f"{int((off & ~excused).sum())} away from a "
                             f"half-integer tap")
    return float(off.mean())


def loader_batch(transform, n, seed=0):
    """The dataset and one collated batch of ``n`` synthetic AUG_SIZE²
    items as the loader gives them: uint8 (N, H, W, 3) and float masks."""
    ds = SyntheticDataset(pipeline=str(transform), length=n,
                          image_size=(AUG_SIZE, AUG_SIZE), seed=seed)
    images, masks, _ = ds.collate_fn([ds[i] for i in range(n)])
    return ds, images, masks


def branch_sizes(pipe, n, run):
    """The sub-batch each OneOf child and each p < 1 leaf of the pipeline
    got in ``run()`` on ``n`` images, and the sizes ``_apportion`` gives
    them."""
    seen, expected, spied = [], [], []
    for t in pipe.root.transforms:
        if isinstance(t, aug.OneOf):
            children = t.transforms
            weights = [float(w) * t.p for w in t.probs] + (
                [1.0 - t.p] if t.p < 1 else [])
        elif t.p < 1:
            children, weights = [t], [t.p, 1.0 - t.p]
        else:
            continue
        expected.append((children, weights))
        for child in children:
            def spy(g, imgs, masks, orig=child.force_apply,
                    name=type(child).__name__):
                seen.append((name, imgs.shape[0]))
                return orig(g, imgs, masks)
            child.force_apply = spy
            spied.append(child)
    try:
        run()
    finally:
        for child in spied:
            del child.force_apply
    want = [(type(c).__name__, k) for children, weights in expected
            for c, k in zip(children, aug._apportion(n, weights)) if k]
    return seen, want


def transform_split(fn, runs=3):
    """Device ms a call of ``fn`` per transform (the pipeline's
    ``record_function`` ranges, kernels launched inside each), the sum of
    every kernel and the wall ms, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    names = set(aug.TRANSFORMS) | {"augmentation"}
    kernels = sum(evt.self_device_time_total for evt in kernel_events(prof)
                  ) / 1e3 / runs
    split = {evt.key: evt.device_time_total / 1e3 / runs
             for evt in prof.key_averages()
             if evt.device_type != torch.autograd.DeviceType.CUDA
             and evt.key in names}
    return dict(sorted(split.items(), key=lambda kv: -kv[1])), kernels, wall


def shifted_add_blur(imgs, kernels):
    """The other route for the blurs' per-image kernels: one multiply-add
    over the whole sub-batch per tap (the JAX package's form), timed
    against the grouped convolution of ``transforms._depthwise_blur``."""
    n, c, h, w = imgs.shape
    kh, kw = kernels.shape[-2:]
    x = F.pad(imgs, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    k = kernels if kernels.dim() == 3 else kernels.expand(n, kh, kw)
    out = torch.zeros_like(imgs)
    for dy in range(kh):
        for dx in range(kw):
            out += k[:, dy, dx, None, None, None] * x[:, :, dy:dy + h,
                                                      dx:dx + w]
    return out


def blur_routes(pipe, x, gen):
    """Each blur of the train YAML on its sub-batch as the stratified
    pipeline gives it (16 images over four blurs: 4 each), through the
    grouped convolution and through shifted adds: ms of each (CUDA events)
    and their distance."""
    blurs = next(t for t in pipe.root.transforms if isinstance(t, aug.OneOf)
                 and any(isinstance(c, aug.Blur) for c in t.transforms))
    counts = aug._apportion(x.shape[0], [float(w) for w in blurs.probs])
    rows = {}
    for t, count in zip(blurs.transforms, counts):
        sub = x[:count]
        params = t.sample(gen, count, tuple(sub.shape[1:]))
        if isinstance(t, aug.GlassBlur):
            g = t._gauss_kernel(x.device)
            kernels = [g[:, None], g[None, :]]  # one pass each way
        elif isinstance(t, aug.Blur):
            kernels = [aug._masked_box_kernel(params["size"], t.kmax)]
        else:
            kernels = [t.kernel(params)]

        def route(blur):
            def run():
                out = sub
                for k in kernels:
                    out = blur(out, k)
                return out
            return run
        conv, shifted = route(aug._depthwise_blur), route(shifted_add_blur)
        err = float((conv() - shifted()).abs().max())
        if err > RAW_ATOL:
            raise AssertionError(f"{type(t).__name__}: the two blur routes "
                                 f"differ by {err}")
        rows[type(t).__name__] = dict(
            images=count, taps=[list(k.shape[-2:]) for k in kernels],
            grouped_conv_ms=cuda_ms(conv, runs=10),
            shifted_add_ms=cuda_ms(shifted, runs=10), max_abs_diff=err)
    return rows


def pipeline_phase(device):
    """Phase 15: the Kvasir train pipeline alone on the card at the
    schedule's train batch of AUG_SIZE² uint8 images from
    ``SyntheticDataset``, then the val pipeline at its val batch."""
    n = flagship_schedule()["train_batch_size"]
    _, images, masks = loader_batch(TRAIN_TRANSFORM, n)
    pipe = Pipeline.from_yaml(TRAIN_TRANSFORM)
    x, m = torch.from_numpy(images).to(device), torch.from_numpy(
        masks).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    outputs = []
    seen, want = branch_sizes(pipe, n,
                              lambda: outputs.append(pipe(gen, x, m)))
    out, om = outputs[0]
    if (tuple(out.shape) != (n, 3, AUG_SIZE, AUG_SIZE)
            or out.dtype != torch.float32 or om.dtype != torch.int32
            or tuple(om.shape) != (n, AUG_SIZE, AUG_SIZE)
            or not bool(torch.isfinite(out).all())
            or not set(om.unique().tolist()) <= {0, 1}):
        raise AssertionError(f"the train pipeline gave {tuple(out.shape)} "
                             f"{out.dtype}, masks {tuple(om.shape)} "
                             f"{om.dtype} {om.unique().tolist()}")
    if seen != want:
        raise AssertionError(f"sub-batch sizes {seen}, not the "
                             f"apportionment {want}")

    # the pinned copy: the card against the port on the CPU
    pinned = Pipeline.from_yaml(PINNED_TRANSFORM)
    angle = float(pinned.root.transforms[1].transforms[0].limit[0])
    p_out, p_m = pinned(torch.Generator(device=device).manual_seed(0), x, m)
    c_out, c_m = pinned(torch.Generator().manual_seed(0), images, masks)
    pinned_err = float((p_out.cpu() - c_out).abs().max())
    if pinned_err > NORM_ATOL:
        raise AssertionError(f"pinned pipeline: card vs CPU {pinned_err}")
    pinned_flips = check_mask_flips(p_m, c_m, angle, "pinned pipeline")

    # GlassBlur and ISONoise with their draws made on the CPU
    injected = {}
    for t in (c for o in pipe.root.transforms
              for c in getattr(o, "transforms", [o])
              if isinstance(c, (aug.GlassBlur, aug.ISONoise))):
        k = 4
        params = t.sample(torch.Generator().manual_seed(1), k,
                          (3, AUG_SIZE, AUG_SIZE))
        sub = torch.from_numpy(images[:k]).permute(0, 3, 1, 2).float()
        ref, _ = t.apply(sub, None, params)
        got, _ = t.apply(sub.to(device), None,
                         {a: v.to(device) for a, v in params.items()})
        err = float((got.cpu() - ref).abs().max())
        if err > RAW_ATOL:
            raise AssertionError(f"{type(t).__name__} with injected draws: "
                                 f"card vs CPU {err}")
        injected[type(t).__name__] = err

    split, kernels_ms, wall = transform_split(lambda: pipe(gen, x, m))
    per_transform = {}
    for name, count in want + [("Normalize", n)]:
        t = next(c for o in pipe.root.transforms
                 for c in getattr(o, "transforms", [o])
                 if type(c).__name__ == name)
        sub, sub_m = x[:count].permute(0, 3, 1, 2).float(), m[:count]
        per_transform[name] = dict(images=count, ms=cuda_ms(
            lambda: t.force_apply(gen, sub, sub_m), runs=10))
    line = dict(
        batch=list(images.shape), out=list(out.shape),
        ms_per_batch=cuda_ms(lambda: pipe(gen, x, m), runs=10),
        wall_ms=wall, device_ms=kernels_ms, busy_share=kernels_ms / wall,
        device_ms_by_transform=split, sub_batches=seen,
        transform_alone_ms=per_transform,
        blur_routes=blur_routes(pipe, x.permute(0, 3, 1, 2).float(), gen),
        pinned_vs_cpu_max_abs_err=pinned_err,
        pinned_mask_share_off=pinned_flips,
        injected_vs_cpu_max_abs_err=injected)
    print("kvasir train pipeline: " + json.dumps(line), flush=True)
    del x, m, out, om, p_out, p_m

    # the val pipeline (Resize, Normalize) at the val batch
    n_val = flagship_schedule()["val_batch_size"]
    _, images, masks = loader_batch(VAL_TRANSFORM, n_val, seed=1)
    val = Pipeline.from_yaml(VAL_TRANSFORM)
    x, m = torch.from_numpy(images).to(device), torch.from_numpy(
        masks).to(device)
    out, om = val(gen, x, m)
    ref = (torch.from_numpy(images).permute(0, 3, 1, 2).float()
           - torch.tensor(val.root.transforms[1].mean)[:, None, None]
           * 255.0) / (torch.tensor(val.root.transforms[1].std)[:, None, None]
                       * 255.0)
    val_err = float((out.cpu() - ref).abs().max())
    if val_err > NORM_ATOL or not torch.equal(om.cpu(),
                                              torch.from_numpy(masks).int()):
        raise AssertionError(f"val pipeline: {val_err} from Normalize")
    split, kernels_ms, wall = transform_split(lambda: val(gen, x, m))
    print("kvasir val pipeline: " + json.dumps(dict(
        batch=list(images.shape), out=list(out.shape),
        ms_per_batch=cuda_ms(lambda: val(gen, x, m), runs=10),
        wall_ms=wall, device_ms=kernels_ms, busy_share=kernels_ms / wall,
        device_ms_by_transform=split, vs_normalize_max_abs_err=val_err)),
        flush=True)


def fused_train_phase(device, amp=False, config=CONFIG,
                      schedule_path=SCHEDULE, layers=0,
                      resizes=len(DEEPLAB_RESIZES_640), what="deeplabv3",
                      randomize=True):
    """Phases 16 (the flagship) and 18 (SegFormer): a model's loop with
    the augmentation fused into the step: TRAIN_STEPS steps of
    ``train_one_epoch(..., fused_aug=True)`` over a ``DataLoader``
    (LOADER_WORKERS threads) of ``SyntheticDataset`` AUG_SIZE² items
    through the Kvasir train YAML at the schedule's train batch, with the
    schedule's optimizer and LR schedule, float32 or under the bf16 policy
    with ``amp``; then ``validate_one_epoch`` through the val YAML's
    ``device_pipeline`` over two val batches.  Weights from ``randomize_``,
    or without ``randomize`` the seeded default init.  Each step launches
    each flash kernel of the policy's dtype once an attention layer
    (``layers``, the split twice in float32) and the resize backward
    ``resizes`` times, and no kernel of the other dtype; finite and
    falling losses, moved parameters.  The launches of each path."""
    policy = "bf16" if amp else "fp32"
    schedule = load_python_config(schedule_path)
    n = schedule["train_batch_size"]
    model = init_model(config, device=device)
    if randomize:
        randomize_(model, seed=0)
    optimizer_cfg, lr_config, _ = schedule_cfg(schedule_path)
    state = create_train_state(model, optimizer_cfg, lr_config)
    train_ds = SyntheticDataset(pipeline=str(TRAIN_TRANSFORM),
                                length=n * TRAIN_STEPS,
                                image_size=(AUG_SIZE, AUG_SIZE))
    loader = DataLoader(train_ds, batch_size=n, shuffle=True,
                        num_workers=LOADER_WORKERS, drop_last=True,
                        collate_fn=train_ds.collate_fn)
    train_step = make_train_step(state.model, state.optimizer,
                                 state.scheduler,
                                 pipeline=train_ds.device_pipeline)
    before = snapshot(model)
    logs, step_ms, per_step, copied = [], [], [], []

    def timed_step(img, labels, generator):
        copied.append((img.dtype, img.numel() * img.element_size(),
                       labels.numel() * labels.element_size()))
        counts = step_counts(amp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = train_step(img, labels, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - counts[k]
                         for k, v in step_counts(amp).items()})
        logs.append({k: float(v) for k, v in log.items()})
        return log

    generator = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with policy_scope(policy):
            state, mean_log = train_one_epoch(0, timed_step, state, loader,
                                              generator=generator,
                                              fused_aug=True)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        launches = step_counts(amp)
        # the busy share of an epoch (loader included) and the
        # augmentation's device time inside the step, over a profiled
        # second epoch of three batches
        loader.set_epoch(1)
        short = [b for b, _ in zip(loader, range(3))]
        with policy_scope(policy):
            split, kernels_ms, wall = transform_split(
                lambda: train_one_epoch(1, train_step, state, iter(short),
                                        generator=generator,
                                        fused_aug=True), runs=1)
        raw = [torch.as_tensor(t, device=device) for t in short[0][:2]]
        with policy_scope(policy):
            print_breakdown(f"{what} fused train step ({policy})",
                            lambda: train_step(*raw, generator))
    finally:
        loader.close()
    expected = {k: per_step_launches(k, amp, layers, resizes)
                for k in launches}
    for i, (log, counts) in enumerate(zip(logs, per_step)):
        if counts != expected:
            raise AssertionError(f"{what} fused step {i + 1} launched "
                                 f"{counts}, not {expected}")
        if not all(math.isfinite(v) for v in log.values()):
            raise AssertionError(f"{what} fused step {i + 1}: non-finite "
                                 f"{log}")
    other = {k: flash_attention.launches[k] for k in FLASH_KEYS[not amp]}
    if any(other.values()):
        raise AssertionError(f"{what} {policy} steps launched the other "
                             f"dtype's flash kernels: {other}")
    if len(logs) != TRAIN_STEPS or any(c[0] != torch.uint8 for c in copied):
        raise AssertionError(f"{len(logs)} steps, batches {copied[:1]}")
    losses = [log["loss"] for log in logs]
    # each step sees new images: the mean of the last three below the
    # first three's
    if not sum(losses[-3:]) < sum(losses[:3]):
        raise AssertionError(f"the loss did not fall: {losses}")
    after = snapshot(model)
    still = [name for name, t in before.items()
             if not name.endswith("num_batches_tracked")
             and torch.equal(t, after[name])]
    if still:
        raise AssertionError(f"{what}: unchanged after {TRAIN_STEPS} fused "
                             f"steps: {still}")
    aug_ms = split.pop("augmentation", 0.0) / len(short)
    print(f"{what} fused train ({policy}): " + json.dumps(dict(
        batch=[n, AUG_SIZE, AUG_SIZE, 3], steps=TRAIN_STEPS, loss=losses,
        epoch_mean=mean_log, ms_per_step=statistics.median(step_ms[1:]),
        step_ms=step_ms, epoch_ms=epoch_ms,
        loader_share=1.0 - sum(step_ms) / epoch_ms,
        peak_memory_gb=peak_gb,
        h2d_mb_per_step=dict(images_uint8=copied[0][1] / 1e6,
                             masks_float32=copied[0][2] / 1e6),
        augmentation_device_ms_per_step=aug_ms,
        profiled_epoch=dict(steps=len(short), wall_ms=wall,
                            device_ms=kernels_ms,
                            busy_share=kernels_ms / wall,
                            augmentation_device_ms_by_transform={
                                k: v / len(short) for k, v in split.items()}),
        launches=launches, per_step=per_step[0])), flush=True)
    n_val = schedule["val_batch_size"]
    val_ds = SyntheticDataset(pipeline=str(VAL_TRANSFORM), length=2 * n_val,
                              image_size=(AUG_SIZE, AUG_SIZE), seed=1)
    val_loader = DataLoader(val_ds, batch_size=n_val,
                            num_workers=LOADER_WORKERS,
                            collate_fn=val_ds.collate_fn)
    try:
        validate = validate_batches(state, val_loader, policy,
                                    pipeline=val_ds.device_pipeline,
                                    what=f"{what} fused validate")
    finally:
        val_loader.close()
    return {"train": launches, "validate": validate}


def timed_call(fn, times):
    """``fn`` that appends each call's milliseconds (synchronised) to
    ``times``."""
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def timed_factory(module, name, times):
    """Patch ``module.name`` (a step factory) so that the steps it makes
    time their calls into ``times``."""
    factory = getattr(module, name)
    return mock.patch.object(module, name, lambda *a, **k: timed_call(
        factory(*a, **k), times))


def quiet_run(main, argv):
    """``main(argv)`` with its standard output captured (the model, the
    class tables); its epoch, result and checkpoint lines are printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    keep = [line for line in out.getvalue().splitlines()
            if re.match(r"(epoch|done|model parameters|results|val loss)",
                        line)]
    print("\n".join(f"  | {line}" for line in keep), flush=True)
    if rc != 0:
        raise AssertionError(f"{main.__module__}.main returned {rc}")


def confusion_counts():
    return {k: confusion.launches[k] for k in ("logits", "labels")}


def cli_phase(device):
    """Phase 17: the train CLI, then the val CLI on its ``best.pth`` with
    ``--amp`` and with ``--tta``, in this process, on a Kvasir-shaped
    synthetic dataset; then the ragged evaluator path on the card and the
    cost of deterministic algorithms in the fused amp step.  The launches
    of K1, K2 and the resize backward on the CLI path."""
    schedule = flagship_schedule()
    n, n_val = schedule["train_batch_size"], schedule["val_batch_size"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        dataset_cfg = tmp / "kvasir_shaped_synthetic.py"
        dataset_cfg.write_text(CLI_DATASET.format(
            train=n * CLI_TRAIN_STEPS, val=n_val * CLI_VAL_BATCHES,
            size=AUG_SIZE, train_yaml=TRAIN_TRANSFORM, val_yaml=VAL_TRANSFORM))
        work = tmp / "runs"
        common = ["--network-cfg", str(CONFIG), "--dataset-cfg",
                  str(dataset_cfg), "--work-dir", str(work), "--device",
                  str(device)]
        launches, best = cli_train(common, work, dict(
            logits=2 * CLI_VAL_BATCHES, labels=0,
            resize_backward_bf16=3 * CLI_TRAIN_STEPS))
        val_launches = cli_validate(common, work, best, n_val)
        ragged = ragged_phase(device, best)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        amp_policy(False)
    determinism_cost(device)
    k1 = launches["logits"] + sum(v["logits"] for v in val_launches.values())
    path = dict(logits=k1, labels=ragged["launches"]["labels"],
                resize_backward_bf16=launches["resize_backward_bf16"])
    if not all(path.values()):
        raise AssertionError(f"a kernel of the CLI path never launched: "
                             f"{path}")
    instances = {*launches["instances"], *ragged["instances"],
                 *(k for v in val_launches.values() for k in v["instances"])}
    return path, instances


def cli_train(common, work, expected, config=CONFIG, schedule=SCHEDULE,
              what="cli"):
    """The train CLI on ``config`` with ``schedule`` for one epoch of
    CLI_TRAIN_STEPS steps under ``torch.profiler``: step and epoch times,
    checkpoint sizes and write times, validation ms a batch, launches
    (``expected``: the confusion entries and the amp step's kernels, any
    other amp-step kernel 0); ``last.pth`` and ``best.pth`` load back
    strictly into fresh port models."""
    from torch.profiler import ProfilerActivity, profile
    times = dict(step=[], epoch=[], val=[], save=[])
    saved = []
    save_model = train_cli.save_model

    def timed_save(state, meta, path, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_model(state, meta, path, **kwargs)
        saved.append(dict(file=Path(path).name,
                          write_s=time.perf_counter() - t0,
                          gb=Path(path).stat().st_size / 1e9))

    reset_counts()
    with timed_factory(train_cli, "make_train_step", times["step"]), \
            timed_factory(train_cli, "make_eval_step", times["val"]), \
            mock.patch.object(train_cli, "train_one_epoch", timed_call(
                train_cli.train_one_epoch, times["epoch"])), \
            mock.patch.object(train_cli, "save_model", timed_save), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        quiet_run(train_cli.main, common + [
            "--schedule-cfg", str(schedule), "--epochs", "1"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the schedule's deterministic algorithms hold for the train CLI's
    # process; the val CLI runs in a process of its own
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    launches = dict(confusion_counts(), **step_counts(amp=True),
                    instances=dict(confusion.instances))
    if any(launches[k] != v for k, v in expected.items()) or any(
            launches[k] for k in step_counts(amp=True)
            if k not in expected):
        raise AssertionError(f"{what}: the train CLI launched {launches}, "
                             f"not {expected}")
    classes, kernels = {}, {}
    for evt in kernel_events(prof):
        ms = evt.self_device_time_total / 1e3
        kernels[evt.key] = ms
        classes[kernel_class(evt.key)] = classes.get(
            kernel_class(evt.key), 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    weights = work / "train" / "exp" / "weights"
    for name in ("last.pth", "best.pth"):
        init_model(config, checkpoint=weights / name, device="cpu")
    if len(times["step"]) != CLI_TRAIN_STEPS or len(saved) != 2:
        raise AssertionError(f"{what}: {len(times['step'])} steps, saved "
                             f"{saved}")
    print(f"{what} train: " + json.dumps(dict(
        steps=CLI_TRAIN_STEPS, step_ms=times["step"],
        ms_per_step=statistics.median(times["step"][1:]),
        epoch_ms=times["epoch"][0], val_ms_per_batch=times["val"],
        wall_ms=wall, checkpoints=saved, launches=launches,
        profiled=dict(device_ms=busy, busy_share=busy / wall,
                      by_class=dict(sorted(classes.items(),
                                           key=lambda kv: -kv[1])),
                      top_kernels=[[name[:90], ms] for name, ms in top]),
        strict_reload=["last.pth", "best.pth"])), flush=True)
    return launches, weights / "best.pth"


VAL_MODES = (("amp", ["--amp"], "make_eval_step"),
             ("tta", ["--tta"], "make_tta_eval_step"))


def cli_validate(common, work, best, n_val, modes=VAL_MODES, label="cli"):
    """The val CLI on ``best`` with ``--amp`` (its decode mIoU within
    CLI_MIOU_TOL of the train run's own validation, recorded in
    ``best.pth``; one K1 launch a batch and head of the ``--network-cfg``
    in ``common``) and with ``--tta`` (one a batch), each of ``modes``: ms
    a batch, launches."""
    recorded = load_file(best)["metadata"]
    network = load_python_config(common[common.index("--network-cfg") + 1])
    heads = 1 if network["model"].get("auxiliary_head") is None else 2
    out = {}
    for what, flags, factory in modes:
        times = []
        reset_counts()
        argv = common + ["--checkpoint", str(best), "--batch-size",
                         str(n_val), "--num-workers", str(LOADER_WORKERS),
                         "--name", what] + flags
        with timed_factory(val_cli, factory, times):
            quiet_run(val_cli.main, argv)
        launches = dict(confusion_counts(), flash=flash_counts(amp=True),
                        instances=dict(confusion.instances))
        per_batch = heads if what == "amp" else 1
        if (launches["logits"] != per_batch * CLI_VAL_BATCHES
                or launches["labels"]):
            raise AssertionError(f"{label}: val --{what} launched "
                                 f"{launches}")
        results = json.loads((work / "val" / what /
                              "results.json").read_text())
        check_metrics(results["metrics"])
        miou = results["metrics"]["decode"]["mIoU"]
        diff = abs(miou - recorded["metric.decode.mIoU"])
        if what == "amp" and diff > CLI_MIOU_TOL:
            raise AssertionError(f"{label}: val --amp mIoU {miou} vs the "
                                 f"train run's "
                                 f"{recorded['metric.decode.mIoU']}")
        out[what] = launches
        print(f"{label} val --{what}: " + json.dumps(dict(
            ms_per_batch=times, miou=miou,
            train_run_miou=recorded["metric.decode.mIoU"],
            miou_difference=diff, losses=results["losses"],
            launches=launches)), flush=True)
    return out


def ragged_phase(device, best):
    """The ragged evaluator path on the card: the model of ``best`` (bf16
    policy) on eight synthetic images of KVASIR_SIZES through the val YAML
    (to AUG_SIZE² on the card), the logits back to each image's own size
    (float32 blend), argmax and K2 once an image and head; the counts equal
    the same path on the CPU exactly, and each image's K2 counts equal
    argmax + bincount."""
    model = init_model(CONFIG, checkpoint=best, device=device)
    pipe = Pipeline.from_yaml(VAL_TRANSFORM)
    gen = torch.Generator(device=device).manual_seed(0)
    images, masks, labels = [], [], []
    for i, size in enumerate(KVASIR_SIZES):
        image, mask = make_synthetic_item(i, size, seed=3)
        mask[:8] = -1  # ignored rows
        x, m = pipe(gen, image[None], mask[None])
        images.append(x)
        masks.append(m)
        labels.append(mask)
    x, m = torch.cat(images), torch.cat(masks)
    eval_step = make_eval_step(model)

    def evaluator():
        return SegEvaluator(epoch=0, num_classes=2,
                            class_names=["background", "polyp"],
                            palette=[[0, 0, 0], [255, 255, 255]],
                            ignore_index=-1, show_result=False)

    with policy_scope("bf16"):
        step_ms = timed_batches(lambda: eval_step(x, m), runs=3)
        seg_logits, _ = eval_step(x, m)
    card = evaluator()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.process(0, seg_logits, {"ori_gt": labels})
    torch.cuda.synchronize()
    process_ms = (time.perf_counter() - t0) * 1e3
    launches = confusion_counts()
    instances = dict(confusion.instances)
    heads = len(seg_logits)
    if launches != dict(logits=0, labels=heads * len(KVASIR_SIZES)):
        raise AssertionError(f"the ragged path launched {launches}")
    host = evaluator()
    host.process(0, {k: v.cpu() for k, v in seg_logits.items()},
                 {"ori_gt": labels})
    for head, sums in host.results.items():
        if not all(np.array_equal(a, b) for a, b in
                   zip(card.results[head], sums)):
            raise AssertionError(f"{head}: the card's ragged counts "
                                 f"{card.results[head]} != the CPU's {sums}")
    for head, logits in seg_logits.items():
        for i, label in enumerate(labels):
            gt = torch.as_tensor(label, device=device).to(torch.int32)
            pred = card.class_map(logits[i], label.shape)
            k2 = confusion.confusion_histograms_from_labels(pred, gt, 2, -1)
            valid = (gt >= 0) & (gt < 2)
            matrix = torch.bincount(gt[valid].long() * 2 + pred[valid].long(),
                                    minlength=4).view(2, 2).float()
            library = torch.stack([matrix.diagonal(), matrix.sum(0),
                                   matrix.sum(1)])
            if not torch.equal(k2, library):
                raise AssertionError(f"{head} image {i}: K2 {k2} != argmax "
                                     f"+ bincount {library}")
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = card.compute_metrics()
    check_metrics(metrics)
    print("ragged evaluator: " + json.dumps(dict(
        sizes=KVASIR_SIZES, logits=list(seg_logits["decode"].shape),
        logits_dtype=str(seg_logits["decode"].dtype),
        eval_step_ms=step_ms, process_ms=process_ms,
        ms_per_batch=step_ms + process_ms, launches=launches,
        instances=instances, counts_equal_cpu=True,
        k2_equal_argmax_bincount=True, metrics=summarize(metrics))),
        flush=True)
    return dict(launches=launches, instances=instances)


def determinism_cost(device, config=CONFIG, schedule=SCHEDULE,
                     what="deeplabv3"):
    """The fused amp train step of the CLI (``schedule``'s batch at
    AUG_SIZE², augmentation fused in, its optimizer) with deterministic
    algorithms off and on, a block of DETERMINISM_STEPS steps each."""
    n = load_python_config(schedule)["train_batch_size"]
    model = init_model(config, device=device)
    randomize_(model, seed=0)
    optimizer_cfg, lr_config, _ = schedule_cfg(schedule)
    state = create_train_state(model, optimizer_cfg, lr_config)
    dataset = SyntheticDataset(pipeline=str(TRAIN_TRANSFORM), length=n,
                               image_size=(AUG_SIZE, AUG_SIZE))
    images, masks, _ = dataset.collate_fn([dataset[i] for i in range(n)])
    raw = (torch.as_tensor(images, device=device),
           torch.as_tensor(masks, device=device))
    step = make_train_step(state.model, state.optimizer, state.scheduler,
                           pipeline=dataset.device_pipeline)
    gen = torch.Generator(device=device).manual_seed(0)
    times = {"off": [], "on": []}
    try:
        with policy_scope("bf16"):
            for mode in ("off", "on"):
                torch.use_deterministic_algorithms(mode == "on")
                torch.backends.cudnn.deterministic = mode == "on"
                torch.backends.cudnn.benchmark = False
                step(*raw, gen)  # cuDNN picks its algorithms
                timed = timed_call(step, times[mode])
                for _ in range(DETERMINISM_STEPS):
                    timed(*raw, gen)
        ops = {}
        for mode in ("off", "on"):
            torch.use_deterministic_algorithms(mode == "on")
            torch.backends.cudnn.deterministic = mode == "on"
            with policy_scope("bf16"):
                print_breakdown(f"{what} fused amp step, deterministic "
                                f"{mode}", lambda: step(*raw, gen))
                ops[mode] = op_device_ms(lambda: step(*raw, gen))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    medians = {mode: statistics.median(t) for mode, t in times.items()}
    print(f"determinism cost ({what} fused amp step): " + json.dumps(dict(
        batch=[n, AUG_SIZE, AUG_SIZE, 3], step_ms=times,
        median_ms=medians, on_over_off=medians["on"] / medians["off"],
        top_operators_device_ms=ops)), flush=True)


def op_device_ms(fn, top=10):
    """The operators whose own kernels take the most device time in one
    ``fn()`` under ``torch.profiler``, as [name, ms] pairs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [[evt.key, evt.self_device_time_total / 1e3]
           for evt in prof.key_averages()
           if evt.device_type == torch.autograd.DeviceType.CPU
           and evt.self_device_time_total > 0]
    return sorted(ops, key=lambda kv: -kv[1])[:top]


def attention_layers(model):
    """The number of attention calls a forward of ``model`` makes."""
    return sum(isinstance(m, (mit.EfficientMultiheadAttention,
                              vit.MultiheadAttention))
               for m in model.modules())


def segformer_phase(device):
    """Phase 18, the SegFormer path at MiT-B2's full width: serving (8 x
    640², float32 and amp, held against the port on the CPU and, under
    amp, against plain attention); the fused train loop in float32 and
    amp at the SegFormer schedule's 16 x 640² (AdamW, WarmScheduler, the
    seeded default init); one float32 step at MiT-B0 on 4 x 256² against
    float64 on the CPU; the CLIs under the SegFormer schedule as it is
    (amp, ``deterministic=True``) and the cost of its deterministic
    algorithms.  The launches of each path."""
    model = init_model(SEGFORMER_CONFIG, device=device)
    if attention_layers(model) != MIT_B2_LAYERS:
        raise AssertionError(f"MiT-B2 has {attention_layers(model)} "
                             f"attention layers")
    randomize_(model, seed=0)
    x_nchw, row = serve(model, False, SEGFORMER_BATCH, SEGFORMER_IMAGE_SIZE,
                        MIT_B2_LAYERS, "segformer")
    print("segformer slice: " + json.dumps(row), flush=True)
    print_breakdown("segformer", lambda: model.inference(x_nchw))
    cpu_agreement_phase(model, x_nchw, 320, 320, "segformer")
    amp_launches = amp_slice_phase(model, mit, SEGFORMER_BATCH,
                                   SEGFORMER_IMAGE_SIZE, MIT_B2_LAYERS,
                                   "segformer")
    del model, x_nchw
    paths = dict(serve=row["launches"], serve_amp=amp_launches)
    for amp in (False, True):
        paths["train_amp" if amp else "train"] = fused_train_phase(
            device, amp, config=SEGFORMER_CONFIG,
            schedule_path=SEGFORMER_SCHEDULE, layers=MIT_B2_LAYERS,
            resizes=SEGFORMER_RESIZES, what="segformer", randomize=False)
    segformer_train_agreement_phase(device)
    paths["cli"] = segformer_cli_phase(device)
    return paths


def segformer_train_agreement_phase(device):
    """One float32 train step of SegFormer-B0 (the d = 32 kernels) without
    drop path and head dropout, SEGFORMER_AGREE_BATCH at
    SEGFORMER_AGREE_SIZE², on the card against float64 on the CPU (attention
    and LayerNorm without their float32 casts), as phase 10."""
    model, x, gt = agreement_inputs(SEGFORMER_AGREE_CONFIG,
                                    SEGFORMER_AGREE_BATCH,
                                    SEGFORMER_AGREE_SIZE)
    if attention_layers(model) != MIT_B0_LAYERS:
        raise AssertionError(f"MiT-B0 has {attention_layers(model)} "
                             f"attention layers")
    patches = (mock.patch.object(mit, "multihead_attention",
                                 attention_in_input_dtype),
               mock.patch.object(LayerNorm, "forward",
                                 layer_norm_in_input_dtype))
    train_agreement(device, "segformer train step", model, x, gt, patches,
                    {k: per_step_launches(k, False, MIT_B0_LAYERS,
                                          SEGFORMER_RESIZES)
                     for k in step_counts()})


def segformer_cli_phase(device):
    """The train CLI for one epoch of CLI_TRAIN_STEPS steps on SegFormer-B2
    under the SegFormer schedule as it is, on the Kvasir-shaped synthetic
    dataset of phase 17, then the val CLI on its ``best.pth`` with
    ``--amp`` (mIoU as the train run's), then the fused amp step with
    deterministic algorithms off and on.  The launches of each."""
    schedule = load_python_config(SEGFORMER_SCHEDULE)
    n, n_val = schedule["train_batch_size"], schedule["val_batch_size"]
    if not (schedule["amp"] and schedule["deterministic"]):
        raise AssertionError("the SegFormer schedule no longer sets amp and "
                             "deterministic")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_segformer_cli_"))
    try:
        dataset_cfg = tmp / "kvasir_shaped_synthetic.py"
        dataset_cfg.write_text(CLI_DATASET.format(
            train=n * CLI_TRAIN_STEPS, val=n_val * CLI_VAL_BATCHES,
            size=AUG_SIZE, train_yaml=TRAIN_TRANSFORM, val_yaml=VAL_TRANSFORM))
        work = tmp / "runs"
        common = ["--network-cfg", str(SEGFORMER_CONFIG), "--dataset-cfg",
                  str(dataset_cfg), "--work-dir", str(work), "--device",
                  str(device)]
        # the steps' kernels, and one forward a validation batch
        expected = {k: CLI_TRAIN_STEPS * per_step_launches(
            k, True, MIT_B2_LAYERS, SEGFORMER_RESIZES)
            for k in step_counts(amp=True)}
        expected["forward_bf16"] += MIT_B2_LAYERS * CLI_VAL_BATCHES
        expected.update(logits=CLI_VAL_BATCHES, labels=0)
        train, best = cli_train(common, work, expected,
                                config=SEGFORMER_CONFIG,
                                schedule=SEGFORMER_SCHEDULE,
                                what="segformer cli")
        val = cli_validate(common, work, best, n_val, modes=VAL_MODES[:1],
                           label="segformer cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        amp_policy(False)
    determinism_cost(device, SEGFORMER_CONFIG, SEGFORMER_SCHEDULE,
                     "segformer")
    return dict(train=train, val=val["amp"])


def deterministic_amp_steps(device, model, schedule_path, layers, resizes,
                            what, breakdown=False, float32_resizes=0):
    """Two amp train steps of ``model`` (the first lets cuDNN choose its
    algorithms) at ``schedule_path``'s train batch of AUG_SIZE² synthetic
    images, with its optimizer, under ``torch.use_deterministic_algorithms``
    (which raises on an op with no deterministic CUDA implementation):
    each step's launches as ``per_step_launches`` (``float32_resizes`` of
    the resizes on float32 tensors, the rest bf16), finite losses; ms of
    each step and peak memory; with ``breakdown``, a third step's device
    time by kernel class.  The launches of every step."""
    n = load_python_config(schedule_path)["train_batch_size"]
    optimizer_cfg, lr_config, _ = schedule_cfg(schedule_path)
    state = create_train_state(model, optimizer_cfg, lr_config)
    step = make_train_step(state.model, state.optimizer, state.scheduler)
    _, x, masks = synthetic_batch(device, n, AUG_SIZE)
    gt = torch.from_numpy(masks).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    step_ms, per_step, losses = [], [], []
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        with policy_scope("bf16"):
            for _ in range(2):
                counts = step_counts(amp=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(x, gt, generator)["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append({k: v - counts[k]
                                 for k, v in step_counts(amp=True).items()})
            if breakdown:
                print_breakdown(f"{what} deterministic amp step",
                                lambda: step(x, gt, generator))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    expected = {k: per_step_launches(k, True, layers, resizes)
                for k in step_counts(amp=True)}
    expected["resize_backward"] += float32_resizes
    expected["resize_backward_bf16"] -= float32_resizes
    if any(counts != expected for counts in per_step) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"{what} amp steps launched {per_step}, not "
                             f"{expected}; losses {losses}")
    print(f"{what} deterministic amp step: " + json.dumps(dict(
        batch=list(x.shape), step_ms=step_ms, loss=losses,
        peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        per_step=per_step[0])), flush=True)
    return step_counts(amp=True)


def pyramid_phase(device):
    """Phase 19, the pyramid heads at full width: UPerNet on MiT-B0 (with
    the SegFormer schedule), UPerNet on ResNetV1c-50 and PSPNet on
    ResNetV1c-50-d8 (with the kvasir schedule): serving at PYRAMID_BATCH x PYRAMID_IMAGE_SIZE² (float32,
    held against the port on the CPU), validation over two val batches
    (K1 on both heads), then the amp train steps under deterministic
    algorithms.  The launches of each path, per model."""
    out = {}
    for what, config, schedule_path, layers, resizes in (
            ("upernet_mit-b0", UPERNET_CONFIG, SEGFORMER_SCHEDULE,
             MIT_B0_LAYERS, UPERNET_RESIZES),
            ("upernet_r50", UPERNET_R50_CONFIG, SCHEDULE, 0,
             UPERNET_RESIZES),
            ("pspnet_r50-d8", PSPNET_CONFIG, SCHEDULE, 0, PSPNET_RESIZES)):
        model = init_model(config, device=device)
        if attention_layers(model) != layers:
            raise AssertionError(f"{what}: {attention_layers(model)} "
                                 f"attention layers")
        randomize_(model, seed=0)
        x_nchw, row = serve(model, False, PYRAMID_BATCH, PYRAMID_IMAGE_SIZE,
                            layers, what)
        print(f"{what} slice: " + json.dumps(row), flush=True)
        print_breakdown(what, lambda: model.inference(x_nchw))
        cpu_agreement_phase(model, x_nchw, 320, 320, what)
        n_val = load_python_config(schedule_path)["val_batch_size"]
        _, x, masks = synthetic_batch(device, 2 * n_val, PYRAMID_IMAGE_SIZE)
        gt = torch.from_numpy(masks).to(device)
        validate = validate_batches(
            TrainState(model, None), [(x[i:i + n_val], gt[i:i + n_val], {})
                                for i in (0, n_val)],
            "fp32", what=f"{what} validate")
        del x, gt, x_nchw
        out[what] = dict(serve=row["launches"], validate=validate,
                         train=deterministic_amp_steps(
                             device, model, schedule_path, layers, resizes,
                             what))
        del model
    return out


def table_cost(device):
    """BEiT-B's per-layer table work at 640² under grad, on the card: the
    port's bicubic resample (two matrix products) against
    ``F.interpolate``'s bicubic, and the gather of the (1601, 1601, 12) bias
    with its backward (``index_put_`` with accumulate), with deterministic
    algorithms off and on; whether ``F.interpolate``'s bicubic backward
    has a deterministic implementation (it raises under the flag if not).
    Forward + backward ms (median of 20, CUDA events)."""
    gen = torch.Generator(device=device).manual_seed(3)
    field = torch.randn(BEIT_TABLE_FIELD, device=device, generator=gen,
                        requires_grad=True)
    rows = BEIT_TABLE_GRID[0] * BEIT_TABLE_GRID[1] + 3
    table = torch.randn(rows, BEIT_TABLE_FIELD[1], device=device,
                        generator=gen, requires_grad=True)
    index = torch.randint(0, rows, (BEIT_TOKENS, BEIT_TOKENS), device=device,
                          generator=gen)
    grad = torch.randn(BEIT_TOKENS, BEIT_TOKENS, BEIT_TABLE_FIELD[1],
                       device=device, generator=gen)

    def resample(fn):
        def run():
            with torch.enable_grad():
                fn(field).square().sum().backward()
        return run

    def gather():
        with torch.enable_grad():
            table[index].backward(grad)

    out = {}
    try:
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            key = "deterministic" if mode else "default"
            out[f"port_bicubic_ms_{key}"] = cuda_ms(resample(
                lambda f: resize_ops.resize(f, BEIT_TABLE_GRID,
                                            mode="bicubic",
                                            align_corners=False)))
            out[f"gather_fwd_bwd_ms_{key}"] = cuda_ms(gather)
            try:
                out[f"interpolate_bicubic_ms_{key}"] = cuda_ms(resample(
                    lambda f: F.interpolate(f, BEIT_TABLE_GRID,
                                            mode="bicubic",
                                            align_corners=False)))
            except RuntimeError as err:  # the measurement: it has none
                out[f"interpolate_bicubic_ms_{key}"] = None
                out["interpolate_bicubic_deterministic_error"] = str(
                    err).splitlines()[0][:160]
    finally:
        torch.use_deterministic_algorithms(False)
    print("beit table cost: " + json.dumps(out), flush=True)


def backbone_cli_phase(device):
    """The train CLI on UPerNet-BEiT-B with the BEiT fine-tuning schedule as
    it is (amp, deterministic, AdamW with its param groups) for one epoch
    of CLI_TRAIN_STEPS steps on the Kvasir-shaped synthetic dataset of
    phase 17, then the val CLI on its ``best.pth`` with ``--amp`` (mIoU as
    the train run's); the optimizer state in ``last.pth`` holds the param
    groups.  The launches of each."""
    schedule = load_python_config(BEIT_SCHEDULE)
    n, n_val = schedule["train_batch_size"], schedule["val_batch_size"]
    if not (schedule["amp"] and schedule["deterministic"]):
        raise AssertionError("the BEiT schedule no longer sets amp and "
                             "deterministic")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_beit_cli_"))
    try:
        dataset_cfg = tmp / "kvasir_shaped_synthetic.py"
        dataset_cfg.write_text(CLI_DATASET.format(
            train=n * CLI_TRAIN_STEPS, val=n_val * CLI_VAL_BATCHES,
            size=AUG_SIZE, train_yaml=TRAIN_TRANSFORM, val_yaml=VAL_TRANSFORM))
        work = tmp / "runs"
        common = ["--network-cfg", str(BEIT_CONFIG), "--dataset-cfg",
                  str(dataset_cfg), "--work-dir", str(work), "--device",
                  str(device)]
        expected = {k: CLI_TRAIN_STEPS * per_step_launches(
            k, True, 0, UPERNET_RESIZES) for k in step_counts(amp=True)}
        expected.update(logits=2 * CLI_VAL_BATCHES, labels=0)
        train, best = cli_train(common, work, expected, config=BEIT_CONFIG,
                                schedule=BEIT_SCHEDULE, what="beit cli")
        groups = load_file(work / "train" / "exp" / "weights" / "last.pth")[
            "train_state"]["optimizer"]["param_groups"]
        if len(groups) <= 4 or len({g["lr_mult"] for g in groups}) <= 4:
            raise AssertionError(f"beit cli: {len(groups)} param groups in "
                                 f"last.pth")
        print("beit cli param groups: " + json.dumps(dict(
            groups=len(groups), lr_mults=sorted({g["lr_mult"]
                                                 for g in groups}))),
              flush=True)
        val = cli_validate(common, work, best, n_val, modes=VAL_MODES[:1],
                           label="beit cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        amp_policy(False)
    return dict(train=train, val=val["amp"])


def backbone_phase(device):
    """Phase 20, UPerNet's backbone family at full width (BACKBONE_CASES):
    each served at PYRAMID_BATCH x PYRAMID_IMAGE_SIZE² in float32 (held
    against the port on the CPU), validated over two val batches (K1 on
    both heads), two amp train steps under deterministic algorithms; the
    table cost of BEiT-B; one float32 step of Swin-T and of BEiT-B (its
    schedule's param groups) against float64 on the CPU; the BEiT CLIs.
    The launches of each path, per model."""
    out = {}
    for what, config, schedule_path in BACKBONE_CASES:
        t0 = time.perf_counter()
        model = init_model(config, device=device)
        if attention_layers(model) != 0:
            raise AssertionError(f"{what}: flash attention layers")
        randomize_(model, seed=0)
        x_nchw, row = serve(model, False, PYRAMID_BATCH, PYRAMID_IMAGE_SIZE,
                            0, what)
        print(f"{what} slice: " + json.dumps(row), flush=True)
        print_breakdown(what, lambda: model.inference(x_nchw))
        cpu_agreement_phase(model, x_nchw, 320, 320, what)
        n_val = load_python_config(schedule_path)["val_batch_size"]
        _, x, masks = synthetic_batch(device, 2 * n_val, PYRAMID_IMAGE_SIZE)
        gt = torch.from_numpy(masks).to(device)
        validate = validate_batches(
            TrainState(model, None), [(x[i:i + n_val], gt[i:i + n_val], {})
                                      for i in (0, n_val)],
            "fp32", what=f"{what} validate")
        del x, gt, x_nchw
        out[what] = dict(serve=row["launches"], validate=validate,
                         train=deterministic_amp_steps(
                             device, model, schedule_path, 0,
                             UPERNET_RESIZES, what, breakdown=True))
        del model
        torch.cuda.empty_cache()
        print(f"{what}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    table_cost(device)
    expected = {k: per_step_launches(k, False, 0, UPERNET_RESIZES)
                for k in step_counts()}
    patches = (mock.patch.object(LayerNorm, "forward",
                                 layer_norm_in_input_dtype),)
    for what, config, schedule, hold in (
            ("swin-t", SWIN_CONFIG, SCHEDULE, True),
            ("beit-b", BEIT_CONFIG, BEIT_SCHEDULE, False)):
        model, x, gt = agreement_inputs(config, BACKBONE_AGREE_BATCH,
                                        BACKBONE_AGREE_SIZE)
        train_agreement(device, f"upernet_{what} train step", model, x, gt,
                        patches, expected, schedule=schedule,
                        hold_updates=hold, run_own=False)
        del model
    print(f"table cost and agreement steps: {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    t0 = time.perf_counter()
    out["cli"] = backbone_cli_phase(device)
    print(f"beit clis: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


class MaskBranches:
    """The discrete choices of a mask-classification forward or step: the
    auction's assignments (with their cost matrices), the loss points and
    the masked attention's blocked maps.  ``recording()`` keeps them (on
    the CPU) as the card makes them; ``replaying()`` hands them out in the
    same order instead of computing them, as ``replayed_branches`` does
    for ReLUs: a blocked-map logit or a cost within rounding of a tie
    would take the other branch in float64."""

    def __init__(self):
        self.auctions, self.points, self.blocked = [], [], []

    def _patches(self, auction, points, blocked):
        return (mock.patch.object(matching, "auction_assignment", auction),
                mock.patch.object(MaskFormerHead, "_loss_points", points),
                mock.patch.object(Mask2FormerHead, "_attn_blocked", blocked))

    @contextlib.contextmanager
    def recording(self):
        auction = matching.auction_assignment
        points = MaskFormerHead._loss_points
        blocked = Mask2FormerHead._attn_blocked

        def rec_auction(cost, valid, **kwargs):
            col, owner = auction(cost, valid, **kwargs)
            self.auctions.append(tuple(t.cpu() for t in
                                       (cost, valid, col, owner)))
            return col, owner

        def rec_points(head, maps):
            self.points.append(points(head, maps))
            return self.points[-1]

        def rec_blocked(head, emb, feat):
            self.blocked.append(blocked(head, emb, feat))
            return self.blocked[-1]

        with contextlib.ExitStack() as stack:
            for patch in self._patches(rec_auction, rec_points,
                                       rec_blocked):
                stack.enter_context(patch)
            yield
        self.points = [t.cpu() for t in self.points]
        self.blocked = [t.cpu() for t in self.blocked]

    @contextlib.contextmanager
    def replaying(self):
        auctions, points = iter(self.auctions), iter(self.points)
        blocked = iter(self.blocked)

        def rep_auction(cost, valid, **kwargs):
            _, _, col, owner = next(auctions)
            return col.to(cost.device), owner.to(cost.device)

        with contextlib.ExitStack() as stack:
            for patch in self._patches(
                    rep_auction,
                    lambda head, maps: next(points).to(maps.device),
                    lambda head, emb, feat: next(blocked).to(emb.device)):
                stack.enter_context(patch)
            yield
        for left in (auctions, points, blocked):
            if next(left, None) is not None:
                raise AssertionError("the replay took fewer choices than "
                                     "the recording")


class NMFBases:
    """The NMF's random bases (``ham_head.draw_bases``): ``recording()``
    keeps them as the card draws them, ``replaying()`` hands them out in
    the same order, on the caller's device and dtype."""

    def __init__(self):
        self.bases = []

    @contextlib.contextmanager
    def recording(self):
        draw = ham_head.draw_bases

        def rec(*args):
            self.bases.append(draw(*args))
            return self.bases[-1]

        with mock.patch.object(ham_head, "draw_bases", rec):
            yield

    @contextlib.contextmanager
    def replaying(self):
        taken = iter(self.bases)
        with mock.patch.object(ham_head, "draw_bases",
                               lambda shape, device, dtype, training:
                               next(taken).to(device, dtype)):
            yield
        if next(taken, None) is not None:
            raise AssertionError("the replay drew fewer bases than the "
                                 "recording")


class RealtimeChoices:
    """The discrete choices of a PIDNet or DDRNet step beside its ReLU
    branches: OHEM's kept sets (``ohem_cross_entropy.ohem_kept``) and
    PIDHead's confident-boundary masks (``pid_head.boundary_confident``).
    ``recording()`` keeps them (on the CPU) with the devices they were
    made on; ``replaying()`` hands them out in the same order, as
    ``replayed_branches`` does for ReLUs: a probability within rounding of
    the threshold would take the other side in float64."""

    def __init__(self):
        self.kept, self.confident, self.devices = [], [], []

    def _patches(self, kept, confident):
        return (mock.patch.object(ohem_cross_entropy, "ohem_kept", kept),
                mock.patch.object(pid_head, "boundary_confident", confident))

    @contextlib.contextmanager
    def recording(self):
        kept, confident = (ohem_cross_entropy.ohem_kept,
                           pid_head.boundary_confident)

        def rec_kept(gt_prob, *args):
            self.devices.append(gt_prob.device.type)
            self.kept.append(kept(gt_prob, *args))
            return self.kept[-1]

        def rec_confident(logit_d, *args):
            self.confident.append(confident(logit_d, *args))
            return self.confident[-1]

        with contextlib.ExitStack() as stack:
            for patch in self._patches(rec_kept, rec_confident):
                stack.enter_context(patch)
            yield
        self.kept = [t.cpu() for t in self.kept]
        self.confident = [t.cpu() for t in self.confident]

    @contextlib.contextmanager
    def replaying(self):
        kept, confident = iter(self.kept), iter(self.confident)
        with contextlib.ExitStack() as stack:
            for patch in self._patches(
                    lambda gt_prob, *args: next(kept).to(gt_prob.device),
                    lambda logit_d, *args: next(confident).to(
                        logit_d.device)):
                stack.enter_context(patch)
            yield
        for left in (kept, confident):
            if next(left, None) is not None:
                raise AssertionError("the replay took fewer choices than "
                                     "the recording")


@contextlib.contextmanager
def mask_step_timers(times):
    """Each auction call and each ``_loss_points`` call (the point draws,
    the uncertainty, the top-k) timed into ``times`` (synchronised)."""
    auction, points = matching.auction_assignment, MaskFormerHead._loss_points
    timed_points = timed_call(points, times["points"])
    with mock.patch.object(matching, "auction_assignment",
                           timed_call(auction, times["auction"])), \
            mock.patch.object(MaskFormerHead, "_loss_points",
                              lambda head, maps: timed_points(head, maps)):
        yield


def mask_train_steps(device, model, amp, deterministic, what):
    """TRAIN_STEPS steps of ``train_one_epoch`` on one batch of
    M2F_TRAIN_BATCH synthetic M2F_TRAIN_SIZE² images under
    MASK_TRAIN_SCHEDULE's AdamW and warm-up (fresh state), float32 or under
    amp, with
    deterministic algorithms off or on: M2F_RESIZES resize-backward
    launches a step in the policy's dtype and none of the other, no flash
    launch, finite losses whose last three steps' mean is below the first
    three's, moved parameters; ms a step (median of steps 2-10), the
    auction's ms, rounds and host synchronisations a step, the loss
    points' ms a step, peak memory, one step's breakdown."""
    policy = "bf16" if amp else "fp32"
    optimizer_cfg, lr_config, _ = schedule_cfg(MASK_TRAIN_SCHEDULE)
    state = create_train_state(model, optimizer_cfg, lr_config)
    step = make_train_step(state.model, state.optimizer, state.scheduler)
    _, x, masks = synthetic_batch(device, M2F_TRAIN_BATCH, M2F_TRAIN_SIZE)
    gt = torch.from_numpy(masks).to(device)
    times = dict(step=[], auction=[], points=[])
    losses = []
    timed_step = timed_call(step, times["step"])

    def logged_step(img, labels, generator):
        log = timed_step(img, labels, generator)
        losses.append(float(log["loss"]))
        return log

    before = {k: v for k, v in snapshot(model).items() if "weight" in k}
    reset_counts()
    for key in matching.stats:
        matching.stats[key] = 0
    torch.cuda.reset_peak_memory_stats(device)
    torch.use_deterministic_algorithms(deterministic)
    torch.backends.cudnn.deterministic = deterministic
    generator = torch.Generator(device=device).manual_seed(0)
    try:
        with policy_scope(policy), mask_step_timers(times):
            train_one_epoch(0, logged_step, state,
                            [(x, gt, {})] * TRAIN_STEPS,
                            generator=generator)
        torch.cuda.synchronize()
        launches = step_counts(amp)
        stats = dict(matching.stats)
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        with policy_scope(policy):
            print_breakdown(f"{what} step",
                            lambda: step(x, gt, generator))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    want = {k: per_step_launches(k, amp, 0, M2F_RESIZES) * TRAIN_STEPS
            for k in launches}
    if launches != want:
        raise AssertionError(f"{what}: launched {launches}, not {want}")
    if not all(math.isfinite(v) for v in losses) or not (
            statistics.mean(losses[-3:]) < statistics.mean(losses[:3])):
        raise AssertionError(f"{what}: losses {losses}")
    moved = sum(not torch.equal(model.state_dict()[k], v)
                for k, v in before.items())
    if moved < len(before) // 2:
        raise AssertionError(f"{what}: {moved} of {len(before)} weights "
                             f"moved")
    steps = len(times["step"])
    row = dict(batch=[M2F_TRAIN_BATCH, 3, M2F_TRAIN_SIZE, M2F_TRAIN_SIZE],
               deterministic=deterministic, losses=losses,
               ms_per_step=statistics.median(times["step"][1:]),
               step_ms=times["step"],
               auction_ms_per_step=sum(times["auction"]) / steps,
               auction_calls_per_step=stats["calls"] / steps,
               auction_rounds_per_step=stats["rounds"] / steps,
               auction_syncs_per_step=stats["syncs"] / steps,
               loss_points_ms_per_step=sum(times["points"]) / steps,
               peak_memory_gb=peak, launches=launches)
    print(f"{what}: " + json.dumps(row), flush=True)
    return row


def mask_train_agreement(device):
    """One float32 train step of Mask2Former-R50 (12544 points a pair) at
    M2F_AGREE_BATCH x M2F_AGREE_SIZE² on the card against float64 on the
    CPU, as phase 10, there with the card's ReLU and max-pool branches and
    its assignments, loss points and blocked maps (``MaskBranches``); then
    the auction on the CPU on each cost matrix the card's step matched:
    the card's assignment exactly."""
    model, x, gt = agreement_inputs(MASK2FORMER_CONFIG, M2F_AGREE_BATCH,
                                    M2F_AGREE_SIZE)
    record = MaskBranches()
    patches = (mock.patch.object(LayerNorm, "forward",
                                 layer_norm_in_input_dtype),
               record.replaying())
    expected = {k: per_step_launches(k, False, 0, M2F_RESIZES)
                for k in step_counts()}
    train_agreement(device, "mask2former train step", model, x, gt, patches,
                    expected, run_own=False, card_context=record.recording)
    for cost, valid, col, owner in record.auctions:
        got_col, got_owner = matching.auction_assignment(cost, valid)
        if not (torch.equal(got_col, col) and torch.equal(got_owner, owner)):
            raise AssertionError("the CPU's auction differs from the card's "
                                 "on the step's costs")
    print("mask2former auction card vs cpu: " + json.dumps(dict(
        calls=len(record.auctions),
        problems=[list(c.shape) for c, *_ in record.auctions],
        assignments_equal=True)), flush=True)


# every query competes and keeps its segment (thresholds 0), so the RLE
# export, the AP evaluator and the PNGs of kept segments run on any weights
MASK_THRESHOLDS = ["--object-mask-threshold", "0", "--overlap-threshold",
                   "0"]
MASK_VAL_MODES = (("amp", ["--amp", "--panoptic", "--instances", "--score",
                           *MASK_THRESHOLDS], "make_eval_step"),
                  ("tta", ["--panoptic", "--tta", *MASK_THRESHOLDS],
                   "make_tta_eval_step"))


def mask_val_row(run, instances):
    """PQ/SQ/RQ, the per-class TP/FP/FN and the PNG count of the val run
    directory ``run``; with ``instances`` the mask AP and the exported
    instances."""
    results = json.loads((run / "results.json").read_text())
    pan = results["panoptic"]
    per_class = pan["per_class"]
    row = dict(PQ=pan["PQ"], SQ=pan["SQ"], RQ=pan["RQ"], TP=per_class["TP"],
               FP=per_class["FP"], FN=per_class["FN"],
               panoptic_pngs=len(list((run / "panoptic").iterdir())))
    if instances:
        ap = results["instance_ap"]
        records = json.loads((run / "instances.json").read_text())
        row.update(mAP=ap["mAP"], AP50=ap["AP50"], AP75=ap["AP75"],
                   images=len(records),
                   instances=sum(len(r["instances"]) for r in records))
    return row


def mask_cli_phase(device):
    """The train CLI on Mask2Former-R50 with the kvasir schedule as it is
    (amp, deterministic) for one epoch of CLI_TRAIN_STEPS steps on phase
    17's Kvasir-shaped synthetic dataset, then the val CLI on its
    ``best.pth`` with ``--amp --panoptic --instances --score`` (mIoU as
    the train run's) and with ``--panoptic --tta``, both at thresholds 0,
    and the same two runs on a seeded checkpoint: PQ/SQ/RQ, the mask AP,
    ``instances.json``; on the seeded checkpoint at least one kept segment
    and one exported instance.  The launches of each."""
    schedule = flagship_schedule()
    n, n_val = schedule["train_batch_size"], schedule["val_batch_size"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mask_cli_"))
    try:
        dataset_cfg = tmp / "kvasir_shaped_synthetic.py"
        dataset_cfg.write_text(CLI_DATASET.format(
            train=n * CLI_TRAIN_STEPS, val=n_val * CLI_VAL_BATCHES,
            size=AUG_SIZE, train_yaml=TRAIN_TRANSFORM,
            val_yaml=VAL_TRANSFORM))
        work = tmp / "runs"
        common = ["--network-cfg", str(MASK2FORMER_CONFIG), "--dataset-cfg",
                  str(dataset_cfg), "--work-dir", str(work), "--device",
                  str(device)]
        train, best = cli_train(common, work, dict(
            logits=CLI_VAL_BATCHES, labels=0,
            resize_backward_bf16=M2F_RESIZES * CLI_TRAIN_STEPS),
            config=MASK2FORMER_CONFIG, what="mask2former cli")
        val = cli_validate(common, work, best, n_val, modes=MASK_VAL_MODES,
                           label="mask2former cli")
        # the same val runs on a seeded checkpoint (randomize_: class
        # logits of order one), whose queries are kept: the 3-step SGD
        # model calls every query "no object", even at thresholds 0
        seeded = tmp / "seeded.pth"
        model = init_model(MASK2FORMER_CONFIG, device="cpu")
        randomize_(model, seed=0)
        save_checkpoint(model, seeded, metadata={"epoch": 0})
        del model
        for what, flags, _ in MASK_VAL_MODES:
            reset_counts()
            quiet_run(val_cli.main, common + [
                "--checkpoint", str(seeded), "--batch-size", str(n_val),
                "--num-workers", str(LOADER_WORKERS), "--name",
                f"seeded_{what}"] + flags)
            val[f"seeded_{what}"] = dict(confusion_counts(),
                                         instances=dict(confusion.instances))
            if val[f"seeded_{what}"]["logits"] != CLI_VAL_BATCHES:
                raise AssertionError(f"mask2former cli val --{what} on the "
                                     f"seeded checkpoint launched "
                                     f"{val[f'seeded_{what}']}")
        for what, *_ in MASK_VAL_MODES:
            for name in (what, f"seeded_{what}"):
                row = mask_val_row(work / "val" / name, what == "amp")
                kept = sum(row["TP"]) + sum(row["FP"])
                if (row["panoptic_pngs"] != n_val * CLI_VAL_BATCHES
                        or name.startswith("seeded") and (
                            not kept or row.get("instances", 1) == 0)):
                    raise AssertionError(f"mask2former cli val --{name}: "
                                         f"{row}")
                print(f"mask2former cli val --{name} panoptic: "
                      + json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        amp_policy(False)
    return dict(train=train, val=val)


def mask_classification_phase(device):
    """Phase 21, the mask-classification family: Mask2Former-R50 served at
    M2F_SERVE_BATCH x M2F_SERVE_SIZE² in float32 and under amp (float32
    probabilities: the head combines its queries in float32), held against
    the port on the CPU on a 320² window (with the card's blocked maps),
    validated over two batches of M2F_VAL_BATCH (1 K1 launch a batch),
    trained (from the seeded default init) at M2F_TRAIN_BATCH x
    M2F_TRAIN_SIZE² in float32 and under amp with deterministic algorithms
    off and on; the float64 agreement step;
    the CLIs; MaskFormer-R50 and Mask2Former-Swin-T served at
    MASK_SERVE_BATCH x MASK_SERVE_SIZE².  The launches of each path."""
    t0 = time.perf_counter()
    out = {}
    model = init_model(MASK2FORMER_CONFIG, device=device)
    randomize_(model, seed=0)
    print("mask2former_r50 parameters: " + json.dumps(dict(
        total=sum(p.numel() for p in model.parameters()),
        decode_head=sum(p.numel() for p in model.decode_head.parameters()))),
        flush=True)
    for amp in (False, True):
        what = "mask2former_r50" + (" amp" if amp else "")
        x_nchw, row = serve(model, amp, M2F_SERVE_BATCH, M2F_SERVE_SIZE, 0,
                            what, out_dtype=torch.float32)
        print(f"{what} slice: " + json.dumps(row), flush=True)
        with policy_scope("bf16" if amp else "fp32"):
            print_breakdown(what, lambda: model.inference(x_nchw))
        out["serve_amp" if amp else "serve"] = row["launches"]
    cpu_agreement_phase(model, x_nchw, 320, 320, "mask2former_r50")
    del x_nchw
    _, x, masks = synthetic_batch(device, 2 * M2F_VAL_BATCH, M2F_SERVE_SIZE)
    gt = torch.from_numpy(masks).to(device)
    out["validate"] = validate_batches(
        TrainState(model, None), [(x[i:i + M2F_VAL_BATCH],
                                   gt[i:i + M2F_VAL_BATCH], {})
                                  for i in (0, M2F_VAL_BATCH)],
        "fp32", what="mask2former_r50 validate")
    del x, gt
    print(f"mask2former serving and validation: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    # the train steps from the seeded default init (under randomize_'s
    # unit-gain linears the kvasir SGD diverges)
    model = init_model(MASK2FORMER_CONFIG, device=device)
    state = snapshot(model)
    out["train"] = []
    for amp, deterministic in ((False, False), (True, False), (True, True)):
        model.load_state_dict(state)
        out["train"].append(mask_train_steps(
            device, model, amp, deterministic,
            "mask2former_r50 train" + (" amp" if amp else "")
            + (" deterministic" if deterministic else "")))
    del model, state
    torch.cuda.empty_cache()
    print(f"mask2former train steps: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    mask_train_agreement(device)
    print(f"mask2former agreement step: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    out["cli"] = mask_cli_phase(device)
    print(f"mask2former clis: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for what, config in MASK_SERVE_CONFIGS:
        model = init_model(config, device=device)
        randomize_(model, seed=0)
        x_nchw, row = serve(model, False, MASK_SERVE_BATCH, MASK_SERVE_SIZE,
                            0, what)
        print(f"{what} slice: " + json.dumps(row), flush=True)
        cpu_agreement_phase(model, x_nchw, 320, 320, what)
        out[what] = row["launches"]
        del model, x_nchw
        torch.cuda.empty_cache()
    print(f"maskformer and swin serving: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


class PhaseClock:
    """Calls a phase and keeps its wall seconds under its name (phases
    called twice add up); ``report()`` prints them."""

    def __init__(self):
        self.seconds, self.t0 = {}, time.perf_counter()

    def __call__(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)
        return out

    def report(self):
        print("phase seconds: " + json.dumps(dict(
            self.seconds, total_since_build=time.perf_counter() - self.t0)),
            flush=True)


def decoder_case(name):
    """The DECODER_CASES entry of ``name``."""
    return next(case for case in DECODER_CASES if case[0] == name)


def decoder_phase(device):
    """Phase 22, the ViT decoders, Twins, PoolFormer-FPN and ResNetV1d at
    full width (DECODER_CASES): each served at PYRAMID_BATCH x
    PYRAMID_IMAGE_SIZE² in float32 and under amp (Segmenter's
    probabilities float32 under amp, as its head makes them), one 320²
    window held against the port on the CPU, validated over two val
    batches (K1 on each head), two amp train steps under deterministic
    algorithms with a profiled third; the float64 agreement steps of SVT-S
    and DPT; the SETR-MLA CLIs.  The launches of each path, per model."""
    out = {}
    for what, config, schedule_path, layers, resizes, f32 in DECODER_CASES:
        t0 = time.perf_counter()
        model = init_model(config, device=device)
        if attention_layers(model) != layers:
            raise AssertionError(f"{what}: {attention_layers(model)} "
                                 f"attention layers, not {layers}")
        randomize_(model, seed=0)
        row = {}
        out_dtype = (torch.float32 if isinstance(
            model.decode_head, SegmenterMaskTransformerHead) else None)
        for amp in (False, True):
            name = what + (" amp" if amp else "")
            x_nchw, served = serve(model, amp, PYRAMID_BATCH,
                                   PYRAMID_IMAGE_SIZE, layers, name,
                                   out_dtype=out_dtype)
            print(f"{name} slice: " + json.dumps(served), flush=True)
            with policy_scope("bf16" if amp else "fp32"):
                print_breakdown(name, lambda: model.inference(x_nchw))
            row["serve_amp" if amp else "serve"] = served["launches"]
        cpu_agreement_phase(model, x_nchw, 320, 320, what)
        n_val = load_python_config(schedule_path)["val_batch_size"]
        _, x, masks = synthetic_batch(device, 2 * n_val, PYRAMID_IMAGE_SIZE)
        gt = torch.from_numpy(masks).to(device)
        row["validate"] = validate_batches(
            TrainState(model, None), [(x[i:i + n_val], gt[i:i + n_val], {})
                                      for i in (0, n_val)],
            "fp32", what=f"{what} validate")
        del x, gt, x_nchw
        row["train"] = deterministic_amp_steps(
            device, model, schedule_path, layers, resizes, what,
            breakdown=True, float32_resizes=f32)
        out[what] = row
        del model
        torch.cuda.empty_cache()
        print(f"{what}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    patches = (mock.patch.object(mit, "multihead_attention",
                                 attention_in_input_dtype),
               mock.patch.object(vit, "multihead_attention",
                                 attention_in_input_dtype),
               mock.patch.object(LayerNorm, "forward",
                                 layer_norm_in_input_dtype))
    for what in DECODER_AGREE:
        _, config, _, layers, resizes, _ = decoder_case(what)
        model, x, gt = agreement_inputs(config, DECODER_AGREE_BATCH,
                                        DECODER_AGREE_SIZE)
        train_agreement(device, f"{what} train step", model, x, gt,
                        patches, {k: per_step_launches(k, False, layers,
                                                       resizes)
                                  for k in step_counts()})
        del model
    print(f"decoder agreement steps: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    out["cli"] = decoder_cli_phase(device)
    print(f"{DECODER_CLI} clis: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def decoder_cli_phase(device):
    """The train CLI on SETR-MLA with the kvasir schedule as it is (amp,
    deterministic, SGD) for one epoch of CLI_TRAIN_STEPS steps on the
    Kvasir-shaped synthetic dataset of phase 17, then the val CLI on its
    ``best.pth`` with ``--amp`` (mIoU as the train run's).  The launches
    of each."""
    _, config, schedule_path, layers, resizes, _ = decoder_case(DECODER_CLI)
    schedule = load_python_config(schedule_path)
    n, n_val = schedule["train_batch_size"], schedule["val_batch_size"]
    if not (schedule["amp"] and schedule["deterministic"]):
        raise AssertionError("the kvasir schedule no longer sets amp and "
                             "deterministic")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_decoder_cli_"))
    try:
        dataset_cfg = tmp / "kvasir_shaped_synthetic.py"
        dataset_cfg.write_text(CLI_DATASET.format(
            train=n * CLI_TRAIN_STEPS, val=n_val * CLI_VAL_BATCHES,
            size=AUG_SIZE, train_yaml=TRAIN_TRANSFORM, val_yaml=VAL_TRANSFORM))
        work = tmp / "runs"
        common = ["--network-cfg", str(config), "--dataset-cfg",
                  str(dataset_cfg), "--work-dir", str(work), "--device",
                  str(device)]
        # the steps' kernels, one forward and two K1 launches (decode and
        # aux heads) a validation batch
        expected = {k: CLI_TRAIN_STEPS * per_step_launches(
            k, True, layers, resizes) for k in step_counts(amp=True)}
        expected["forward_bf16"] += layers * CLI_VAL_BATCHES
        expected.update(logits=2 * CLI_VAL_BATCHES, labels=0)
        train, best = cli_train(common, work, expected, config=config,
                                schedule=schedule_path,
                                what=f"{DECODER_CLI} cli")
        val = cli_validate(common, work, best, n_val, modes=VAL_MODES[:1],
                           label=f"{DECODER_CLI} cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        amp_policy(False)
    return dict(train=train, val=val["amp"])


def realtime_case(name):
    """The REALTIME_CASES entry of ``name``."""
    return next(case for case in REALTIME_CASES if case[0] == name)


@contextlib.contextmanager
def realtime_step_probes(seen):
    """Appends to ``seen`` the device of every OHEM kept set, NMF input
    and resize backward's gradient, with the latter's ((N, C, H, W), (h,
    w), dtype)."""
    kept, nmf, backward = (ohem_cross_entropy.ohem_kept,
                           ham_head.NMF2D.forward, resize_ops.resize_backward)

    def probe_kept(gt_prob, *args):
        seen.append(("ohem", gt_prob.device.type, gt_prob.numel()))
        return kept(gt_prob, *args)

    def probe_nmf(self, x):
        seen.append(("nmf", x.device.type, tuple(x.shape)))
        return nmf(self, x)

    def probe_backward(grad, in_size, *args):
        seen.append(("resize", grad.device.type,
                     (tuple(grad.shape), tuple(in_size),
                      str(grad.dtype).replace("torch.", ""))))
        return backward(grad, in_size, *args)

    with mock.patch.object(ohem_cross_entropy, "ohem_kept", probe_kept), \
            mock.patch.object(ham_head.NMF2D, "forward", probe_nmf), \
            mock.patch.object(resize_ops, "resize_backward",
                              probe_backward):
        yield


def sort_cost(device, pixels):
    """OHEM's threshold at ``pixels`` ground-truth probabilities (a tenth
    of them ignored, +inf): ``torch.sort`` (ms by CUDA events, device ms
    of its kernels) and the whole ``ohem_kept``; and whether
    ``torch.kthvalue`` runs on a CUDA tensor under deterministic
    algorithms, with its ms where it does (it takes ``k`` as a host int,
    which the data set: a sync a call, where the sort's gather at a
    tensor index has none)."""
    gen = torch.Generator(device=device).manual_seed(5)
    p = torch.rand(pixels, generator=gen, device=device)
    valid = torch.rand(pixels, generator=gen, device=device) >= 0.1
    p = torch.where(valid, p, torch.full((), float("inf"), device=device))
    k = int(valid.sum())  # the regime of fewer valid pixels than min_kept
    kthvalue_ms = None
    torch.use_deterministic_algorithms(True)
    try:
        torch.kthvalue(p, k)
        kthvalue_ms = cuda_ms(lambda: torch.kthvalue(p, k))
    except RuntimeError:
        pass
    finally:
        torch.use_deterministic_algorithms(False)
    return dict(pixels=pixels, sort_ms=cuda_ms(lambda: torch.sort(p)),
                sort_device_ms=device_ms(lambda: torch.sort(p), None, None),
                ohem_kept_ms=cuda_ms(lambda: ohem_cross_entropy.ohem_kept(
                    p, valid, 131072, 0.9)),
                kthvalue_deterministic=kthvalue_ms is not None,
                kthvalue_ms=kthvalue_ms)


def realtime_phase(device):
    """Phase 23, SegNeXt-T, PIDNet-S and DDRNet-23-slim at full width
    (REALTIME_CASES): each served whole at REALTIME_BATCH x
    REALTIME_IMAGE_SIZE² in float32 and under amp (no flash launch),
    SegNeXt's serving twice with the same bits (the NMF's eval bases), one
    320² window held against the port on the CPU (with the card's NMF
    bases), validated over two val batches (1 K1 launch a batch), two
    deterministic amp steps at the schedule's train batch of AUG_SIZE²
    with each step's bf16 resize-backward launches and a profiled third,
    every OHEM threshold and NMF on the card and every resize backward's
    shape among phase 8b's; the sort's ms at the step's pixels; one float32
    step of PIDNet-S at 2 x 256² against float64 on the CPU on the card's
    ReLU branches, OHEM kept sets and boundary masks.  The launches of
    each path, per model."""
    out, held = {}, held_resize_shapes()
    for what, config, schedule_path, resizes in REALTIME_CASES:
        t0 = time.perf_counter()
        model = init_model(config, device=device)
        if attention_layers(model) != 0:
            raise AssertionError(f"{what}: {attention_layers(model)} "
                                 f"attention layers")
        randomize_(model, seed=0)
        row = {}
        for amp in (False, True):
            name = what + (" amp" if amp else "")
            x_nchw, served = serve(model, amp, REALTIME_BATCH,
                                   REALTIME_IMAGE_SIZE, 0, name)
            print(f"{name} slice: " + json.dumps(served), flush=True)
            with policy_scope("bf16" if amp else "fp32"):
                print_breakdown(name, lambda: model.inference(x_nchw))
            row["serve_amp" if amp else "serve"] = served["launches"]
        if what.startswith("segnext"):
            with torch.no_grad():
                same = torch.equal(model.inference(x_nchw),
                                   model.inference(x_nchw))
            if not same:
                raise AssertionError("two serving calls of SegNeXt gave "
                                     "other bits")
        cpu_agreement_phase(model, x_nchw, 320, 320, what)
        n_val = load_python_config(schedule_path)["val_batch_size"]
        _, x, masks = synthetic_batch(device, 2 * n_val, REALTIME_IMAGE_SIZE)
        gt = torch.from_numpy(masks).to(device)
        row["validate"] = validate_batches(
            TrainState(model, None), [(x[i:i + n_val], gt[i:i + n_val], {})
                                      for i in (0, n_val)],
            "fp32", what=f"{what} validate")
        del x, gt, x_nchw
        seen = []
        with realtime_step_probes(seen):
            row["train"] = deterministic_amp_steps(
                device, model, schedule_path, 0, resizes, what,
                breakdown=True)
        probes = {kind: [s for s in seen if s[0] == kind]
                  for kind in ("ohem", "nmf", "resize")}
        used = {((g[0], g[1], *in_size), g[2:])
                for _, _, (g, in_size, _) in probes["resize"]}
        unheld = sorted(used - held) + sorted(
            {d for *_, (_, _, d) in probes["resize"]} - {"bfloat16"})
        off_card = [s for s in seen if s[1] != "cuda"]
        wants = dict(ohem=not what.startswith("segnext"),
                     nmf=what.startswith("segnext"))
        if off_card or unheld or any(bool(probes[k]) != v
                                     for k, v in wants.items()):
            raise AssertionError(f"{what} steps: off the card {off_card[:3]}"
                                 f", resize shapes phase 8b never held "
                                 f"{unheld}, OHEM {len(probes['ohem'])} and "
                                 f"NMF {len(probes['nmf'])} calls")
        row["probes"] = dict(ohem_calls=len(probes["ohem"]),
                             ohem_pixels=sorted({s[2]
                                                 for s in probes["ohem"]}),
                             nmf_calls=len(probes["nmf"]),
                             resize_shapes=sorted(
                                 {s[2] for s in probes["resize"]}))
        print(f"{what} step probes: " + json.dumps(row["probes"]),
              flush=True)
        out[what] = row
        del model
        torch.cuda.empty_cache()
        print(f"{what}: {time.perf_counter() - t0:.1f} s", flush=True)
    pixels = load_python_config(SCHEDULE)["train_batch_size"] * AUG_SIZE ** 2
    cost = sort_cost(device, pixels)
    print("ohem sort: " + json.dumps(cost), flush=True)
    t0 = time.perf_counter()
    _, config, _, resizes = realtime_case(REALTIME_AGREE)
    model, x, gt = agreement_inputs(config, REALTIME_AGREE_BATCH,
                                    REALTIME_AGREE_SIZE)
    record = RealtimeChoices()
    train_agreement(device, f"{REALTIME_AGREE} train step", model, x, gt,
                    (record.replaying(),),
                    {k: per_step_launches(k, False, 0, resizes)
                     for k in step_counts()},
                    run_own=False, card_context=record.recording)
    if set(record.devices) != {"cuda"} or not record.confident:
        raise AssertionError(f"{REALTIME_AGREE} agreement step: OHEM on "
                             f"{set(record.devices)}, "
                             f"{len(record.confident)} boundary masks")
    print(f"{REALTIME_AGREE} agreement choices: " + json.dumps(dict(
        kept_sets=[int(k.sum()) for k in record.kept],
        confident_pixels=[int(c.sum()) for c in record.confident],
        seconds=time.perf_counter() - t0)), flush=True)
    out["sort"] = cost
    return out


def held_resize_shapes():
    """The ((N, C, h, w), (H, W)) pairs phase 8b holds in bf16 at
    ``align_corners`` False without a user scale."""
    held = set()
    for shapes in (SETR_RESIZES, DEEPLAB_RESIZES, DEEPLAB_RESIZES_640,
                   SEGFORMER_RESIZE_SHAPES, PSPNET_RESIZE_SHAPES,
                   M2F_RESIZE_SHAPES, PYRAMID_RESIZE_SHAPES,
                   REALTIME_RESIZE_SHAPES, NONLOCAL_RESIZE_SHAPES):
        held |= {(shape, size) for shape, size in shapes}
    held |= {(shape, size) for shape, size, scales, dtypes in
             DECODER_RESIZE_SHAPES
             if scales is None and torch.bfloat16 in dtypes}
    return held


def backbone_spec(network):
    """What makes two configs' ResNets the same network."""
    return {k: network["backbone"].get(k) for k in (
        "type", "depth", "num_stages", "out_indices", "dilations", "strides",
        "contract_dilation", "stem_channels", "base_channels")}


def shared_backbone_model(config, backbone, seeded, device):
    """``config``'s segmentor around the shared ``backbone`` (its own
    heads built on the meta device, initialised on the CPU as
    ``init_model`` does, then moved to ``device``), the backbone reset to
    its ``seeded`` state, the whole then ``randomize_``-d (which redraws
    the backbone's norms as they were seeded)."""
    network = load_python_config(config)["model"]
    if backbone_spec(network) != backbone_spec(
            load_python_config(CONFIG)["model"]):
        raise AssertionError(f"{config}: another backbone than {CONFIG}'s")
    with torch.device("meta"):
        model = build_segmentor(network)
    for name in ("decode_head", "auxiliary_head"):
        head = getattr(model, name).to_empty(device="cpu")
        init_weights(head, torch.Generator().manual_seed(0))
    model.backbone = backbone
    backbone.load_state_dict(seeded)
    model.to(device).eval()
    randomize_(model, seed=0)
    return model


def nonlocal_phase(device):
    """Phase 24, the non-local head family and DeepLabV3+ on the
    flagship's ResNetV1c-50-d8 (NONLOCAL_CASES), one seeded backbone
    shared by the ten: each served whole at NONLOCAL_BATCH x
    NONLOCAL_IMAGE_SIZE² in float32 and under amp (one timed batch after
    the warm-up, no flash launch, a breakdown each), one
    NONLOCAL_AGREE_SIZE² window held against the port on the CPU, one
    validation batch of the kvasir schedule's ``val_batch_size`` (K1 on
    both heads), two deterministic amp steps at its train batch of
    AUG_SIZE² with each step's bf16 resize-backward launches and a
    profiled third, every resize backward on the card, in bf16, at a shape
    phase 8b holds.  The launches of each path, per model."""
    held, out = held_resize_shapes(), {}
    backbone_model = init_model(CONFIG, device=device)
    randomize_(backbone_model, seed=0)
    backbone = backbone_model.backbone
    seeded = {k: v.clone() for k, v in backbone.state_dict().items()}
    del backbone_model
    n_val = load_python_config(SCHEDULE)["val_batch_size"]
    for what, config, resizes in NONLOCAL_CASES:
        t0 = time.perf_counter()
        model = shared_backbone_model(config, backbone, seeded, device)
        if model.auxiliary_head is None:
            raise AssertionError(f"{what}: the aux head is missing")
        row = {}
        for amp in (False, True):
            name = what + (" amp" if amp else "")
            x_nchw, served = serve(model, amp, NONLOCAL_BATCH,
                                   NONLOCAL_IMAGE_SIZE, 0, name, runs=1)
            print(f"{name} slice: " + json.dumps(served), flush=True)
            with policy_scope("bf16" if amp else "fp32"):
                print_breakdown(name, lambda: model.inference(x_nchw))
            row["serve_amp" if amp else "serve"] = served["launches"]
        cpu_agreement_phase(model, x_nchw, NONLOCAL_AGREE_SIZE,
                            NONLOCAL_AGREE_SIZE, what)
        _, x, masks = synthetic_batch(device, n_val, NONLOCAL_IMAGE_SIZE)
        row["validate"] = validate_batches(
            TrainState(model, None),
            [(x, torch.from_numpy(masks).to(device), {})], "fp32",
            what=f"{what} validate")
        del x, x_nchw
        seen = []
        with realtime_step_probes(seen):
            row["train"] = deterministic_amp_steps(
                device, model, SCHEDULE, 0, resizes, what, breakdown=True)
        probes = [s for s in seen if s[0] == "resize"]
        unheld = sorted({((g[0], g[1], *in_size), tuple(g[2:]))
                         for _, _, (g, in_size, _) in probes} - held)
        off = [s for s in probes if s[1] != "cuda" or s[2][2] != "bfloat16"]
        if unheld or off or not probes:
            raise AssertionError(f"{what} steps: resize shapes phase 8b "
                                 f"never held {unheld}, off the card or not "
                                 f"bf16 {off[:3]}, {len(probes)} resizes")
        row["resize_shapes"] = sorted({s[2] for s in probes})
        print(f"{what} step resizes: " + json.dumps(row["resize_shapes"]),
              flush=True)
        out[what] = row
        del model
        torch.cuda.empty_cache()
        print(f"{what}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing measured")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuBLAS's fixed workspace, which deterministic algorithms (phases 17
    # to 19) require, in force from the process's first matrix product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi, flush=True)

    t0 = time.perf_counter()
    builders = (confusion.build_library, flash_attention.build_sm90_library,
                flash_attention.build_sm90_backward_library,
                resize_backward.build_library)
    with ThreadPoolExecutor(len(builders)) as pool:  # nvcc runs outside the GIL
        libs = [build.result() for build in [pool.submit(b)
                                             for b in builders]]
    print(f"build: confusion, flash-attention forward and backward, resize "
          f"backward kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    mma = tensor_core_instructions(libs[1])
    print("forward kernels SASS: " + json.dumps(mma), flush=True)
    bwd_mma = tensor_core_instructions(libs[2])
    print("backward kernels SASS: " + json.dumps(bwd_mma), flush=True)
    if not mma["HGMMA"] or not bwd_mma["HGMMA"]:
        raise AssertionError("a tensor-core kernel library has no wgmma "
                             "(HGMMA) instruction")
    d_all = (32, 48, 64)
    for what, lib, kernels in (
            ("forward", libs[1], [f"{kernel}<{d}>" for kernel in
                                  FLASH_FWD_KERNEL.values() for d in d_all]
             + ["split_bf16x3_kernel"]),
            ("backward", libs[2], [f"{kernel}<{d}>" for kernel in
                                   (*FLASH_BWD_KERNEL[torch.float32],
                                    *FLASH_BWD_KERNEL[torch.bfloat16])
                                   for d in d_all]),
            ("resize backward", libs[3], ["resize_backward_kernel"]),
            # every instance (dtype, entry, register slots or shared bins,
            # packets or one pixel) under one name: the most of any
            ("confusion", libs[0], ["confusion_kernel"])):
        usage = resource_usage(lib)
        print(f"{what} kernels resources: " + json.dumps(usage), flush=True)
        spills = [name for name, use in usage.items()
                  if use["LOCAL"] or use["STACK"]]
        if not set(kernels) <= set(usage) or spills:
            raise AssertionError(f"{what} kernels: missing "
                                 f"{sorted(set(kernels) - set(usage))}, "
                                 f"stack or local memory (spills) in "
                                 f"{spills}")

    l2_flush = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    l2_read = torch.empty(96 << 20, dtype=torch.uint8, device=device)
    clock = PhaseClock()
    rows, held_instances = clock("3 kernel", kernel_phase, device, l2_flush,
                                 l2_read)
    del l2_read
    flash_rows = clock("4 flash", flash_phase, device, l2_flush)
    bwd_rows = clock("8 flash backward", flash_backward_phase, device,
                     l2_flush)
    resize_rows = clock("8b resize backward", resize_backward_phase, device,
                        l2_flush)
    del l2_flush
    model, x_nchw, launches, instances = clock("5 deeplabv3", slice_phase,
                                               device)
    clock("7 cpu agreement", cpu_agreement_phase, model, x_nchw,
          *SLIDE["crop_size"], "deeplabv3")
    del model, x_nchw
    setr, setr_x, setr_launches = clock("6 setr", setr_slice_phase, device)
    clock("7 cpu agreement", cpu_agreement_phase, setr, setr_x, 320, 320,
          "setr")
    if not schedule_cfg()[2]:
        raise AssertionError("the kvasir schedule no longer sets amp")
    amp_launches = clock("7 setr amp", amp_slice_phase, setr, vit,
                         SETR_BATCH, SETR_IMAGE_SIZE, SETR_LAYERS, "setr")
    del setr, setr_x
    train_launches = clock("9 setr train", setr_train_phase, device)
    clock("10 setr agreement", setr_train_agreement_phase, device)
    amp_train_launches = clock("11 setr train amp", setr_train_phase,
                               device, amp=True)
    deeplab = clock("12 deeplabv3 train", deeplab_train_phase, device)
    clock("13 deeplabv3 agreement", deeplab_train_agreement_phase, device)
    deeplab_amp = clock("14 deeplabv3 train amp", deeplab_train_phase,
                        device, amp=True)
    clock("15 pipeline", pipeline_phase, device)
    fused = clock("16 fused", fused_train_phase, device)
    fused_amp = clock("16 fused amp", fused_train_phase, device, amp=True)
    cli, cli_instances = clock("17 clis", cli_phase, device)
    segformer = clock("18 segformer", segformer_phase, device)
    pyramid = clock("19 pyramid", pyramid_phase, device)
    backbones = clock("20 upernet backbones", backbone_phase, device)
    backbone_cli = backbones.pop("cli")
    mask = clock("21 mask classification", mask_classification_phase,
                 device)
    decoders = clock("22 vit decoders", decoder_phase, device)
    decoder_cli = decoders.pop("cli")
    realtime = clock("23 realtime", realtime_phase, device)
    realtime_sort = realtime.pop("sort")
    nonlocal_paths = clock("24 non-local heads", nonlocal_phase, device)
    clock.report()
    # the flagship's evaluation paths: validation in float32 and under amp
    # (on ready batches and through the val pipeline), TTA in float32; the
    # new heads' validation (SegFormer's through the val pipeline)
    eval_paths = (deeplab["validate"], deeplab["tta"],
                  deeplab_amp["validate"], fused["validate"],
                  fused_amp["validate"], segformer["train"]["validate"],
                  segformer["train_amp"]["validate"],
                  *(p["validate"] for p in pyramid.values()),
                  *(p["validate"] for p in backbones.values()),
                  *(p["validate"] for p in decoders.values()),
                  *(p["validate"] for p in realtime.values()),
                  *(p["validate"] for p in nonlocal_paths.values()))
    # the new paths' serving (the evaluator) and the SegFormer and BEiT CLIs
    new_serving = (segformer["serve"], segformer["serve_amp"],
                   *(p["serve"] for p in pyramid.values()),
                   *(p["serve"] for p in backbones.values()),
                   *(p[k] for p in decoders.values()
                     for k in ("serve", "serve_amp")),
                   *(p[k] for p in realtime.values()
                     for k in ("serve", "serve_amp")),
                   *(p[k] for p in nonlocal_paths.values()
                     for k in ("serve", "serve_amp")))
    segformer_cli = (segformer["cli"]["train"], segformer["cli"]["val"],
                     backbone_cli["train"], backbone_cli["val"],
                     decoder_cli["train"], decoder_cli["val"])
    # every confusion instance of a main path was held against the plain
    # version in the kernel phase
    path_instances = {*instances, *setr_launches["confusion_instances"],
                      *amp_launches["confusion_instances"], *cli_instances,
                      *(k for path in eval_paths for k in path["instances"]),
                      *(k for path in new_serving
                        for k in path["confusion_instances"]),
                      *(k for path in segformer_cli
                        for k in path["instances"])}
    mask_serving = (mask["serve"], mask["serve_amp"],
                    *(mask[what] for what, _ in MASK_SERVE_CONFIGS))
    mask_cli = (mask["cli"]["train"], *mask["cli"]["val"].values())
    path_instances |= {*mask["validate"]["instances"],
                       *(k for path in mask_serving
                         for k in path["confusion_instances"]),
                       *(k for path in mask_cli for k in path["instances"])}
    if not path_instances <= set(held_instances):
        raise AssertionError(f"confusion instances of a main path that the "
                             f"kernel phase never held: "
                             f"{sorted(path_instances - set(held_instances))}")

    setr_launches_k1 = dict(logits=setr_launches["confusion"], labels=0)
    amp_launches_k1 = dict(logits=amp_launches["confusion"], labels=0)
    flagship, setr_row = rows[0], flash_rows[0]
    # K2's shapes on the ragged path: the smallest and largest Kvasir image
    kvasir_rows = [r for r in rows if r["shape"][0] == 1]
    deeplab_resize = [r for r in resize_rows
                      if [r["shape"], r["size"]] in
                      [[list(a), list(b)] for a, b in
                       (*DEEPLAB_RESIZES, *DEEPLAB_RESIZES_640)]]
    pool_row = next(r for r in deeplab_resize
                    if r["shape"] == [16, 512, 1, 1]
                    and r["dtype"] == "bfloat16")
    resize_row = next(r for r in resize_rows
                      if r["shape"] == [8, 256, 160, 160]
                      and r["dtype"] == "bfloat16")
    setr_bf16_row = flash_rows[1]
    # the launches of each flash and resize-backward counter on the new
    # paths (phases 18 to 22): the train steps (SegFormer float32 and amp,
    # its train CLI, the pyramid heads', the UPerNet backbones' and phase
    # 22's amp steps, the BEiT and SETR-MLA train CLIs), the val CLIs and
    # the serving forwards
    new_steps = (segformer["train"]["train"], segformer["train_amp"]["train"],
                 segformer["cli"]["train"],
                 *(path["train"] for path in pyramid.values()),
                 *(path["train"] for path in backbones.values()),
                 backbone_cli["train"])
    decoder_steps = (*(path["train"] for path in decoders.values()),
                     decoder_cli["train"])
    decoder_new = {k: sum(path.get(k, 0) for path in decoder_steps)
                   + decoder_cli["val"]["flash"].get(k, 0)
                   for k in [*flash_attention.launches,
                             *resize_backward.launches]}
    for path in decoders.values():
        decoder_new["forward"] += path["serve"]["flash"]
        decoder_new["split_bf16x3"] += path["serve"]["split"]
        decoder_new["forward_bf16"] += path["serve_amp"]["flash"]
    decoder_k1 = (sum(p[k]["confusion"] for p in decoders.values()
                      for k in ("serve", "serve_amp"))
                  + sum(p["validate"]["logits"] for p in decoders.values())
                  + decoder_cli["train"]["logits"]
                  + decoder_cli["val"]["logits"])
    print("vit decoders launches: " + json.dumps(dict(
        k1=decoder_k1, **decoder_new)), flush=True)
    # phase 22 runs float32 steps only in its agreement steps, which are
    # checks, not a main path
    unlaunched = [k for k in ("forward", "split_bf16x3", "forward_bf16",
                              "backward_dq_bf16", "backward_dkv_bf16",
                              "resize_backward_bf16")
                  if not decoder_new[k]]
    if unlaunched or not decoder_k1:
        raise AssertionError(f"a kernel of phase 22's paths never "
                             f"launched: {unlaunched}, K1 {decoder_k1}")
    new = {k: sum(path.get(k, 0) for path in new_steps)
           + segformer["cli"]["val"]["flash"].get(k, 0) + decoder_new[k]
           for k in [*flash_attention.launches, *resize_backward.launches]}
    for path in (segformer["serve"],
                 *(path["serve"] for path in pyramid.values())):
        new["forward"] += path["flash"]
        new["split_bf16x3"] += path["split"]
    new["forward_bf16"] += segformer["serve_amp"]["flash"]
    new_k1 = (sum(path["confusion"] for path in new_serving)
              + sum(path["logits"] for path in segformer_cli))
    if not all(new.values()) or not new_k1:
        raise AssertionError(f"a kernel of the SegFormer and pyramid paths "
                             f"never launched: {new}, K1 {new_k1}")
    # phase 20's own paths: K1 in serving, validation and the CLIs, the
    # bf16 resize backward in every amp step
    backbone_k1 = (sum(p["serve"]["confusion"] + p["validate"]["logits"]
                       for p in backbones.values())
                   + backbone_cli["train"]["logits"]
                   + backbone_cli["val"]["logits"])
    backbone_resize = (sum(p["train"]["resize_backward_bf16"]
                           for p in backbones.values())
                       + backbone_cli["train"]["resize_backward_bf16"])
    # phase 21's paths: K1 in serving, validation and the CLIs, the resize
    # backward in every train step (float32 and bf16) and the train CLI
    mask_k1 = (sum(path["confusion"] for path in mask_serving)
               + mask["validate"]["logits"]
               + sum(path["logits"] for path in mask_cli))
    mask_resize = {k: sum(row["launches"][k] for row in mask["train"])
                   + mask["cli"]["train"].get(k, 0)
                   for k in resize_backward.launches}
    print("mask classification launches: " + json.dumps(dict(
        k1=mask_k1, **mask_resize)), flush=True)
    if not mask_k1 or not all(mask_resize.values()):
        raise AssertionError(f"a kernel of phase 21's paths never launched: "
                             f"K1 {mask_k1}, resize backward {mask_resize}")
    # phase 23's paths: K1 in serving and validation, the bf16 resize
    # backward in every amp step
    realtime_k1 = sum(p[k]["confusion"] for p in realtime.values()
                      for k in ("serve", "serve_amp")) + sum(
        p["validate"]["logits"] for p in realtime.values())
    realtime_resize = sum(p["train"]["resize_backward_bf16"]
                          for p in realtime.values())
    realtime_flash = sum(p["train"][k] for p in realtime.values()
                         for k in FLASH_KEYS[True])
    print("realtime launches: " + json.dumps(dict(
        k1=realtime_k1, resize_backward_bf16=realtime_resize,
        flash=realtime_flash, ohem_sort=realtime_sort)), flush=True)
    if not realtime_k1 or not realtime_resize or realtime_flash:
        raise AssertionError(f"phase 23's paths: K1 {realtime_k1}, resize "
                             f"backward {realtime_resize}, or a flash "
                             f"kernel launched")
    # phase 24's paths: K1 in serving and validation, the bf16 resize
    # backward in every amp step, no flash kernel
    nonlocal_k1 = sum(p[k]["confusion"] for p in nonlocal_paths.values()
                      for k in ("serve", "serve_amp")) + sum(
        p["validate"]["logits"] for p in nonlocal_paths.values())
    nonlocal_resize = sum(p["train"]["resize_backward_bf16"]
                          for p in nonlocal_paths.values())
    nonlocal_flash = sum(p["train"][k] for p in nonlocal_paths.values()
                         for k in FLASH_KEYS[True]) + sum(
        p[k]["flash"] for p in nonlocal_paths.values()
        for k in ("serve", "serve_amp"))
    print("non-local heads launches: " + json.dumps(dict(
        k1=nonlocal_k1, resize_backward_bf16=nonlocal_resize,
        flash=nonlocal_flash)), flush=True)
    if not nonlocal_k1 or not nonlocal_resize or nonlocal_flash:
        raise AssertionError(f"phase 24's paths: K1 {nonlocal_k1}, resize "
                             f"backward {nonlocal_resize}, or a flash "
                             f"kernel launched")
    print("upernet backbones launches: " + json.dumps(dict(
        k1=backbone_k1, resize_backward_bf16=backbone_resize)), flush=True)
    if not backbone_k1 or not backbone_resize:
        raise AssertionError(f"a kernel of phase 20's paths never "
                             f"launched: K1 {backbone_k1}, resize backward "
                             f"{backbone_resize}")

    def mit_entries(kernel_rows, dtype, keys, tag="mit"):
        """The MiT stage rows (with ``tag="path"``: phase 22's rows) of
        one dtype, ``keys`` of each."""
        return [{k: r[k] for k in (tag, "shape", *keys)}
                for r in kernel_rows if r[tag]
                and r["dtype"] == str(dtype).replace("torch.", "")]

    fwd_keys = ("ms", "device_ms", "plain_ms", "sdpa_ms", "sdpa_device_ms",
                "bound_ms", "bound_by", "ctas", "max_abs_err")
    segformer_resize = [r for r in resize_rows
                        if [r["shape"], r["size"]] in
                        [[list(a), list(b)] for a, b, *_ in
                         (*SEGFORMER_RESIZE_SHAPES, *PSPNET_RESIZE_SHAPES,
                          *PYRAMID_RESIZE_SHAPES, *DECODER_RESIZE_SHAPES,
                          *REALTIME_RESIZE_SHAPES,
                          *NONLOCAL_RESIZE_SHAPES)]]

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
                "launches": train[f"backward_{part}{suffix}"]
                            + new[f"backward_{part}{suffix}"],
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
                "sass": bwd_mma,
                # the four stages of each MiT train case, and phase 22's
                # training shapes
                **{tag: mit_entries(bwd_rows, dtype, (
                    f"{part}_ms", f"{part}_device_ms", "plain_ms",
                    "sdpa_backward_ms", "sdpa_backward_device_ms",
                    f"{part}_bound_ms", f"{part}_bound_by", f"{part}_ctas",
                    "max_abs_err"), tag=tag) for tag in ("mit", "path")}}
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
        # the DeepLabV3 and SETR serving slices, the flagship's validation
        # (also through the val pipeline) and TTA, and the CLIs (K1) with
        # the ragged evaluator path (K2); SegFormer's, the pyramid heads'
        # and the UPerNet backbones' serving and validation, and the
        # SegFormer and BEiT CLIs (K1)
        "launches": sum(path["logits"] + path["labels"] for path in
                        (launches, setr_launches_k1, amp_launches_k1,
                         *eval_paths, cli)) + new_k1 + mask_k1,
        "cli_launches": {"logits": cli["logits"], "labels": cli["labels"]},
        # phase 23's and 24's serving and validation (in "launches"
        # through the evaluation and serving paths)
        "realtime_launches": realtime_k1,
        "nonlocal_launches": nonlocal_k1,
        "max_abs_err": max(max(r["max_abs_err"], r["labels_max_abs_err"])
                           for r in rows),
        "ms": flagship["ms"],
        "device_ms": flagship["device_ms"],
        # after a flush that reads, leaving the L2 clean
        "device_ms_clean_l2": flagship["device_ms_clean_l2"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        # torch.argmax, then torch.bincount of the (gt, pred) pairs
        "library_ms": flagship["library_ms"],
        "library_device_ms": flagship["library_device_ms"],
        # the labels entry (K2) at the same shape; its yardstick is the
        # bincount alone
        "labels_ms": flagship["labels_ms"],
        "labels_device_ms": flagship["labels_device_ms"],
        "labels_device_ms_clean_l2": flagship["labels_device_ms_clean_l2"],
        "labels_plain_ms": flagship["labels_plain_ms"],
        "labels_bound_ms": flagship["labels_bound_ms"],
        "labels_library_ms": flagship["labels_library_ms"],
        "labels_library_device_ms": flagship["labels_library_device_ms"],
        # K2 at the ragged path's shapes, one Kvasir image each
        "labels_kvasir": [{k: r[k] for k in (
            "shape", "labels_ms", "labels_device_ms", "labels_plain_ms",
            "labels_bound_ms", "labels_library_ms",
            "labels_library_device_ms")} for r in kvasir_rows],
    }, {
        "name": "flash_attention_forward",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/"
                  "flash_attention_sm90.cu",
        "replaces": "image_segmentation_lab_tpu/ops/pallas/"
                    "flash_attention.py:61",
        # the float32 serving phases and the float32 train steps
        "launches": setr_launches["flash"] + train_launches["forward"]
                    + new["forward"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                           if r["dtype"] == "float32"),
        "ms": setr_row["ms"],
        "device_ms": setr_row["device_ms"],
        "plain_ms": setr_row["plain_ms"],
        # the bound of the route taken, six bf16 tensor-core products per
        # float32 product; beside it float32's products on the CUDA cores
        "bound_ms": setr_row["bound_ms"],
        "bound_by": setr_row["bound_by"],
        "bound_route": "6 bf16 tensor-core products per float32 product, "
                       "989 TFLOP/s",
        "cuda_core_bound_ms": setr_row["cuda_core_bound_ms"],
        "split_device_ms": setr_row["split_device_ms"],
        "library_ms": setr_row["sdpa_ms"],
        "library_device_ms": setr_row["sdpa_device_ms"],
        "sass": mma,
        "mit": mit_entries(flash_rows, torch.float32,
                           (*fwd_keys, "split_device_ms")),
        "path": mit_entries(flash_rows, torch.float32,
                            (*fwd_keys, "split_device_ms"), tag="path"),
    }, {
        "name": "flash_attention_forward_bf16",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/"
                  "flash_attention_sm90.cu",
        "replaces": "image_segmentation_lab_tpu/ops/pallas/"
                    "flash_attention.py:61",
        # the amp serving phases and the amp train steps
        "launches": amp_launches["flash"]
                    + amp_train_launches["forward_bf16"]
                    + new["forward_bf16"],
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
        "mit": mit_entries(flash_rows, torch.bfloat16, fwd_keys),
        "path": mit_entries(flash_rows, torch.bfloat16, fwd_keys,
                            tag="path"),
    }] + backward_entries(torch.float32, train_launches) + [{
        # the float32 operand split of the forward (q, k, v) and the
        # backward (q, k, v, dO), part of the K3-K5 port; one kernel in
        # sm90_bf16x3.cuh, launched through the forward's library; the row
        # is the backward's four operands at SETR's shape
        "name": "split_bf16x3",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/sm90_bf16x3.cuh",
        "replaces": f"{flash_py}:156",
        "also_replaces": [f"{flash_py}:187", f"{flash_py}:61"],
        # the float32 serving phases and train steps (forward and backward)
        "launches": setr_launches["split"] + train_launches["split_bf16x3"]
                    + new["split_bf16x3"],
        "max_abs_err": 0.0,  # phases 4 and 8 raise unless it gives plain's
                             # bits
        "ms": f32_rows[0]["split_ms"],
        "device_ms": f32_rows[0]["split_device_ms"],
        "plain_ms": f32_rows[0]["split_plain_ms"],
        "bound_ms": f32_rows[0]["split_bound_ms"],
        "bound_by": f32_rows[0]["split_bound_by"],
        "library_ms": None,
    }] + backward_entries(torch.bfloat16, amp_train_launches) + [{
        # the bilinear resize's gradient: XLA transposes the JAX resize's
        # gathers, no Pallas kernel; the row is SETR's largest upsample in
        # bf16, as the amp step runs it
        "name": "resize_backward",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/resize_backward.cu",
        "replaces": "image_segmentation_lab_tpu/utils/ops.py:74",
        # the SETR train steps, float32 and amp; SegFormer's train steps
        # (float32, amp, the CLI), the pyramid heads' and the UPerNet
        # backbones' amp steps and the BEiT train CLI
        "launches": sum(counts[k] for counts in
                        (train_launches, amp_train_launches)
                        for k in RESIZE_KEY.values())
                    + new["resize_backward"] + new["resize_backward_bf16"]
                    + sum(mask_resize.values()) + realtime_resize
                    + nonlocal_resize,
        # phase 23's and 24's amp steps' shares of them
        "realtime_launches": realtime_resize,
        "nonlocal_launches": nonlocal_resize,
        "max_abs_err": 0.0,  # phase 8b raises unless it gives plain's bits
        "ms": resize_row["ms"],
        "device_ms": resize_row["device_ms"],
        "plain_ms": resize_row["plain_ms"],
        "bound_ms": resize_row["bound_ms"],
        "bound_by": resize_row["bound_by"],
        "library_ms": resize_row["library_ms"],
        "library_device_ms": resize_row["library_device_ms"],
        # every SegFormer-B2, UPerNet, PSPNet and phase 22 shape and dtype
        "rows": [{k: r[k] for k in ("shape", "size", "scales", "dtype",
                                    "ms", "device_ms", "plain_ms",
                                    "library_ms", "library_device_ms",
                                    "bound_ms", "bound_by")}
                 for r in segformer_resize],
    }, {
        # the same kernel on the flagship's wide tables; the row is the
        # ASPP image pool in bf16, as the amp step runs it, and "rows" holds
        # every DeepLabV3 shape and dtype
        "name": "resize_backward_deeplabv3",
        "route": "cuda",
        "source": "image_segmentation_lab_tpu_torch/csrc/resize_backward.cu",
        "replaces": "image_segmentation_lab_tpu/utils/ops.py:74",
        # the flagship's train steps, float32 and amp, on ready batches
        # and with the augmentation fused in
        "launches": sum(path["train"][k] for path in
                        (deeplab, deeplab_amp, fused, fused_amp)
                        for k in RESIZE_KEY.values())
                    + cli["resize_backward_bf16"],
        "max_abs_err": 0.0,
        "ms": pool_row["ms"],
        "device_ms": pool_row["device_ms"],
        "plain_ms": pool_row["plain_ms"],
        "bound_ms": pool_row["bound_ms"],
        "bound_by": pool_row["bound_by"],
        "library_ms": pool_row["library_ms"],
        "library_device_ms": pool_row["library_device_ms"],
        "rows": [{k: r[k] for k in ("shape", "size", "dtype", "ms",
                                    "device_ms", "plain_ms", "library_ms",
                                    "library_device_ms", "bound_ms",
                                    "bound_by")} for r in deeplab_resize],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
