"""Train state and train step (counterpart of ``train_state.py``).

``make_train_step(model, optimizer, scheduler=None, pipeline=None)``
returns ``train_step(img, gt, generator) -> log_vars``: with a
``pipeline``, first the augmentation of the raw batch (``(N, H, W, C)``
uint8 as the loader gives it, without grad), then ``forward_train``
(decode and aux heads, losses, ``acc_seg``), ``parse_losses``,
``backward`` (through the flash-attention kernels on the card), the
optimizer update, the LR scheduler's step and, in train mode, the
BatchNorm running statistics.  Every draw comes from ``generator`` (on the
model's device), never from torch's global generator: the augmentation's
first, the dropout masks' second, as the JAX step splits its key into
``aug_rng, dropout_rng``.  The log values stay tensors on the device: the
step makes no host synchronisation.

The step reads the global compute policy, as the JAX step does:
``amp_policy(True)`` (the schedule's ``amp=True``) runs ``forward_train``
under bfloat16 autocast over the float32 parameters, with no loss scaler,
and the backward through the flash kernels in bfloat16.  The MoE aux loss
is not ported yet.

``make_eval_step`` (losses and evaluator-ready logits per head, no grad)
and ``make_tta_step`` (multi-scale and flip averaged probabilities) run
the model in eval mode; ``binarize_channels`` makes a one-channel head's
output argmax-able at its threshold (``head_threshold``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from .core.builder import LR_SCHEDULER, build_from_cfg, build_optimizer
from .models.basic.drop import use_generator
from .models.decode_heads.decode_head import DEFAULT_BINARY_THRESHOLD
from .utils.ops import resize


def parse_losses(losses: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Mean of every entry; the total is the sum of the keys that contain
    'loss' and is logged as ``loss``."""
    log_vars = {name: torch.as_tensor(value).mean()
                for name, value in losses.items()}
    loss = sum(v for k, v in log_vars.items() if "loss" in k)
    log_vars["loss"] = loss
    return loss, log_vars


@dataclass
class TrainState:
    """The model (in train mode, on its device), its optimizer and LR
    scheduler, and the number of train steps taken (the caller's loop
    advances it)."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[Any] = None
    step: int = 0


def create_train_state(model: nn.Module, optimizer_cfg: Dict,
                       lr_config: Optional[Dict] = None,
                       steps_per_epoch: int = 1) -> TrainState:
    """Optimizer from ``optimizer_cfg`` over the trainable parameters (with
    ``paramwise_cfg``, one param group per multiplier pair) and, with
    ``lr_config``, its LR schedule over ``steps_per_epoch``."""
    model.train()
    optimizer = build_optimizer(
        optimizer_cfg, [(name, p) for name, p in model.named_parameters()
                        if p.requires_grad])
    scheduler = None
    if lr_config is not None:
        scheduler = build_from_cfg(lr_config, LR_SCHEDULER).torch_scheduler(
            optimizer, steps_per_epoch)
    return TrainState(model, optimizer, scheduler)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler=None, pipeline=None):
    """One train step per call; ``img (N, C, H, W)`` float (with a
    ``pipeline``: the raw ``(N, H, W, C)`` batch, uint8 or float), ``gt
    (N, H, W)`` labels, ``generator`` a ``torch.Generator`` on the model's
    device."""

    def train_step(img, gt, generator: torch.Generator) -> Dict:
        if pipeline is not None:
            with record_function("augmentation"):
                img, gt = pipeline(generator, img, gt)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad(), use_generator(generator):
            _, losses = model.forward_train(img, gt)
            loss, log_vars = parse_losses(losses)
            loss.backward()
        # optax updates every parameter, so weight decay and momentum reach
        # one that no loss depends on (EMAHead's ``ema_mid_conv``, behind
        # its ``stop_gradient``); torch's optimizers skip a missing gradient
        for group in optimizer.param_groups:
            for param in group["params"]:
                if param.requires_grad and param.grad is None:
                    param.grad = torch.zeros_like(param)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {name: value.detach() for name, value in log_vars.items()}

    return train_step


def head_threshold(model) -> float:
    """Binary-segmentation threshold of the (last) decode head."""
    head = getattr(model, "decode_head", None)
    if isinstance(head, (list, tuple, nn.ModuleList)) and len(head):
        head = head[-1]
    threshold = getattr(head, "threshold", None)
    return DEFAULT_BINARY_THRESHOLD if threshold is None else float(threshold)


def binarize_channels(value, threshold: float, is_probs: bool = False):
    """Put a constant channel in front of every one-channel ``(N, 1, H,
    W)`` output -- ``logit(t)`` for logits, ``t`` for probabilities -- so
    that the evaluator's channel argmax is ``sigmoid(x) > t`` (ties go to
    the constant channel, as ``argmax`` takes the first).  Dicts, lists and
    tuples are mapped; other outputs pass through."""
    if isinstance(value, dict):
        return {k: binarize_channels(v, threshold, is_probs)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(binarize_channels(v, threshold, is_probs)
                           for v in value)
    if not isinstance(value, torch.Tensor) or value.dim() < 2 \
            or value.shape[1] != 1:
        return value
    const = threshold if is_probs else math.log(
        threshold / max(1.0 - threshold, 1e-8))
    return torch.cat([torch.full_like(value, const), value], dim=1)


def make_eval_step(model: nn.Module,
                   rescale_size: Optional[Tuple[int, int]] = None):
    """``eval_step(img (N, C, H, W), gt (N, H, W)) -> (seg_logits,
    log_vars)``: the model in eval mode, ``forward_train`` without grad
    (the logits at the labels' size, or at ``rescale_size``), the losses
    through ``parse_losses``, and each head's logits through
    ``binarize_channels``.  Under the bf16 policy the forward runs in
    bfloat16 autocast, as ``forward_train`` does.  Everything stays on the
    device: no host synchronisation."""
    threshold = head_threshold(model)
    meta = {"ori_img_size_hw": rescale_size} if rescale_size else {}

    def eval_step(img, gt):
        model.eval()
        with torch.no_grad():
            seg_logits, losses = model.forward_train(
                img, gt, meta, rescale=rescale_size is not None)
            _, log_vars = parse_losses(losses)
        return ({k: binarize_channels(v, threshold)
                 for k, v in seg_logits.items()}, log_vars)

    return eval_step


def make_tta_step(model: nn.Module, scales=(0.75, 1.0, 1.25)):
    """``tta_step(img (N, C, H, W)) -> probs (N, out_channels, H, W)``: for
    each scale a bilinear resize to ``(int(H·s), int(W·s))``, then that
    image and its horizontal flip through ``inference`` (probabilities),
    the flip undone, each resized back to ``(H, W)``; the mean of the
    ``2·len(scales)`` results.  The model runs in eval mode without
    grad."""

    def tta_step(img):
        model.eval()
        h, w = img.shape[2:]
        acc, n = 0.0, 0
        with torch.no_grad():
            for s in scales:
                scaled = resize(img, size=(int(h * s), int(w * s)),
                                mode="bilinear", align_corners=False)
                for flip in (False, True):
                    probs = model.inference(scaled.flip(3) if flip
                                            else scaled)
                    if flip:
                        probs = probs.flip(3)
                    acc = acc + resize(probs, size=(h, w), mode="bilinear",
                                       align_corners=False)
                    n += 1
        return acc / n

    return tta_step
