"""Train state and train step (counterpart of ``train_state.py``).

``make_train_step(model, optimizer, scheduler=None)`` returns
``train_step(img, gt, generator) -> log_vars``: ``forward_train`` (decode
and aux heads, losses, ``acc_seg``), ``parse_losses``, ``backward``
(through the flash-attention kernels on the card), the optimizer update,
the LR scheduler's step and, in train mode, the BatchNorm running
statistics.  Every dropout mask is drawn from ``generator`` (on the
model's device), never from torch's global generator, as the JAX step
takes its ``dropout_rng``.  The log values stay tensors on the device: the
step makes no host synchronisation.

The step reads the global compute policy, as the JAX step does:
``amp_policy(True)`` (the schedule's ``amp=True``) runs ``forward_train``
under bfloat16 autocast over the float32 parameters, with no loss scaler,
and the backward through the flash kernels in bfloat16.  The MoE aux loss
and the eval and TTA steps are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .core.builder import LR_SCHEDULER, build_from_cfg, build_optimizer
from .models.basic.drop import use_generator


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
    """Optimizer from ``optimizer_cfg`` over the trainable parameters and,
    with ``lr_config``, its LR schedule over ``steps_per_epoch``."""
    model.train()
    optimizer = build_optimizer(
        optimizer_cfg, [p for p in model.parameters() if p.requires_grad])
    scheduler = None
    if lr_config is not None:
        scheduler = build_from_cfg(lr_config, LR_SCHEDULER).torch_scheduler(
            optimizer, steps_per_epoch)
    return TrainState(model, optimizer, scheduler)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler=None):
    """One train step per call; ``img (N, C, H, W)`` float, ``gt (N, H,
    W)`` integer labels, ``generator`` a ``torch.Generator`` on the
    model's device."""

    def train_step(img, gt, generator: torch.Generator) -> Dict:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad(), use_generator(generator):
            _, losses = model.forward_train(img, gt)
            loss, log_vars = parse_losses(losses)
            loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {name: value.detach() for name, value in log_vars.items()}

    return train_step
