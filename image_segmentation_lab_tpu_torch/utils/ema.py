"""Exponential moving average of the trainable parameters (counterpart of
``utils/ema.py``).

``ema = ema * decay + param * (1 - decay)`` after every train step, on the
parameters' device, with no host synchronisation.  The BatchNorm
statistics are not averaged: validation and ``best.pth`` use the averaged
parameters with the live statistics (``ema_weights``), ``last.pth`` keeps
the raw parameters and carries the average in its ``train_state``, so that
resume continues it (``ema_init``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn


def wrap_train_step_with_ema(train_step, model: nn.Module, decay: float,
                             ema_init: Optional[Dict[str, torch.Tensor]] =
                             None):
    """Wrap ``train_step(img, gt, generator) -> log_vars`` so that an EMA of
    ``model``'s trainable parameters follows each step.  The average starts
    from ``ema_init`` (``{name: tensor}``, e.g. a checkpoint's) or from the
    parameters as they are.  Returns ``(wrapped_step, ema_params_fn)``:
    ``ema_params_fn()`` gives the current ``{name: tensor}``."""
    assert 0.0 < decay < 1.0, decay
    params = {name: p for name, p in model.named_parameters()
              if p.requires_grad}
    seed = params if ema_init is None else ema_init
    ema = {name: torch.as_tensor(seed[name]).detach().to(
        device=p.device, dtype=p.dtype).clone() for name, p in params.items()}
    names = list(params)

    def wrapped(img, gt, generator):
        log_vars = train_step(img, gt, generator)
        with torch.no_grad():
            for name in names:
                ema[name].mul_(decay).add_(params[name] * (1.0 - decay))
        return log_vars

    return wrapped, lambda: ema


@contextlib.contextmanager
def ema_weights(model: nn.Module, ema_params: Optional[Dict[str,
                                                            torch.Tensor]]):
    """``model`` with ``ema_params`` in place of its parameters for the
    block (nothing changes when it is None); the raw parameters after."""
    if ema_params is None:
        yield model
        return
    params = dict(model.named_parameters())
    raw = {name: params[name].detach().clone() for name in ema_params}
    with torch.no_grad():
        for name, value in ema_params.items():
            params[name].copy_(value)
    try:
        yield model
    finally:
        with torch.no_grad():
            for name, value in raw.items():
                params[name].copy_(value)
