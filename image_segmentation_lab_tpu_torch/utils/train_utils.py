"""Epoch loops around the train and eval steps (counterpart of
``utils/train_utils.py``): ``train_one_epoch``, ``validate_one_epoch``,
``pth_metadata`` and ``save_model``.

A data loader is any iterable of ``(images, labels, infos)`` batches, as
arrays or tensors; a batch already on the model's device is used where it
is.  Where the augmentation runs:

* ``fused_aug=True``: the train step was built with the pipeline
  (``make_train_step(..., pipeline=...)``); the loader's raw ``(N, H, W,
  C)`` batches go to the card as they are (uint8: a quarter of the bytes
  of float32) and the step augments them;
* ``pipeline``: the pipeline augments each raw batch before the step;
* neither: the batches are ``(N, C, H, W)`` images, ready for the model.

``validate_one_epoch`` takes a ``pipeline`` too (the val YAML: Resize and
Normalize), drawing from a generator seeded with ``epoch * 100003 +
batch_idx``, as the JAX package's key.  The log values are summed on the
device and read back once an epoch, so the host never waits on a step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.initialize.checkpoint import pack_train_state, save_checkpoint


def _to_device(images, labels, device):
    """float32 images and int32 labels on ``device`` (no copy where they
    already are)."""
    return (torch.as_tensor(images, dtype=torch.float32, device=device),
            torch.as_tensor(labels, device=device).to(torch.int32))


def _mean(running: Dict[str, torch.Tensor], count: int) -> Dict[str, float]:
    return {k: float(v) / max(count, 1) for k, v in running.items()}


def train_one_epoch(epoch: int,
                    train_step,
                    state,
                    dataloader,
                    pipeline=None,
                    generator: Optional[torch.Generator] = None,
                    fused_aug: bool = False) -> tuple:
    """One epoch of ``train_step(img, gt, generator)`` over ``dataloader``,
    advancing ``state.step`` per batch; returns ``(state, mean log
    vars)``.  Every draw (augmentation, dropout) comes from ``generator``
    (on the model's device; by default seeded with ``epoch``)."""
    if fused_aug and pipeline is not None:
        raise ValueError("fused_aug augments inside the train step; a "
                         "pipeline as well would augment twice")
    if hasattr(dataloader, "set_epoch"):
        dataloader.set_epoch(epoch)
    device = next(state.model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(epoch)
    running: Dict[str, Any] = {}
    count = 0
    for images, labels, _ in dataloader:
        if fused_aug:  # the raw batch; the step augments it
            images = torch.as_tensor(images, device=device)
            labels = torch.as_tensor(labels, device=device)
        elif pipeline is not None:
            images, labels = pipeline(generator, images, labels)
        else:
            images, labels = _to_device(images, labels, device)
        log_vars = train_step(images, labels, generator)
        state.step += 1
        count += 1
        for k, v in log_vars.items():
            running[k] = running.get(k, 0.0) + v
    return state, _mean(running, count)


def validate_one_epoch(epoch: int,
                       eval_step,
                       state,
                       dataloader,
                       evaluator,
                       pipeline=None) -> tuple:
    """``eval_step(img, gt)`` per batch (after ``pipeline``, where given),
    each head's logits into ``evaluator.process`` with the batch's labels
    (on the model's device, where the step took them), then
    ``evaluator.compute_metrics()``; returns ``(mean log vars,
    metrics)``."""
    device = next(state.model.parameters()).device
    running: Dict[str, Any] = {}
    count = 0
    for batch_idx, (images, labels, infos) in enumerate(dataloader):
        if pipeline is not None:
            generator = torch.Generator(device=device).manual_seed(
                epoch * 100003 + batch_idx)
            images, labels = pipeline(generator, images, labels)
        else:
            images, labels = _to_device(images, labels, device)
        seg_logits, log_vars = eval_step(images, labels)
        count += 1
        for k, v in log_vars.items():
            running[k] = running.get(k, 0.0) + v
        if "ori_gt" not in infos:
            infos = dict(infos, ori_gt=labels)
        evaluator.process(batch_idx, seg_logits, infos)
    return _mean(running, count), evaluator.compute_metrics()


def pth_metadata(metadata: Dict[str, Any],
                 epoch: int,
                 fits: float,
                 train_log_vars: Optional[Dict] = None,
                 val_log_vars: Optional[Dict] = None,
                 val_metrics: Optional[Dict] = None) -> Dict[str, Any]:
    """``metadata`` with ``epoch``, ``fits`` and the ``train.*``, ``val.*``
    and ``metric.<head>.*`` values (host floats and lists)."""
    meta = dict(metadata)
    meta.update(epoch=epoch, fits=float(fits))
    for prefix, vars_ in (("train", train_log_vars), ("val", val_log_vars)):
        for k, v in (vars_ or {}).items():
            meta[f"{prefix}.{k}"] = float(v)
    for head, metrics in (val_metrics or {}).items():
        for k, v in metrics.items():
            if np.isscalar(v) or (isinstance(v, np.ndarray) and v.ndim == 0):
                meta[f"metric.{head}.{k}"] = float(v)
            else:
                meta[f"metric.{head}.{k}"] = np.asarray(v).tolist()
    return meta


def save_model(state, metadata: Dict[str, Any], path,
               include_train_state: bool = False,
               backend: str = "pickle", ema_params=None) -> None:
    """``{'metadata', 'state_dict'}`` checkpoint of ``state.model``, with
    the resumable ``train_state`` (optimizer, scheduler, step, BN counters
    and ``ema_params``, the EMA tensors where --ema-decay is on) when
    ``include_train_state``."""
    train_state = (pack_train_state(state, ema_params)
                   if include_train_state else None)
    save_checkpoint(state.model, path, metadata=metadata,
                    train_state=train_state, backend=backend)
