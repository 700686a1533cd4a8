"""Cross-entropy losses (counterpart of
``models/losses/cross_entropy_loss.py``): softmax CE with ``class_weight``,
sigmoid BCE with one-hot expansion (or the squeezed one-channel binary
case), mask CE, the ``use_sigmoid``/``use_mask`` switches, file-loadable
class weights, ``avg_non_ignore`` and ``loss_name``.

Logits are NCHW ``(N, C, H, W)`` and labels ``(N, H, W)`` integers, so the
class axis (softmax, one-hot, ``pos_weight``) is dim 1.  Ignore handling is
mask-based, as in the JAX package: ignored pixels contribute exact zeros
and still count in the denominator of a mean unless ``avg_non_ignore`` is
set.  The math runs in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.registry_hub import LOSS
from .utils import get_class_weight, weight_reduce_loss


def _channel_view(values, like):
    """A per-class vector shaped to broadcast over dim 1 of ``like``."""
    return torch.as_tensor(values, dtype=torch.float32,
                           device=like.device).view(
        -1, *([1] * (like.dim() - 2)))


def cross_entropy(pred, label, weight=None, class_weight=None,
                  reduction="mean", avg_factor=None, ignore_index=-100,
                  avg_non_ignore=False):
    """Softmax CE over dim 1."""
    pred = pred.float()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    loss = -F.log_softmax(pred, dim=1).gather(1, safe.unsqueeze(1))[:, 0]
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=torch.float32,
                             device=pred.device)
        loss = loss * cw[safe]
    loss = torch.where(valid, loss, 0.0)
    if avg_factor is None and avg_non_ignore and reduction == "mean":
        avg_factor = valid.sum()
    if weight is not None:
        weight = weight.float()
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def _expand_onehot_labels(labels, label_weights, num_classes, ignore_index):
    """One-hot on dim 1 with validity masking; a label outside
    ``[0, num_classes)`` that is not ignored gives an all-zero row, as
    ``jax.nn.one_hot`` does."""
    valid = (labels >= 0) & (labels != ignore_index)
    classes = torch.arange(num_classes, device=labels.device).view(
        1, -1, *([1] * (labels.dim() - 1)))
    bin_labels = ((labels.unsqueeze(1) == classes) & valid.unsqueeze(1))
    bin_labels = bin_labels.float()
    valid_f = valid.unsqueeze(1).float().expand_as(bin_labels)
    if label_weights is None:
        bin_label_weights = valid_f
    else:
        bin_label_weights = label_weights.unsqueeze(1).expand_as(
            bin_labels) * valid_f
    return bin_labels, bin_label_weights, valid_f


def _bce_with_logits(pred, target, pos_weight=None):
    """``F.binary_cross_entropy_with_logits(reduction='none')`` written
    out as the JAX package writes it."""
    log_p, log_1mp = F.logsigmoid(pred), F.logsigmoid(-pred)
    if pos_weight is not None:
        return -(pos_weight * target * log_p + (1 - target) * log_1mp)
    return -(target * log_p + (1 - target) * log_1mp)


def binary_cross_entropy(pred, label, weight=None, reduction="mean",
                         avg_factor=None, class_weight=None,
                         ignore_index=-100, avg_non_ignore=False, **kwargs):
    """Sigmoid BCE: ``pred (N, 1, H, W)`` with a binary label, or ``(N, C,
    H, W)`` with index labels, which are one-hot expanded on dim 1."""
    pred = pred.float()
    if pred.dim() == label.dim() + 1 and pred.shape[1] == 1:
        pred = pred[:, 0]  # binary segmentation: squeeze the channel
    pos_weight = None
    if pred.dim() != label.dim():
        label, weight, valid_mask = _expand_onehot_labels(
            label, weight, pred.shape[1], ignore_index)
        if class_weight is not None:
            pos_weight = _channel_view(class_weight, pred)
    else:
        valid_mask = ((label >= 0) & (label != ignore_index)).float()
        weight = valid_mask if weight is None else weight * valid_mask
        if class_weight is not None:  # trailing-dim broadcast, as in JAX
            pos_weight = torch.as_tensor(class_weight, dtype=torch.float32,
                                         device=pred.device)
    if reduction == "mean" and avg_factor is None and avg_non_ignore:
        avg_factor = valid_mask.sum()
    loss = _bce_with_logits(pred, label.float(), pos_weight)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def mask_cross_entropy(pred, target, label, reduction="mean",
                       avg_factor=None, class_weight=None, ignore_index=None,
                       **kwargs):
    """Per-mask BCE on the channel ``label`` selects for each sample."""
    assert ignore_index is None, "BCE loss does not support ignore_index"
    assert reduction == "mean" and avg_factor is None
    pred_slice = pred[torch.arange(pred.shape[0], device=pred.device),
                      label.long()]
    loss = _bce_with_logits(pred_slice.float(), target.float())
    if class_weight is not None:
        # F.binary_cross_entropy_with_logits(weight=...) semantics: the
        # whole per-element loss, trailing-dim broadcast
        loss = loss * torch.as_tensor(class_weight, dtype=torch.float32,
                                      device=pred.device)
    return loss.mean()


@LOSS.register()
class CrossEntropyLoss:

    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = "mean", class_weight=None,
                 loss_weight: float = 1.0, loss_name: str = "loss_ce",
                 avg_non_ignore: bool = False):
        assert not (use_sigmoid and use_mask)
        self.use_sigmoid = use_sigmoid
        self.use_mask = use_mask
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.class_weight = get_class_weight(class_weight)
        self.avg_non_ignore = avg_non_ignore
        self._loss_name = loss_name
        if use_sigmoid:
            self.cls_criterion = binary_cross_entropy
        elif use_mask:
            self.cls_criterion = mask_cross_entropy
        else:
            self.cls_criterion = cross_entropy

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override: Optional[str] = None,
                 ignore_index: int = -100, **kwargs):
        assert reduction_override in (None, "none", "mean", "sum")
        reduction = reduction_override or self.reduction
        return self.loss_weight * self.cls_criterion(
            cls_score, label, weight, class_weight=self.class_weight,
            reduction=reduction, avg_factor=avg_factor,
            avg_non_ignore=self.avg_non_ignore, ignore_index=ignore_index,
            **kwargs)

    @property
    def loss_name(self) -> str:
        return self._loss_name
