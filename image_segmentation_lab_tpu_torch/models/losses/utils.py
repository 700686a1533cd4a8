"""Loss utilities (counterpart of ``models/losses/utils.py``):
``get_class_weight``, ``reduce_loss`` and ``weight_reduce_loss`` with the
eps-guarded ``avg_factor``."""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def get_class_weight(class_weight):
    """Class weights from a list or a ``.npy`` file (the JAX package also
    reads pickle, JSON and YAML files; no config of the repo uses them)."""
    if not isinstance(class_weight, str):
        return class_weight
    if class_weight.endswith(".npy"):
        return np.load(class_weight)
    raise ValueError(f"class weights from {class_weight!r}: expected a list "
                     f"or a .npy file")


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction {reduction}")


def weight_reduce_loss(loss, weight=None, reduction: str = "mean",
                       avg_factor=None):
    """Element-wise weight, then reduce; ``avg_factor`` replaces the
    element count of a mean (plus float32 eps)."""
    if weight is not None:
        assert weight.dim() == loss.dim()
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        return loss.sum() / (avg_factor + _EPS)
    if reduction != "none":
        raise ValueError('avg_factor can not be used with reduction="sum"')
    return loss
