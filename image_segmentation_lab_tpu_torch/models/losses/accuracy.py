"""Pixel accuracy (counterpart of ``models/losses/accuracy.py``).

``pred (N, C, ...)`` scores, ``target (N, ...)`` labels; top-k over dim 1
with the JAX tie order (a stable sort of ``-pred``: the lower class index
wins a tie; for top-1 ``argmax``, which keeps the first maximum, saves the
sort), optional ``thresh`` on the score and ``ignore_index``; the
result is a percentage with the eps-guarded division.  It carries no
gradient.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def accuracy(pred, target, topk=1, thresh=None, ignore_index=None):
    assert isinstance(topk, (int, tuple))
    return_single = isinstance(topk, int)
    topks = (topk,) if return_single else topk
    maxk = max(topks)
    if pred.shape[0] == 0:
        accu = [pred.new_tensor(0.0) for _ in topks]
        return accu[0] if return_single else accu
    assert pred.dim() == target.dim() + 1
    assert maxk <= pred.shape[1], (
        f"maxk {maxk} exceeds pred dimension {pred.shape[1]}")

    pred = pred.detach().float()
    if maxk == 1:  # argmax returns the first maximum: the same tie order
        order = pred.argmax(dim=1, keepdim=True)
    else:
        order = torch.sort(-pred, dim=1, stable=True).indices[:, :maxk]
    pred_label = order.movedim(1, 0)                    # (maxk, N, ...)
    pred_value = pred.gather(1, order).movedim(1, 0)
    correct = pred_label == target[None]
    if thresh is not None:
        correct = correct & (pred_value > thresh)
    if ignore_index is not None:
        valid = target != ignore_index
        correct = correct & valid[None]
        total = valid.sum() + _EPS
    else:
        total = float(target.numel()) + _EPS
    res = [(correct[:k].float().sum() + _EPS) * 100.0 / total
           for k in topks]
    return res[0] if return_single else res

