"""Class-balanced boundary BCE (counterpart of
``models/losses/boundary_loss.py``; the loss PIDNet trains its D branch
with).

Positive pixels weigh ``n_neg / n`` and negative ones ``n_pos / n``
(pixels that are neither 0 nor 1 weigh 0), then the mean over all
elements of the weighted binary cross-entropy with logits.  The math runs
in float32 (float64 for a float64 input).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.registry_hub import LOSS


@LOSS.register()
class BoundaryLoss:

    def __init__(self, loss_weight: float = 1.0,
                 loss_name: str = "loss_boundary"):
        self.loss_weight = loss_weight
        self._loss_name = loss_name

    def __call__(self, bd_pre, bd_gt, **kwargs):
        """``bd_pre (N, 1, H, W)`` boundary logits; ``bd_gt (N, H, W)`` in
        {0, 1}."""
        dtype = torch.promote_types(bd_pre.dtype, torch.float32)
        x = bd_pre.reshape(-1).to(dtype)
        t = bd_gt.reshape(-1).to(dtype)
        pos = (t == 1).to(dtype)
        neg = (t == 0).to(dtype)
        n = torch.clamp(pos.sum() + neg.sum(), min=1.0)
        w = pos * neg.sum() / n + neg * pos.sum() / n
        bce = -(t * F.logsigmoid(x) + (1 - t) * F.logsigmoid(-x))
        return self.loss_weight * (w * bce).mean()

    @property
    def loss_name(self):
        return self._loss_name
