"""OHEM cross-entropy (counterpart of
``models/losses/ohem_cross_entropy.py``; the loss PIDNet and DDRNet train
their semantic branches with).

A pixel is kept when the softmax probability of its ground-truth class is
below ``max(thres, p_k)``, where ``p_k`` is the ``min(min_kept, n_valid -
1)``-th smallest ground-truth probability (invalid pixels sort last as
+inf); the loss is the cross-entropy's mean over the kept set, a weight
mask folded into a masked mean, with no shape that depends on the data.
As in the JAX package, with fewer than ``min_kept`` valid pixels the
threshold becomes the largest valid probability, so the easiest pixel(s)
drop out.

The threshold comes from one ``torch.sort`` of every pixel's probability
(``torch.kthvalue`` has no deterministic CUDA implementation) and one
gather at the index, on the tensors' device: no host sync.  The kept set
is ``ohem_kept``, a module function looked up at call time, so a replay
can hand in a recorded set.  Logits ``(N, C, H, W)``, labels ``(N, H,
W)``; the math runs in float32 (float64 for a float64 input).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.registry_hub import LOSS
from .utils import get_class_weight


def ohem_kept(gt_prob, valid, min_kept: int, thres: float):
    """The kept pixels (a bool vector) of the flat ground-truth
    probabilities ``gt_prob`` (+inf where not ``valid``)."""
    n = gt_prob.shape[0]
    k = torch.clamp(torch.clamp(valid.sum() - 1, max=min_kept), 0, n - 1)
    min_value = torch.sort(gt_prob).values[k]
    threshold = torch.clamp(min_value, min=thres)
    return valid & (gt_prob < threshold)


@LOSS.register()
class OhemCrossEntropy:

    def __init__(self,
                 ignore_label: int = 255,
                 thres: float = 0.7,
                 min_kept: int = 100000,
                 loss_weight: float = 1.0,
                 class_weight=None,
                 loss_name: str = "loss_ohem"):
        self.ignore_label = ignore_label
        self.thres = float(thres)
        self.min_kept = max(int(min_kept), 1)
        self.loss_weight = loss_weight
        self.class_weight = get_class_weight(class_weight)
        self._loss_name = loss_name

    def __call__(self, score, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=None, **kwargs):
        """``weight`` (an optional per-pixel weight) multiplies the kept
        pixels' cross-entropy."""
        ignore = self.ignore_label if ignore_index is None else ignore_index
        x = score.to(torch.promote_types(score.dtype, torch.float32))
        flat = x.movedim(1, -1).reshape(-1, x.shape[1])
        labels = target.reshape(-1)
        valid = labels != ignore
        safe = torch.where(valid, labels, 0).long()

        logp = F.log_softmax(flat, dim=-1).gather(1, safe[:, None])[:, 0]
        losses = -logp
        if self.class_weight is not None:
            cw = torch.as_tensor(self.class_weight, dtype=x.dtype,
                                 device=x.device)
            losses = losses * cw[safe]
        if weight is not None:
            losses = losses * weight.reshape(-1).to(x.dtype)

        gt_prob = torch.where(valid, logp.detach().exp(),
                              torch.full((), float("inf"), dtype=x.dtype,
                                         device=x.device))
        kept = ohem_kept(gt_prob, valid, self.min_kept, self.thres)
        kept_f = kept.to(x.dtype)
        loss = (losses * kept_f).sum() / torch.clamp(kept_f.sum(), min=1.0)
        return self.loss_weight * loss

    @property
    def loss_name(self):
        return self._loss_name
