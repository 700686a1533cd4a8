"""Dropout layers (counterpart of ``models/basic/drop.py``).

``Dropout`` and ``Dropout2d`` zero elements or whole channels in training
and are the identity in eval mode, as the JAX layers are without
``train=True``.  ``DropPath`` (stochastic depth) zeroes a whole sample's
residual branch with probability ``drop_prob`` in training and rescales
the kept ones by ``1 / (1 - drop_prob)``.  Random bits come from torch's
generator; they cannot equal JAX's.
"""

import torch
from torch import nn

from ...core.registry_hub import DROPOUT

Dropout = DROPOUT.register("Dropout")(nn.Dropout)
Dropout2d = DROPOUT.register("Dropout2d")(nn.Dropout2d)


@DROPOUT.register("DropPath")
class DropPath(nn.Module):

    def __init__(self, drop_prob: float = 0.1):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x):
        if not self.training or self.drop_prob == 0.0:
            return x
        keep = 1.0 - self.drop_prob
        mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1),
                           dtype=x.dtype, device=x.device).bernoulli_(keep)
        return x / keep * mask
