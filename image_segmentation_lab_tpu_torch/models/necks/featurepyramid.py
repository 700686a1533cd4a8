"""Feature2Pyramid neck (counterpart of ``models/necks/featurepyramid.py``):
an isotropic transformer's same-stride taps (BEiT's and MAE's four maps at
stride 16) as a four-scale pyramid for UPerHead.

Each tap takes the branch of its rescale factor: 4 is a 2 x 2 stride-2
transposed conv, the norm, exact GELU and a second transposed conv; 2 is
one transposed conv; 1 is the identity; 0.5 and 0.25 are 2 x 2 and 4 x 4
max pools.  Submodules carry the JAX names (``up4_deconv1``,
``ops_4_norm``, ``up4_deconv2``, ``up2_deconv``).  Init
(``init_weights``): the transposed convs take torch's default, uniform in
+-1/sqrt(out·k·k) for weights and biases, as the JAX module's do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import NECK
from ...ops.pooling import max_pool2d
from ..basic.convolution import ConvTranspose2d
from ..builder import build_norm_layer


@NECK.register()
class Feature2Pyramid(nn.Module):

    def __init__(self, embed_dim: int = 768,
                 rescales: Sequence[float] = (4, 2, 1, 0.5),
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        for k in rescales:
            if k not in (4, 2, 1, 0.5, 0.25):
                raise KeyError(f"invalid rescale {k!r} (expect 4/2/1/.5/.25)")
        self.rescales = tuple(rescales)
        C = embed_dim
        if 4 in self.rescales:
            self.up4_deconv1 = ConvTranspose2d(C, C, 2, stride=2)
            self.ops_4_norm = build_norm_layer(
                dict(norm_cfg or dict(type="SyncBatchNorm",
                                      requires_grad=True)), C)[1]
            self.up4_deconv2 = ConvTranspose2d(C, C, 2, stride=2)
        if 2 in self.rescales:
            self.up2_deconv = ConvTranspose2d(C, C, 2, stride=2)

    def init_weights(self, generator):
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[1] * math.prod(m.kernel_size)
                bound = 1.0 / math.sqrt(fan_in)
                for t in (m.weight, m.bias):
                    t.uniform_(-bound, bound, generator=generator)

    def forward(self, inputs):
        assert len(inputs) == len(self.rescales), (len(inputs),
                                                   self.rescales)
        outs = []
        for x, k in zip(inputs, self.rescales):
            if k == 4:
                x = self.up4_deconv1(x)
                x = self.up4_deconv2(F.gelu(self.ops_4_norm(x)))
            elif k == 2:
                x = self.up2_deconv(x)
            elif k == 0.5:
                x = max_pool2d(x, 2, 2)
            elif k == 0.25:
                x = max_pool2d(x, 4, 4)
            outs.append(x)
        return tuple(outs)
