"""NonLocal2d (counterpart of ``models/utils/non_local.py``; Wang et al.,
CVPR 2018).

``theta``, ``phi`` and ``g`` are bare 1x1 convs to ``in_channels //
reduction`` channels; the pairwise scores ``theta phiᵀ`` are float32
(``ops/attention.float32_product``); ``embedded_gaussian`` divides them by
``sqrt(ci)`` (``use_scale``) and takes the softmax over the keys,
``dot_product`` divides them by the number of keys ``S``.  The scores,
cast to ``g``'s dtype, weight ``g``; ``conv_out`` (a ConvModule with the
norm and no activation, or without a norm a bare conv drawn from
normal(0, 1e-10) when ``zeros_init``, else normal(0, 0.01)) maps back, and
the block is residual.  ``sub_sample`` max-pools the keys and values 2 x
2.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ...ops.attention import float32_product
from ...ops.pooling import max_pool2d
from ..basic.convolution import Conv2d
from ..common.conv_module import ConvModule


class NonLocal2d(nn.Module):

    def __init__(self, in_channels: int, reduction: int = 2,
                 use_scale: bool = True, mode: str = "embedded_gaussian",
                 sub_sample: bool = False, conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None, zeros_init: bool = True):
        super().__init__()
        if mode not in ("embedded_gaussian", "dot_product"):
            raise ValueError(f"NonLocal2d mode {mode!r} unsupported (the "
                             "configs use embedded_gaussian/dot_product)")
        self.mode, self.use_scale, self.sub_sample = mode, use_scale, \
            sub_sample
        self.zeros_init = zeros_init
        self.inter_channels = ci = max(in_channels // reduction, 1)
        self.g = Conv2d(in_channels, ci, 1)
        self.theta = Conv2d(in_channels, ci, 1)
        self.phi = Conv2d(in_channels, ci, 1)
        if norm_cfg is not None:
            self.conv_out = ConvModule(ci, in_channels, 1, conv_cfg=conv_cfg,
                                       norm_cfg=norm_cfg, act_cfg=None)
        else:
            self.conv_out = Conv2d(ci, in_channels, 1)

    def init_weights(self, generator):
        if isinstance(self.conv_out, nn.Conv2d):
            nn.init.normal_(self.conv_out.weight, 0.0,
                            1e-10 if self.zeros_init else 0.01,
                            generator=generator)

    def forward(self, x):
        n, _, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)       # (N, L, ci)
        kv_in = max_pool2d(x, 2, 2) if self.sub_sample else x
        phi = self.phi(kv_in).flatten(2)                         # (N, ci, S)
        g = self.g(kv_in).flatten(2).transpose(1, 2)             # (N, S, ci)
        pairwise = float32_product(theta, phi)
        if self.mode == "embedded_gaussian":
            if self.use_scale:
                pairwise = pairwise / math.sqrt(self.inter_channels)
            pairwise = torch.softmax(pairwise, dim=-1)
        else:
            pairwise = pairwise / phi.shape[2]
        y = torch.matmul(pairwise.to(g.dtype), g)
        y = y.transpose(1, 2).reshape(n, self.inter_channels, h, w)
        return x + self.conv_out(y)
