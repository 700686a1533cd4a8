"""PSPHead and its pyramid pooling module PPM (counterpart of
``models/decode_heads/psp_head.py``).

PPM: per pool scale, ``ops/pooling.adaptive_avg_pool2d`` (whose backward
is deterministic at every output size), a 1x1 ConvModule
(``branches.<i>``, JAX ``branches_<i>``) and a bilinear resize back to the
input's size.  PSPHead concatenates ``[x, ppm...]`` into a 3x3
``bottleneck`` before ``cls_seg``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...ops.pooling import adaptive_avg_pool2d
from ...utils.ops import resize
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


class PPM(nn.Module):

    def __init__(self, pool_scales: Sequence[int], in_channels: int,
                 channels: int, conv_cfg=None, norm_cfg=None, act_cfg=None,
                 align_corners: bool = False):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        self.align_corners = align_corners
        self.branches = nn.ModuleList(
            ConvModule(in_channels, channels, 1, conv_cfg=conv_cfg,
                       norm_cfg=norm_cfg, act_cfg=act_cfg)
            for _ in self.pool_scales)

    def forward(self, x):
        return [resize(conv(adaptive_avg_pool2d(x, scale)), size=x.shape[2:],
                       mode="bilinear", align_corners=self.align_corners)
                for scale, conv in zip(self.pool_scales, self.branches)]


@DECODEHEAD.register()
class PSPHead(BaseDecodeHead):

    def __init__(self, pool_scales: Sequence[int] = (1, 2, 3, 6), **kwargs):
        super().__init__(**kwargs)
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        self.psp_modules = PPM(pool_scales, self.fused_in_channels,
                               self.channels,
                               align_corners=self.align_corners, **common)
        self.bottleneck = ConvModule(
            self.fused_in_channels + len(pool_scales) * self.channels,
            self.channels, 3, padding=1, **common)

    def _forward_feature(self, inputs):
        x = self._transform_inputs(inputs)
        return self.bottleneck(torch.cat([x, *self.psp_modules(x)], dim=1))

    def forward(self, inputs):
        return self.cls_seg(self._forward_feature(inputs))
