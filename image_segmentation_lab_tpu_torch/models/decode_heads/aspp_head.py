"""ASPPHead (counterpart of ``models/decode_heads/aspp_head.py``).

One ConvModule per dilation (1x1 for dilation 1, else 3x3 with padding equal
to the dilation), an image-pool branch (global average pool, 1x1 ConvModule,
upsampled back), and a 3x3 bottleneck over the concatenation
``[pool, branches...]``.  ``_build_aspp_module`` builds the branches: the
hook through which ``DepthwiseSeparableASPPHead`` makes them separable.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


class ASPPModule(nn.Module):
    """Atrous conv branches, held in ``branches`` (JAX path
    ``branches_<i>``): a 1x1 ConvModule for dilation 1, else
    ``dilated_conv(d)``, by default a 3x3 ConvModule padded by ``d``."""

    def __init__(self, dilations: Sequence[int], in_channels: int,
                 channels: int, conv_cfg=None, norm_cfg=None, act_cfg=None,
                 dilated_conv=None):
        super().__init__()
        common = dict(conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg)
        if dilated_conv is None:
            def dilated_conv(d):
                return ConvModule(in_channels, channels, 3, dilation=d,
                                  padding=d, **common)
        self.branches = nn.ModuleList(
            ConvModule(in_channels, channels, 1, **common) if d == 1
            else dilated_conv(d) for d in dilations)

    def forward(self, x):
        return [branch(x) for branch in self.branches]


@DECODEHEAD.register()
class ASPPHead(BaseDecodeHead):

    def __init__(self, dilations: Sequence[int] = (1, 6, 12, 18), **kwargs):
        super().__init__(**kwargs)
        self.dilations = tuple(dilations)
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        self.image_pool_conv = ConvModule(self.fused_in_channels,
                                          self.channels, 1, **common)
        self.aspp_modules = self._build_aspp_module()
        self.bottleneck = ConvModule(
            (len(self.dilations) + 1) * self.channels, self.channels, 3,
            padding=1, **common)

    def _build_aspp_module(self):
        return ASPPModule(self.dilations, self.fused_in_channels,
                          self.channels, conv_cfg=self.conv_cfg,
                          norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)

    def _forward_feature(self, inputs):
        x = self._transform_inputs(inputs)
        pooled = self.image_pool_conv(F.adaptive_avg_pool2d(x, 1))
        outs = [resize(pooled, size=x.shape[2:], mode="bilinear",
                       align_corners=self.align_corners)]
        outs.extend(self.aspp_modules(x))
        return self.bottleneck(torch.cat(outs, dim=1))

    def forward(self, inputs):
        return self.cls_seg(self._forward_feature(inputs))
