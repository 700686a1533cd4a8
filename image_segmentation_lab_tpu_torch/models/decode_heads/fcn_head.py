"""FCNHead (counterpart of ``models/decode_heads/fcn_head.py``).

``num_convs`` stacked ConvModules with dilation-aware padding (``convs``,
JAX path ``convs_<i>``), an optional ``conv_cat`` over ``[input, output]``,
and the identity when ``num_convs == 0``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


@DECODEHEAD.register()
class FCNHead(BaseDecodeHead):

    def __init__(self, num_convs: int = 2, kernel_size: int = 3,
                 concat_input: bool = True, dilation: int = 1, **kwargs):
        super().__init__(**kwargs)
        assert num_convs >= 0 and dilation > 0
        if num_convs == 0:
            assert self.fused_in_channels == self.channels
        self.concat_input = concat_input
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        self.convs = nn.ModuleList(
            ConvModule(self.fused_in_channels if i == 0 else self.channels,
                       self.channels, kernel_size,
                       padding=(kernel_size // 2) * dilation,
                       dilation=dilation, **common)
            for i in range(num_convs))
        if concat_input:
            self.conv_cat = ConvModule(
                self.fused_in_channels + self.channels, self.channels,
                kernel_size, padding=kernel_size // 2, **common)

    def _forward_feature(self, inputs):
        x = self._transform_inputs(inputs)
        feats = x
        for conv in self.convs:
            feats = conv(feats)
        if self.concat_input:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return feats

    def forward(self, inputs):
        return self.cls_seg(self._forward_feature(inputs))
