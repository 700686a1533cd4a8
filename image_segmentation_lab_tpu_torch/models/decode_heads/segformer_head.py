"""SegFormerHead, the all-MLP decoder (counterpart of
``models/decode_heads/segformer_head.py``).

Each selected scale goes through a 1x1 ConvModule (``scale_convs.<i>``,
JAX ``scale_convs_<i>``) to ``channels``, is resized bilinearly to the
first (1/4) scale through ``utils/ops.resize`` (under grad, the resize
backward kernel), and the concatenation goes through the 1x1
``fusion_conv`` and ``cls_seg``.  ``input_transform`` must be
``'multiple_select'``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


@DECODEHEAD.register()
class SegFormerHead(BaseDecodeHead):

    def __init__(self, interpolate_mode: str = "bilinear", **kwargs):
        super().__init__(**kwargs)
        assert self.input_transform == "multiple_select", (
            "SegFormerHead fuses multiple scales; set "
            "input_transform='multiple_select'")
        self.interpolate_mode = interpolate_mode
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        self.scale_convs = nn.ModuleList(
            ConvModule(in_ch, self.channels, 1, **common)
            for in_ch in self.in_channels)
        self.fusion_conv = ConvModule(
            self.channels * len(self.in_channels), self.channels, 1,
            **common)

    def forward(self, inputs):
        xs = self._transform_inputs(inputs)
        size = xs[0].shape[2:]
        fused = [resize(conv(x), size=size, mode=self.interpolate_mode,
                        align_corners=self.align_corners)
                 for conv, x in zip(self.scale_convs, xs)]
        return self.cls_seg(self.fusion_conv(torch.cat(fused, dim=1)))
