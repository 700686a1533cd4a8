"""UPerHead, Unified Perceptual Parsing (counterpart of
``models/decode_heads/uper_head.py``).

* a PSP branch on the coarsest input: ``psp_modules`` (PPM) and the 3x3
  ``psp_bottleneck``;
* an FPN over the finer inputs: 1x1 ``lateral_convs``, the top-down
  ``laterals[i-1] += resize(laterals[i])``, 3x3 ``fpn_convs``; the PSP
  level joins unsmoothed;
* every level resized to the finest, concatenated, the 3x3
  ``fpn_bottleneck``, then ``cls_seg``.

Bilinear resizes go through ``utils/ops.resize`` (under grad, the resize
backward kernel).  ``input_transform`` must be ``'multiple_select'``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead
from .psp_head import PPM


@DECODEHEAD.register()
class UPerHead(BaseDecodeHead):

    def __init__(self, pool_scales: Sequence[int] = (1, 2, 3, 6), **kwargs):
        super().__init__(**kwargs)
        assert self.input_transform == "multiple_select", (
            "UPerHead fuses multiple scales; set "
            "input_transform='multiple_select'")
        assert len(self.in_channels) >= 2
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        self.psp_modules = PPM(pool_scales, self.in_channels[-1],
                               self.channels,
                               align_corners=self.align_corners, **common)
        self.psp_bottleneck = ConvModule(
            self.in_channels[-1] + len(pool_scales) * self.channels,
            self.channels, 3, padding=1, **common)
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_ch, self.channels, 1, **common)
            for in_ch in self.in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(self.channels, self.channels, 3, padding=1, **common)
            for _ in self.in_channels[:-1])
        self.fpn_bottleneck = ConvModule(
            len(self.in_channels) * self.channels, self.channels, 3,
            padding=1, **common)

    def _resize(self, x, like):
        return resize(x, size=like.shape[2:], mode="bilinear",
                      align_corners=self.align_corners)

    def _forward_feature(self, inputs):
        inputs = self._transform_inputs(inputs)
        x = inputs[-1]
        laterals = [conv(inputs[i])
                    for i, conv in enumerate(self.lateral_convs)]
        laterals.append(self.psp_bottleneck(
            torch.cat([x, *self.psp_modules(x)], dim=1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + self._resize(laterals[i],
                                                             laterals[i - 1])
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])  # the PSP level is already smoothed
        outs = [outs[0]] + [self._resize(out, outs[0]) for out in outs[1:]]
        return self.fpn_bottleneck(torch.cat(outs, dim=1))

    def forward(self, inputs):
        return self.cls_seg(self._forward_feature(inputs))
