"""DepthwiseSeparableASPPHead, DeepLabV3+'s decoder (counterpart of
``models/decode_heads/sep_aspp_head.py``).

``ASPPHead`` whose dilated 3x3 branches are ``DepthwiseSeparableConvModule``s
(``DepthwiseSeparableASPPModule``, through ``_build_aspp_module``), a 1x1
``c1_bottleneck`` on the low-level ``inputs[0]``, the ASPP output resized
to its size and concatenated after it, then two separable 3x3 convs
(``sep_bottleneck.<i>``, JAX ``sep_bottleneck_<i>``) before ``cls_seg``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..common.conv_module import ConvModule
from ..utils.depthwise_separable_conv_module import \
    DepthwiseSeparableConvModule
from .aspp_head import ASPPHead, ASPPModule


class DepthwiseSeparableASPPModule(ASPPModule):
    """ASPP with separable 3x3 atrous branches (a 1x1 ConvModule for
    dilation 1)."""

    def __init__(self, dilations, in_channels: int, channels: int,
                 conv_cfg=None, norm_cfg=None, act_cfg=None):
        super().__init__(
            dilations, in_channels, channels, conv_cfg=conv_cfg,
            norm_cfg=norm_cfg, act_cfg=act_cfg,
            dilated_conv=lambda d: DepthwiseSeparableConvModule(
                in_channels, channels, 3, dilation=d, padding=d,
                norm_cfg=norm_cfg, act_cfg=act_cfg))


@DECODEHEAD.register()
class DepthwiseSeparableASPPHead(ASPPHead):

    def __init__(self, c1_in_channels: int = 0, c1_channels: int = 0,
                 **kwargs):
        super().__init__(**kwargs)
        assert c1_in_channels >= 0
        common = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.c1_bottleneck = None
        if c1_in_channels > 0:
            self.c1_bottleneck = ConvModule(c1_in_channels, c1_channels, 1,
                                            conv_cfg=self.conv_cfg, **common)
        fuse_in = self.channels + (c1_channels if c1_in_channels > 0 else 0)
        self.sep_bottleneck = nn.ModuleList([
            DepthwiseSeparableConvModule(fuse_in, self.channels, 3,
                                         padding=1, **common),
            DepthwiseSeparableConvModule(self.channels, self.channels, 3,
                                         padding=1, **common)])

    def _build_aspp_module(self):
        return DepthwiseSeparableASPPModule(
            self.dilations, self.fused_in_channels, self.channels,
            conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
            act_cfg=self.act_cfg)

    def _forward_feature(self, inputs):
        output = super()._forward_feature(inputs)
        if self.c1_bottleneck is not None:
            c1_output = self.c1_bottleneck(inputs[0])
            output = resize(output, size=c1_output.shape[2:],
                            mode="bilinear", align_corners=self.align_corners)
            output = torch.cat([output, c1_output], dim=1)
        for conv in self.sep_bottleneck:
            output = conv(output)
        return output
