"""DepthwiseSeparableConvModule (counterpart of
``models/utils/depthwise_separable_conv_module.py``).

A depthwise ConvModule (``groups == in_channels``) followed by a pointwise
1x1 ConvModule, held as ``depthwise_conv`` and ``pointwise_conv``, both
with ``norm_cfg`` and ``act_cfg``.  The JAX module's separate
``dw_*``/``pw_*`` norm and activation overrides are used by no caller and
are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

from torch import nn

from ..common.conv_module import ConvModule

_DEFAULT_ACT = object()


class DepthwiseSeparableConvModule(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Sequence[int]],
                 stride: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0,
                 dilation: Union[int, Sequence[int]] = 1,
                 norm_cfg: Optional[Dict] = None, act_cfg: Any = _DEFAULT_ACT):
        super().__init__()
        if act_cfg is _DEFAULT_ACT:
            act_cfg = dict(type="ReLU")
        self.depthwise_conv = ConvModule(
            in_channels, in_channels, kernel_size, stride=stride,
            padding=padding, dilation=dilation, groups=in_channels,
            norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.pointwise_conv = ConvModule(in_channels, out_channels, 1,
                                         norm_cfg=norm_cfg, act_cfg=act_cfg)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))
