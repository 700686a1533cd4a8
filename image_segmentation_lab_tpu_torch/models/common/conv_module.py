"""ConvModule — conv + norm + activation (counterpart of
``models/common/conv_module.py``).

``bias='auto'`` gives the conv a bias only when no norm follows.  The norm
layer is stored under its abbreviated name (``bn`` for batch norms), as in
the JAX parameter tree.  The JAX module's ``order``, ``padding_mode`` and
spectral-norm options are used by no config of this slice and are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

from torch import nn

from ..builder import build_activation_layer, build_conv_layer, build_norm_layer

_DEFAULT_ACT = object()  # sentinel: "unspecified" (ReLU) vs None (no act)


class ConvModule(nn.Module):

    def __init__(self,
                 in_channels: int,
                 out_channels: int,
                 kernel_size: Union[int, Sequence[int]],
                 stride: Union[int, Sequence[int]] = 1,
                 padding: Union[int, Sequence[int]] = 0,
                 dilation: Union[int, Sequence[int]] = 1,
                 groups: int = 1,
                 bias: Union[bool, str] = "auto",
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Any = _DEFAULT_ACT,
                 inplace: bool = True):
        super().__init__()
        if act_cfg is _DEFAULT_ACT:
            act_cfg = dict(type="ReLU")
        self.with_norm = norm_cfg is not None
        if bias == "auto":
            bias = not self.with_norm
        self.conv = build_conv_layer(
            conv_cfg, in_channels, out_channels, kernel_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups, bias=bias)
        self.norm_name = None
        if self.with_norm:
            self.norm_name, norm = build_norm_layer(norm_cfg, out_channels)
            self.add_module(self.norm_name, norm)
        self.activate = None
        if act_cfg is not None:
            act_cfg = dict(act_cfg)
            if act_cfg["type"] == "ReLU":
                act_cfg.setdefault("inplace", inplace)
            self.activate = build_activation_layer(act_cfg)

    def forward(self, x):
        x = self.conv(x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        if self.activate is not None:
            x = self.activate(x)
        return x
