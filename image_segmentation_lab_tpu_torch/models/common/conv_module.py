"""ConvModule — conv + norm + activation (counterpart of
``models/common/conv_module.py``).

``bias='auto'`` gives the conv a bias only when no norm follows.  The norm
layer is stored under its abbreviated name (``bn`` for batch norms), as in
the JAX parameter tree.  ``order`` arranges conv, norm and activation (DPT's
residual units take ``('act', 'conv', 'norm')``); a norm before the conv
normalises the input channels; an activation before the conv is not in
place, as it would overwrite the module's input, which the caller keeps.
The JAX module's ``padding_mode`` and spectral-norm options are used by no
config and are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

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
                 inplace: bool = True,
                 order: Tuple[str, ...] = ("conv", "norm", "act")):
        super().__init__()
        if act_cfg is _DEFAULT_ACT:
            act_cfg = dict(type="ReLU")
        assert isinstance(order, tuple) and sorted(order) == [
            "act", "conv", "norm"], order
        self.order = order
        if order.index("act") < order.index("conv"):
            inplace = False
        self.with_norm = norm_cfg is not None
        if bias == "auto":
            bias = not self.with_norm
        self.conv = build_conv_layer(
            conv_cfg, in_channels, out_channels, kernel_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups, bias=bias)
        self.norm_name = None
        if self.with_norm:
            self.norm_name, norm = build_norm_layer(
                norm_cfg, out_channels if order.index("norm")
                > order.index("conv") else in_channels)
            self.add_module(self.norm_name, norm)
        self.activate = None
        if act_cfg is not None:
            act_cfg = dict(act_cfg)
            if act_cfg["type"] == "ReLU":
                act_cfg.setdefault("inplace", inplace)
            self.activate = build_activation_layer(act_cfg)

    def forward(self, x):
        for layer in self.order:
            if layer == "conv":
                x = self.conv(x)
            elif layer == "norm" and self.norm_name is not None:
                x = getattr(self, self.norm_name)(x)
            elif layer == "act" and self.activate is not None:
                x = self.activate(x)
        return x
