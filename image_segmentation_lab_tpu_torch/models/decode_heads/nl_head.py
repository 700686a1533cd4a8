"""NLHead (counterpart of ``models/decode_heads/nl_head.py``).

An FCN-style head whose middle is a ``NonLocal2d`` block: a 3x3
ConvModule, ``nl_block``, a second 3x3 ConvModule (``convs.<i>``, JAX
``convs_<i>``), the optional ``conv_cat`` over ``[input, output]``, and
``cls_seg``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ..common.conv_module import ConvModule
from ..utils.non_local import NonLocal2d
from .decode_head import BaseDecodeHead


def context_convs(head):
    """The two 3x3 ConvModules around a context block, and ``conv_cat``
    when the head concatenates its input (NL, DNL, GC and CC heads)."""
    common = dict(conv_cfg=head.conv_cfg, norm_cfg=head.norm_cfg,
                  act_cfg=head.act_cfg)
    head.convs = nn.ModuleList([
        ConvModule(head.fused_in_channels, head.channels, 3, padding=1,
                   **common),
        ConvModule(head.channels, head.channels, 3, padding=1, **common)])
    if head.concat_input:
        head.conv_cat = ConvModule(head.fused_in_channels + head.channels,
                                   head.channels, 3, padding=1, **common)


def context_forward(head, inputs, block):
    """conv, ``block``, conv, the optional ``conv_cat``, classifier."""
    x = head._transform_inputs(inputs)
    out = head.convs[1](block(head.convs[0](x)))
    if head.concat_input:
        out = head.conv_cat(torch.cat([x, out], dim=1))
    return head.cls_seg(out)


@DECODEHEAD.register()
class NLHead(BaseDecodeHead):

    def __init__(self, reduction: int = 2, use_scale: bool = True,
                 mode: str = "embedded_gaussian", concat_input: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.concat_input = concat_input
        context_convs(self)
        self.nl_block = NonLocal2d(self.channels, reduction=reduction,
                                   use_scale=use_scale, mode=mode,
                                   conv_cfg=self.conv_cfg,
                                   norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        return context_forward(self, inputs, self.nl_block)
