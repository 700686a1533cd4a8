"""GCHead and its ContextBlock (counterpart of
``models/decode_heads/gc_head.py``; Cao et al., ICCVW 2019).

A 1x1 ``conv_mask`` softmaxed in float32 over the positions pools the map
(cast back to its dtype) to one context vector (``pooling_type='att'``); a
bottleneck ``channel_add_fc1`` (1x1 to ``C * ratio``), ``channel_add_ln``
(LayerNorm over the channels), ReLU and ``channel_add_fc2`` transforms it,
and it is added at every position.  The head is NLHead's with the block as
``gc_block``.  The JAX block's ``'avg'`` pooling, which no config selects,
is not ported yet and raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ..basic.convolution import Conv2d
from ..basic.normalization import LayerNorm2d
from .decode_head import BaseDecodeHead
from .nl_head import context_convs, context_forward


class ContextBlock(nn.Module):

    def __init__(self, in_channels: int, ratio: float = 0.25,
                 pooling_type: str = "att"):
        super().__init__()
        if pooling_type != "att":
            raise NotImplementedError(
                f"ContextBlock pooling_type {pooling_type!r} is not ported "
                "yet (ROADMAP.md Queue 1 item 8)")
        planes = int(in_channels * ratio)
        self.conv_mask = Conv2d(in_channels, 1, 1)
        self.channel_add_fc1 = Conv2d(in_channels, planes, 1)
        self.channel_add_ln = LayerNorm2d(planes)
        self.channel_add_fc2 = Conv2d(planes, in_channels, 1)

    def forward(self, x):
        n, c = x.shape[:2]
        acc = torch.promote_types(x.dtype, torch.float32)
        mask = torch.softmax(self.conv_mask(x).flatten(2).to(acc), dim=2)
        context = torch.matmul(x.flatten(2), mask.to(x.dtype).transpose(
            1, 2)).reshape(n, c, 1, 1)
        y = F.relu(self.channel_add_ln(self.channel_add_fc1(context)))
        return x + self.channel_add_fc2(y)


@DECODEHEAD.register()
class GCHead(BaseDecodeHead):

    def __init__(self, ratio: float = 0.25, pooling_type: str = "att",
                 concat_input: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.concat_input = concat_input
        context_convs(self)
        self.gc_block = ContextBlock(self.channels, ratio=ratio,
                                     pooling_type=pooling_type)

    def forward(self, inputs):
        return context_forward(self, inputs, self.gc_block)
