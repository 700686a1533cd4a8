"""CCHead and its CrissCrossAttention (counterpart of
``models/decode_heads/cc_head.py``; Huang et al., ICCV 2019).

Each pixel attends over its column and its row.  ``query`` and ``key`` are
bias-free 1x1 convs to ``C // 8`` channels, ``value`` to ``C``.  The column
scores ``(N, H, W, H')`` and the row scores ``(N, H, W, W')`` are float32
products (``ops/attention.float32_product``); a pixel's own entry in its
column is set to -1e30 (it counts once, in its row); one softmax runs over
the concatenated ``H' + W'`` axis, and the two halves, cast to the value's
dtype, weight the column's and the row's values, summed.  The output is
``gamma * out + x`` with a scalar ``gamma`` that starts at 0.  The head is
NLHead's with ``recurrence`` passes of the one ``cca`` module.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...ops.attention import float32_product
from ..basic.convolution import Conv2d
from .decode_head import BaseDecodeHead
from .nl_head import context_convs, context_forward

_NEG_INF = -1e30


class CrissCrossAttention(nn.Module):

    def __init__(self, in_channels: int):
        super().__init__()
        cq = max(in_channels // 8, 1)
        self.query = Conv2d(in_channels, cq, 1, bias=False)
        self.key = Conv2d(in_channels, cq, 1, bias=False)
        self.value = Conv2d(in_channels, in_channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h = x.shape[2]
        q, k, v = self.query(x), self.key(x), self.value(x)
        # column scores (N, W, H, H'), then as (N, H, W, H')
        e_h = float32_product(q.permute(0, 3, 2, 1), k.permute(0, 3, 1, 2))
        eye = torch.eye(h, dtype=torch.bool, device=x.device)
        e_h = e_h.masked_fill(eye, _NEG_INF).transpose(1, 2)
        # row scores (N, H, W, W')
        e_w = float32_product(q.permute(0, 2, 3, 1), k.permute(0, 2, 1, 3))
        attn = torch.softmax(torch.cat([e_h, e_w], dim=-1), dim=-1)
        a_h, a_w = attn[..., :h].to(v.dtype), attn[..., h:].to(v.dtype)
        out_h = torch.matmul(a_h.transpose(1, 2), v.permute(0, 3, 2, 1))
        out_w = torch.matmul(a_w, v.permute(0, 2, 3, 1))
        out = out_h.permute(0, 3, 2, 1) + out_w.permute(0, 3, 1, 2)
        return self.gamma.to(x.dtype) * out + x


@DECODEHEAD.register()
class CCHead(BaseDecodeHead):

    def __init__(self, recurrence: int = 2, concat_input: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.recurrence = recurrence
        self.concat_input = concat_input
        context_convs(self)
        self.cca = CrissCrossAttention(self.channels)

    def _recurrent(self, x):
        for _ in range(self.recurrence):  # weight-shared
            x = self.cca(x)
        return x

    def forward(self, inputs):
        return context_forward(self, inputs, self._recurrent)
