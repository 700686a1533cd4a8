"""DNLHead and its DisentangledNonLocal2d block (counterpart of
``models/decode_heads/dnl_head.py``; Yin et al., ECCV 2020).

The block whitens ``theta`` and ``phi`` (subtracts their spatial means),
forms float32 pairwise scores (``ops/attention.float32_product``), divides
them by ``sqrt(ci)`` (``use_scale``) and by ``temperature`` before the
softmax (``embedded_gaussian``), and adds a unary term: a 1x1
``conv_mask`` softmaxed in float32 over the positions pools ``g`` to one
vector added at every position.  ``conv_out`` maps back (as in
``NonLocal2d``) and the block is residual.  The head is NLHead's with this
block as ``dnl_block``.  The JAX block's ``dot_product`` mode, which no
config selects, is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ...core.registry_hub import DECODEHEAD
from ...ops.attention import float32_product
from ..basic.convolution import Conv2d
from ..utils.non_local import NonLocal2d
from .decode_head import BaseDecodeHead
from .nl_head import context_convs, context_forward


class DisentangledNonLocal2d(NonLocal2d):

    def __init__(self, in_channels: int, reduction: int = 2,
                 use_scale: bool = True, mode: str = "embedded_gaussian",
                 temperature: float = 0.05, conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None, zeros_init: bool = True):
        if mode != "embedded_gaussian":
            raise NotImplementedError(
                f"DisentangledNonLocal2d mode {mode!r} is not ported yet "
                "(ROADMAP.md Queue 1 item 8)")
        super().__init__(in_channels, reduction=reduction,
                         use_scale=use_scale, mode=mode, conv_cfg=conv_cfg,
                         norm_cfg=norm_cfg, zeros_init=zeros_init)
        self.temperature = temperature
        self.conv_mask = Conv2d(in_channels, 1, 1)

    def forward(self, x):
        n, _, h, w = x.shape
        ci = self.inter_channels
        g = self.g(x).flatten(2).transpose(1, 2)                 # (N, L, ci)
        theta = self.theta(x).flatten(2)                          # (N, ci, L)
        phi = self.phi(x).flatten(2)
        theta = theta - theta.mean(dim=2, keepdim=True)
        phi = phi - phi.mean(dim=2, keepdim=True)
        pairwise = float32_product(theta.transpose(1, 2), phi)
        if self.use_scale:
            pairwise = pairwise / math.sqrt(ci)
        pairwise = torch.softmax(pairwise / self.temperature, dim=-1)
        y = torch.matmul(pairwise.to(g.dtype), g)                # (N, L, ci)
        acc = torch.promote_types(x.dtype, torch.float32)
        unary = torch.softmax(self.conv_mask(x).flatten(2).to(acc), dim=2)
        unary_x = torch.matmul(unary.to(g.dtype), g)             # (N, 1, ci)
        y = (y + unary_x).transpose(1, 2).reshape(n, ci, h, w)
        return x + self.conv_out(y)


@DECODEHEAD.register()
class DNLHead(BaseDecodeHead):

    def __init__(self, reduction: int = 2, use_scale: bool = True,
                 mode: str = "embedded_gaussian", temperature: float = 0.05,
                 concat_input: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.concat_input = concat_input
        context_convs(self)
        self.dnl_block = DisentangledNonLocal2d(
            self.channels, reduction=reduction, use_scale=use_scale,
            mode=mode, temperature=temperature, conv_cfg=self.conv_cfg,
            norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        return context_forward(self, inputs, self.dnl_block)
