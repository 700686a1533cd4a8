"""ISAHead, interlaced sparse self-attention (counterpart of
``models/decode_heads/isa_head.py``; Huang et al., 2019).

After a 3x3 ``in_conv`` the map is padded symmetrically (zeros) to a
whole grid of ``down_factor`` cells, then attends twice through
``SelfAttentionBlock``s (query and key through two ConvModules each, a bare
1x1 value, ``matmul_norm``): ``global_relation`` among the pixels of the
same offset in every cell, then ``local_relation`` within each cell.  The
pad is cropped and a 1x1 ``out_conv`` fuses the result with the
``in_conv`` output.  The regroupings are reshapes and permutes of the
NCHW map, with the batch orders of the JAX package's NHWC ones.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ...core.registry_hub import DECODEHEAD
from ..common.conv_module import ConvModule
from ..utils.self_attention_block import SelfAttentionBlock
from .decode_head import BaseDecodeHead


def _isa_attention(channels, isa_channels, conv_cfg, norm_cfg, act_cfg):
    return SelfAttentionBlock(
        key_in_channels=channels, query_in_channels=channels,
        channels=isa_channels, out_channels=channels, share_key_query=False,
        key_query_num_convs=2, key_query_norm=True, value_out_num_convs=1,
        value_out_norm=False, matmul_norm=True, with_out=False,
        conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg)


@DECODEHEAD.register()
class ISAHead(BaseDecodeHead):

    def __init__(self, isa_channels: int = 256,
                 down_factor: Tuple[int, int] = (8, 8), **kwargs):
        super().__init__(**kwargs)
        self.down_factor = tuple(down_factor)
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        self.in_conv = ConvModule(self.fused_in_channels, self.channels, 3,
                                  padding=1, **common)
        self.global_relation = _isa_attention(self.channels, isa_channels,
                                              **common)
        self.local_relation = _isa_attention(self.channels, isa_channels,
                                             **common)
        self.out_conv = ConvModule(self.channels * 2, self.channels, 1,
                                   **common)

    def forward(self, inputs):
        x = self.in_conv(self._transform_inputs(inputs))
        residual = x
        n, c, h, w = x.shape
        loc_h, loc_w = self.down_factor
        glb_h, glb_w = math.ceil(h / loc_h), math.ceil(w / loc_w)
        pad_h, pad_w = glb_h * loc_h - h, glb_w * loc_w - w
        if pad_h or pad_w:
            x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2,
                          pad_h // 2, pad_h - pad_h // 2))
        # global relation: batch (n, lh, lw) over the (gh, gw) grid
        x = x.reshape(n, c, glb_h, loc_h, glb_w, loc_w)
        x = x.permute(0, 3, 5, 1, 2, 4).reshape(n * loc_h * loc_w, c, glb_h,
                                                glb_w)
        x = self.global_relation(x, x)
        # local relation: batch (n, gh, gw) over each (lh, lw) cell
        x = x.reshape(n, loc_h, loc_w, c, glb_h, glb_w)
        x = x.permute(0, 4, 5, 3, 1, 2).reshape(n * glb_h * glb_w, c, loc_h,
                                                loc_w)
        x = self.local_relation(x, x)
        x = x.reshape(n, glb_h, glb_w, c, loc_h, loc_w)
        x = x.permute(0, 3, 1, 4, 2, 5).reshape(n, c, glb_h * loc_h,
                                                glb_w * loc_w)
        if pad_h or pad_w:
            x = x[:, :, pad_h // 2:pad_h // 2 + h, pad_w // 2:pad_w // 2 + w]
        return self.cls_seg(self.out_conv(torch.cat([x, residual], dim=1)))
