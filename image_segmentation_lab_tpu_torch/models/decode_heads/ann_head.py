"""ANNHead, the asymmetric non-local head (counterpart of
``models/decode_heads/ann_head.py``; Zhu et al., ICCV 2019).

Keys and values are pyramid-pooled (``PPMConcat``: ``ops/pooling.
adaptive_avg_pool2d`` to each of ``key_pool_scales``, flattened and
concatenated to ``(N, C, S)``, 110 samples at (1, 3, 6, 8)); queries stay
dense (a max-pool of ``scale`` for a query scale above 1).  ``AFNB``: the
high-level map queries the pooled low-level map, and a 1x1 ``bottleneck``
without activation fuses the context with the high-level map.  ``APNB``:
the same self-attention on one map with shared query and key projections,
fused by a 1x1 ``bottleneck`` with activation.  Both ride
``SelfAttentionBlock`` (``stages.<i>``).  The head: ``fusion`` (AFNB) on
``[low, high]``, dropout, a 3x3 ``bottleneck``, ``context`` (APNB),
``cls_seg``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...ops.pooling import adaptive_avg_pool2d, max_pool2d
from ..common.conv_module import ConvModule
from ..utils.self_attention_block import SelfAttentionBlock
from .decode_head import BaseDecodeHead


class PPMConcat(nn.Module):
    """Each scale's adaptive average pool, flattened: ``(N, C, sum(s²))``."""

    def __init__(self, pool_scales: Sequence[int] = (1, 3, 6, 8)):
        super().__init__()
        self.pool_scales = tuple(pool_scales)

    def forward(self, x):
        return torch.cat([adaptive_avg_pool2d(x, s).flatten(2)
                          for s in self.pool_scales], dim=2)


def _query_pool(scale: int):
    if scale == 1:
        return None
    return lambda x: max_pool2d(x, scale, scale)


def _stages(key_in, query_in, channels, out_channels, share_key_query,
            query_scales, key_pool_scales, conv_cfg, norm_cfg, act_cfg):
    return nn.ModuleList(
        SelfAttentionBlock(
            key_in_channels=key_in, query_in_channels=query_in,
            channels=channels, out_channels=out_channels,
            share_key_query=share_key_query, query_downsample=_query_pool(s),
            key_downsample=PPMConcat(key_pool_scales), key_query_num_convs=1,
            key_query_norm=False, value_out_num_convs=1, value_out_norm=False,
            matmul_norm=True, with_out=True, conv_cfg=conv_cfg,
            norm_cfg=norm_cfg, act_cfg=act_cfg)
        for s in query_scales)


class AFNB(nn.Module):
    """Asymmetric fusion non-local block."""

    def __init__(self, low_in_channels: int, high_in_channels: int,
                 channels: int, out_channels: int,
                 query_scales: Sequence[int] = (1,),
                 key_pool_scales: Sequence[int] = (1, 3, 6, 8),
                 conv_cfg=None, norm_cfg=None, act_cfg=None):
        super().__init__()
        self.stages = _stages(low_in_channels, high_in_channels, channels,
                              out_channels, False, query_scales,
                              key_pool_scales, conv_cfg, norm_cfg, act_cfg)
        self.bottleneck = ConvModule(
            out_channels + high_in_channels, out_channels, 1,
            conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=None)

    def forward(self, low_feats, high_feats):
        context = sum(stage(high_feats, low_feats) for stage in self.stages)
        return self.bottleneck(torch.cat([context, high_feats], dim=1))


class APNB(nn.Module):
    """Asymmetric pyramid non-local block (self-attention)."""

    def __init__(self, in_channels: int, channels: int, out_channels: int,
                 query_scales: Sequence[int] = (1,),
                 key_pool_scales: Sequence[int] = (1, 3, 6, 8),
                 conv_cfg=None, norm_cfg=None, act_cfg=None):
        super().__init__()
        self.stages = _stages(in_channels, in_channels, channels,
                              in_channels, True, query_scales,
                              key_pool_scales, conv_cfg, norm_cfg, act_cfg)
        self.bottleneck = ConvModule(
            2 * in_channels, out_channels, 1, conv_cfg=conv_cfg,
            norm_cfg=norm_cfg, act_cfg=act_cfg)

    def forward(self, feats):
        context = sum(stage(feats, feats) for stage in self.stages)
        return self.bottleneck(torch.cat([context, feats], dim=1))


@DECODEHEAD.register()
class ANNHead(BaseDecodeHead):

    def __init__(self, project_channels: int = 256,
                 query_scales: Sequence[int] = (1,),
                 key_pool_scales: Sequence[int] = (1, 3, 6, 8), **kwargs):
        super().__init__(**kwargs)
        assert len(self.in_channels) == 2, "ANNHead takes [low, high] feats"
        low_in, high_in = self.in_channels
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        self.fusion = AFNB(low_in, high_in, project_channels, high_in,
                           query_scales, key_pool_scales, **common)
        self.bottleneck = ConvModule(high_in, self.channels, 3, padding=1,
                                     **common)
        self.context = APNB(self.channels, project_channels, self.channels,
                            query_scales, key_pool_scales, **common)

    def forward(self, inputs):
        low_feats, high_feats = self._transform_inputs(inputs)
        output = self.fusion(low_feats, high_feats)
        if self.dropout is not None:
            output = self.dropout(output)
        output = self.context(self.bottleneck(output))
        return self.cls_seg(output)
