"""SelfAttentionBlock (counterpart of
``models/utils/self_attention_block.py``), the query/key/value attention
behind ANN's AFNB/APNB and ISANet.

Query, key and value projections are stacks of 1x1 convs
(``query_project.<i>``, JAX ``query_project_<i>``), ConvModules when
``key_query_norm``/``value_out_norm``; ``share_key_query`` runs the query
stack on the keys (no ``key_project`` of its own, as in the JAX tree).
``query_downsample``/``key_downsample`` are callables on NCHW maps (a
max-pool, ANN's ``PPMConcat``, which returns ``(N, C, S)``).  The
similarity is float32 (``ops/attention.float32_product``), scaled by
``channels ** -0.5`` with ``matmul_norm``, softmaxed over the keys and cast
to the value's dtype for the context product; ``out_project`` (with
``with_out``) maps the context.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ...ops.attention import float32_product
from ..basic.convolution import Conv2d
from ..common.conv_module import ConvModule


class SelfAttentionBlock(nn.Module):

    def __init__(self, key_in_channels: int, query_in_channels: int,
                 channels: int, out_channels: int,
                 share_key_query: bool = False,
                 query_downsample: Optional[Callable] = None,
                 key_downsample: Optional[Callable] = None,
                 key_query_num_convs: int = 1, value_out_num_convs: int = 1,
                 key_query_norm: bool = False, value_out_norm: bool = False,
                 matmul_norm: bool = False, with_out: bool = False,
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None, act_cfg: Any = None):
        super().__init__()
        self.channels = channels
        self.share_key_query = share_key_query
        self.query_downsample = query_downsample
        self.key_downsample = key_downsample
        self.matmul_norm = matmul_norm

        def project(in_ch, out_ch, num_convs, use_norm):
            return nn.ModuleList(
                ConvModule(in_ch if i == 0 else out_ch, out_ch, 1,
                           conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                           act_cfg=act_cfg) if use_norm else
                Conv2d(in_ch if i == 0 else out_ch, out_ch, 1)
                for i in range(num_convs))

        self.query_project = project(query_in_channels, channels,
                                     key_query_num_convs, key_query_norm)
        if share_key_query:
            assert key_in_channels == query_in_channels
        else:
            self.key_project = project(key_in_channels, channels,
                                       key_query_num_convs, key_query_norm)
        self.value_project = project(
            key_in_channels, channels if with_out else out_channels,
            value_out_num_convs, value_out_norm)
        self.out_project = (project(channels, out_channels,
                                    value_out_num_convs, value_out_norm)
                            if with_out else None)

    @staticmethod
    def _run(convs, x):
        for conv in convs:
            x = conv(x)
        return x

    def forward(self, query_feats, key_feats):
        n = query_feats.shape[0]
        query = self._run(self.query_project, query_feats)
        if self.query_downsample is not None:
            query = self.query_downsample(query)
        qh, qw = query.shape[2:]
        query = query.flatten(2).transpose(1, 2)                  # (N, L, C)
        key = self._run(self.query_project if self.share_key_query
                        else self.key_project, key_feats)
        value = self._run(self.value_project, key_feats)
        if self.key_downsample is not None:
            key = self.key_downsample(key)
            value = self.key_downsample(value)
        key = key.flatten(2)                                      # (N, C, S)
        value = value.flatten(2).transpose(1, 2)                  # (N, S, Cv)
        sim = float32_product(query, key)
        if self.matmul_norm:
            sim = (self.channels ** -0.5) * sim
        sim = torch.softmax(sim, dim=-1)
        context = torch.matmul(sim.to(value.dtype), value)
        context = context.transpose(1, 2).reshape(n, -1, qh, qw)
        if self.out_project is not None:
            context = self._run(self.out_project, context)
        return context
