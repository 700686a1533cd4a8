"""Panoptic-FPN semantic decode head (counterpart of
``models/decode_heads/fpn_head.py``).

Each pyramid level takes a stack of 3 x 3 ``ConvModule``s, one for each
factor 2 between its stride and the finest, each followed by a bilinear
``Upsample(2)`` (none on the finest level); the levels are summed and
classified at the finest stride.  Submodules ``scale_heads.<i>.<k>``
carry the JAX names ``scale_heads_<i>_<k>`` (the upsamples, at odd ``k``,
have no parameters).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import Upsample
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


@DECODEHEAD.register()
class FPNHead(BaseDecodeHead):

    def __init__(self, feature_strides: Sequence[int], **kwargs):
        super().__init__(**kwargs)
        assert len(feature_strides) == len(self.in_channels)
        assert min(feature_strides) == feature_strides[0]
        heads = []
        for i, stride in enumerate(feature_strides):
            length = max(1, int(np.log2(stride)
                                - np.log2(feature_strides[0])))
            ops = []
            for k in range(length):
                ops.append(ConvModule(
                    self.in_channels[i] if k == 0 else self.channels,
                    self.channels, 3, padding=1, conv_cfg=self.conv_cfg,
                    norm_cfg=self.norm_cfg, act_cfg=self.act_cfg))
                if stride != feature_strides[0]:
                    ops.append(Upsample(scale_factor=2, mode="bilinear",
                                        align_corners=self.align_corners))
            heads.append(nn.ModuleList(ops))
        self.scale_heads = nn.ModuleList(heads)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        out = None
        for feat, ops in zip(x, self.scale_heads):
            for op in ops:
                feat = op(feat)
            out = feat if out is None else out + feat
        return self.cls_seg(out)
