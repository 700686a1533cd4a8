"""SETR multi-level-aggregation decode head (counterpart of
``models/decode_heads/setr_mla_head.py``).

Each of the MLA neck's levels takes two 3 x 3 ``ConvModule``s to
``mla_channels`` and a bilinear ``Upsample`` by ``up_scale``; the levels
are concatenated and classified (``channels`` must be ``len(in_channels)
* mla_channels``).  Submodules ``up_convs.<i>.<j>`` carry the JAX names
``up_convs_<i>_<j>`` (``j`` 2 is the upsample, with no parameters).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import Upsample
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


@DECODEHEAD.register()
class SETRMLAHead(BaseDecodeHead):

    def __init__(self, mla_channels: int = 128, up_scale: int = 4,
                 **kwargs):
        super().__init__(**kwargs)
        assert self.input_transform == "multiple_select"
        num_inputs = len(self.in_channels)
        assert self.channels == num_inputs * mla_channels, (
            "SETRMLAHead needs channels == len(in_channels) * mla_channels "
            f"(got {self.channels} != {num_inputs} * {mla_channels})")
        kw = dict(padding=1, norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.up_convs = nn.ModuleList(nn.ModuleList([
            ConvModule(self.in_channels[i], mla_channels, 3, **kw),
            ConvModule(mla_channels, mla_channels, 3, **kw),
            Upsample(scale_factor=up_scale, mode="bilinear",
                     align_corners=self.align_corners)])
            for i in range(num_inputs))

    def forward(self, inputs):
        feats = self._transform_inputs(inputs)
        outs = [up(c2(c1(x))) for x, (c1, c2, up) in zip(feats,
                                                          self.up_convs)]
        return self.cls_seg(torch.cat(outs, dim=1))
