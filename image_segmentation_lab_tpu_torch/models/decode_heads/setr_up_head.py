"""SETR progressive-upsampling decode head (counterpart of
``models/decode_heads/setr_up_head.py``).

"Naive" is ``num_convs=1, up_scale=4`` (one conv + 4x bilinear), "PUP" is
``num_convs=4, up_scale=2``.  An input LayerNorm over the channels
(``in_norm``) normalises the transformer output before the conv stack;
in NCHW it runs on a channels-last view, and the conv stack on contiguous
NCHW.  Submodules ``in_norm`` and
``up_convs.<i>`` (JAX ``up_convs_<i>``) carry the JAX names.
"""

from __future__ import annotations

from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import Upsample
from ..basic.normalization import LayerNorm
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


@DECODEHEAD.register()
class SETRUPHead(BaseDecodeHead):

    def __init__(self, num_convs: int = 1, up_scale: int = 4,
                 kernel_size: int = 3, **kwargs):
        super().__init__(**kwargs)
        assert kernel_size in (1, 3), "kernel_size must be 1 or 3"
        assert num_convs >= 1
        self.in_norm = LayerNorm(self.fused_in_channels)
        self.up_convs = nn.ModuleList(
            ConvModule(self.fused_in_channels if i == 0 else self.channels,
                       self.channels, kernel_size,
                       padding=kernel_size // 2, conv_cfg=self.conv_cfg,
                       norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
            for i in range(num_convs))
        self.upsamples = nn.ModuleList(
            Upsample(scale_factor=up_scale, mode="bilinear",
                     align_corners=self.align_corners)
            for _ in range(num_convs))

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        # contiguous NCHW again: a channels-last tensor here would make
        # cuDNN transpose around every conv of the head
        x = self.in_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = x.contiguous()
        for conv, up in zip(self.up_convs[:-1], self.upsamples[:-1]):
            x = up(conv(x))
        x = self.up_convs[-1](x)
        if not self.training or self.dropout is None:
            # the 1x1 classifier and the bilinear upsample commute (linear,
            # and every bilinear row sums to 1, so the bias commutes too),
            # so upsampling num_classes channels instead of ``channels``
            # gives the same logits up to rounding order; as in the JAX
            # head, only Dropout2d in training keeps the original order
            return self.upsamples[-1](self.cls_seg(x))
        return self.cls_seg(self.upsamples[-1](x))
