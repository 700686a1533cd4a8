"""EMAHead, expectation-maximisation attention (counterpart of
``models/decode_heads/ema_head.py``; Li et al., ICCV 2019).

``EMAModule`` holds ``num_bases`` bases of ``C`` channels in the buffer
``bases`` ``(1, C, K)`` (the JAX package's ``batch_stats`` variable, which
the bridge carries both ways), L2-normalised over the channels.  In
float32, outside autocast and without grad, ``num_stages`` EM rounds run:
the E-step's responsibilities are the softmax over the bases of the
pixels' products with them, the M-step's bases the responsibility-weighted
pixel sums (responsibilities L1-normalised over the pixels, floor 1e-12),
L2-normalised over the channels.  The output is the reconstruction
``bases · responsibilitiesᵀ`` in the input's dtype, with no gradient to
the input, as under the JAX package's ``stop_gradient`` (the train step
gives ``ema_mid_conv`` a zero gradient, so the optimizer still decays it).
In training the buffer moves ``momentum`` toward the L2-normalised batch
mean of the final bases.  ``init_weights`` draws the bases kaiming-normal
and normalises them: other bits than the JAX package's ``PRNGKey(0)``.

The head: a 3x3 ``ema_in_conv``, a bare 1x1 ``ema_mid_conv``, ReLU of the
module's output, a 1x1 ``ema_out_conv`` (norm, no activation), ReLU of the
sum with the ``ema_in_conv`` output, a 3x3 ``bottleneck``, the optional
``conv_cat`` over ``[input, output]``, ``cls_seg``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


def _l2_normalize(x, dim, eps=1e-12):
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps)


class EMAModule(nn.Module):

    def __init__(self, channels: int, num_bases: int = 64,
                 num_stages: int = 3, momentum: float = 0.1):
        super().__init__()
        self.num_stages, self.momentum = num_stages, momentum
        self.register_buffer("bases", torch.zeros(1, channels, num_bases))

    def init_weights(self, generator):
        nn.init.kaiming_normal_(self.bases, mode="fan_in",
                                nonlinearity="relu", generator=generator)
        self.bases.copy_(_l2_normalize(self.bases, 1))

    def forward(self, x):
        n, c, h, w = x.shape
        acc = torch.promote_types(x.dtype, torch.float32)
        with torch.no_grad(), torch.autocast(x.device.type, enabled=False):
            feats = x.reshape(n, c, h * w).to(acc)               # (N, C, L)
            bases = self.bases.to(acc).expand(n, -1, -1)         # (N, C, K)
            for _ in range(self.num_stages):
                attention = torch.softmax(
                    torch.bmm(feats.transpose(1, 2), bases), dim=2)
                attn_l1 = attention / attention.sum(
                    dim=1, keepdim=True).clamp_min(1e-12)
                bases = _l2_normalize(torch.bmm(feats, attn_l1), 1)
            recon = torch.bmm(bases, attention.transpose(1, 2))
            if self.training and self.momentum > 0:
                batch_bases = _l2_normalize(bases.mean(0, keepdim=True), 1)
                self.bases.copy_((1 - self.momentum) * self.bases
                                 + self.momentum * batch_bases)
        return recon.reshape(n, c, h, w).to(x.dtype)


@DECODEHEAD.register()
class EMAHead(BaseDecodeHead):

    def __init__(self, ema_channels: int = 512, num_bases: int = 64,
                 num_stages: int = 3, momentum: float = 0.1,
                 concat_input: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.concat_input = concat_input
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg)
        self.ema_in_conv = ConvModule(self.fused_in_channels, ema_channels,
                                      3, padding=1, act_cfg=self.act_cfg,
                                      **common)
        self.ema_mid_conv = ConvModule(ema_channels, ema_channels, 1,
                                       conv_cfg=self.conv_cfg, norm_cfg=None,
                                       act_cfg=None)
        self.ema_module = EMAModule(ema_channels, num_bases, num_stages,
                                    momentum)
        self.ema_out_conv = ConvModule(ema_channels, ema_channels, 1,
                                       act_cfg=None, **common)
        self.bottleneck = ConvModule(ema_channels, self.channels, 3,
                                     padding=1, act_cfg=self.act_cfg,
                                     **common)
        if concat_input:
            self.conv_cat = ConvModule(
                self.fused_in_channels + self.channels, self.channels, 3,
                padding=1, act_cfg=self.act_cfg, **common)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        identity = self.ema_in_conv(x)
        recon = F.relu(self.ema_module(self.ema_mid_conv(identity)))
        output = F.relu(identity + self.ema_out_conv(recon))
        output = self.bottleneck(output)
        if self.concat_input:
            output = self.conv_cat(torch.cat([x, output], dim=1))
        return self.cls_seg(output)
