"""DAHead, DANet's dual attention (counterpart of
``models/decode_heads/da_head.py``; Fu et al., CVPR 2019).

``PAM`` (position attention): bias-free 1x1 ``query``/``key`` to
``pam_channels`` and ``value`` to ``C``, float32 scores over the ``L = H W``
positions (``ops/attention.float32_product``), softmax, the weights cast
to the value's dtype.  ``CAM`` (channel attention): the float32 ``C x C``
energy of the map with itself, ``softmax(max - energy)`` over the
channels, applied to the map.  Both end ``gamma * out + x`` with a scalar
``gamma`` that starts at 0.

The head runs ``pam_in_conv -> pam -> pam_out_conv`` and ``cam_in_conv ->
cam -> cam_out_conv`` and returns three logits: ``cls_seg`` of their sum
(``pam_cam``), and the dropout plus ``pam_conv_seg``/``cam_conv_seg`` of
each (normal(0, 0.01), zero bias).  ``forward_test`` keeps ``pam_cam``;
``forward_train`` adds the losses of the other two under the ``pam.`` and
``cam.`` prefixes.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...ops.attention import float32_product
from ..basic.convolution import Conv2d
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


class PAM(nn.Module):

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.query = Conv2d(in_channels, channels, 1, bias=False)
        self.key = Conv2d(in_channels, channels, 1, bias=False)
        self.value = Conv2d(in_channels, in_channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        q = self.query(x).flatten(2).transpose(1, 2)             # (N, L, d)
        k = self.key(x).flatten(2)                               # (N, d, L)
        v = self.value(x).flatten(2).transpose(1, 2)             # (N, L, C)
        attn = torch.softmax(float32_product(q, k), dim=-1)
        out = torch.matmul(attn.to(v.dtype), v).transpose(1, 2)
        return self.gamma.to(x.dtype) * out.reshape(x.shape) + x


class CAM(nn.Module):

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        flat = x.flatten(2)                                      # (N, C, L)
        energy = float32_product(flat, flat.transpose(1, 2))
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1)
        out = torch.matmul(attn.to(flat.dtype), flat)
        return self.gamma.to(x.dtype) * out.reshape(x.shape) + x


@DECODEHEAD.register()
class DAHead(BaseDecodeHead):

    def __init__(self, pam_channels: int = None, **kwargs):
        assert pam_channels is not None, "pam_channels is required"
        super().__init__(**kwargs)
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        ch = self.channels
        self.pam_in_conv = ConvModule(self.fused_in_channels, ch, 3,
                                      padding=1, **common)
        self.pam = PAM(ch, pam_channels)
        self.pam_out_conv = ConvModule(ch, ch, 3, padding=1, **common)
        self.pam_conv_seg = Conv2d(ch, self.resolved_out_channels(), 1)
        self.cam_in_conv = ConvModule(self.fused_in_channels, ch, 3,
                                      padding=1, **common)
        self.cam = CAM()
        self.cam_out_conv = ConvModule(ch, ch, 3, padding=1, **common)
        self.cam_conv_seg = Conv2d(ch, self.resolved_out_channels(), 1)

    def init_weights(self, generator):
        super().init_weights(generator)
        for conv in (self.pam_conv_seg, self.cam_conv_seg):
            nn.init.normal_(conv.weight, 0.0, 0.01, generator=generator)
            nn.init.zeros_(conv.bias)

    def _aux_cls_seg(self, feat, conv):
        if self.dropout is not None:
            feat = self.dropout(feat)
        return conv(feat)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        pam_feat = self.pam_out_conv(self.pam(self.pam_in_conv(x)))
        cam_feat = self.cam_out_conv(self.cam(self.cam_in_conv(x)))
        return (self.cls_seg(pam_feat + cam_feat),
                self._aux_cls_seg(pam_feat, self.pam_conv_seg),
                self._aux_cls_seg(cam_feat, self.cam_conv_seg))

    def forward_test(self, inputs):
        return self(inputs)[0]

    def forward_train(self, inputs, gt_semantic_seg, meta_infos=None,
                      rescale: bool = False):
        pam_cam, pam_out, cam_out = self(inputs)
        logits, losses = self.losses(pam_cam, gt_semantic_seg, meta_infos,
                                     rescale=rescale)
        for name, logit in (("pam", pam_out), ("cam", cam_out)):
            _, aux = self.losses(logit, gt_semantic_seg)
            losses.update({f"{name}.{k}": v for k, v in aux.items()})
        return logits, losses
