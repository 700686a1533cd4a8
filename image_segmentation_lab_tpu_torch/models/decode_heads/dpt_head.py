"""DPT decode head (counterpart of ``models/decode_heads/dpt_head.py``).

* ``ReassembleBlocks`` lifts four ViT taps, ``(map, cls)`` pairs from the
  backbone's ``output_cls_token``, to a pyramid: the readout (``project``:
  each token concatenated with the class token, ``Linear(2C -> C)`` and
  exact GELU; ``add``: the class token added; ``ignore``), a 1 x 1
  projection to each level's channels, then a 4x and a 2x transposed conv,
  the identity and a stride-2 3 x 3 conv.
* ``PreActResidualConvUnit``: ``x + conv2(conv1(x))`` with each
  ``ConvModule`` in the order activation, conv, norm (no bias).
* ``FeatureFusionBlock``: the skip level (resized bilinearly to the map
  when the sizes differ) through a residual unit added to the map, a
  second unit, a 2x bilinear resize at the head's ``align_corners`` and a
  1 x 1 projection.
* ``DPTHead``: a 3 x 3 conv per level to ``channels``, the fusion blocks
  from the coarsest level down, a 3 x 3 ``ConvModule`` and the classifier.

Submodules carry the JAX names (``reassemble_blocks.readout_projects_<i>``,
``projects_<i>``, ``resize_layers_<i>``, ``convs_<i>``,
``fusion_blocks_<i>.res_conv_unit<1|2>``, ``project``); the first fusion
block has no ``res_conv_unit1``.  Init (``init_weights``): the readout
``Linear``s, the transposed convs and the stride-2 conv are drawn by
torch's default rule, uniform in +-1/sqrt(fan_in) for weights and biases,
as the JAX module's are.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..basic.convolution import Conv2d, ConvTranspose2d, Linear
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


class ReassembleBlocks(nn.Module):
    """Readout, 1 x 1 projection and rescale of each tap."""

    def __init__(self, in_channels: int = 768,
                 out_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = "ignore", patch_size: int = 16):
        super().__init__()
        assert readout_type in ("ignore", "add", "project")
        assert len(out_channels) == 4
        oc = out_channels
        self.readout_type = readout_type
        self.projects = nn.ModuleList(
            ConvModule(in_channels, c, 1, act_cfg=None) for c in oc)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        if readout_type == "project":
            self.readout_projects = nn.ModuleList(
                Linear(2 * in_channels, in_channels) for _ in range(4))

    def forward(self, inputs):
        outs = []
        for i, pair in enumerate(inputs):
            assert isinstance(pair, (tuple, list)) and len(pair) == 2, \
                "DPT needs (feature map, cls token) pairs: set the ViT's " \
                "output_cls_token=True"
            x, cls_token = pair
            N, C, H, W = x.shape
            if self.readout_type == "project":
                t = x.flatten(2).transpose(1, 2)
                t = torch.cat([t, cls_token[:, None].expand_as(t)], dim=-1)
                t = F.gelu(self.readout_projects[i](t))
                x = t.transpose(1, 2).reshape(N, C, H, W)
            elif self.readout_type == "add":
                x = x + cls_token[:, :, None, None]
            outs.append(self.resize_layers[i](self.projects[i](x)))
        return outs


class PreActResidualConvUnit(nn.Module):
    """``x + conv2(conv1(x))``, each act -> conv -> norm."""

    def __init__(self, in_channels: int, act_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg, act_cfg=act_cfg, bias=False,
                  order=("act", "conv", "norm"))
        self.conv1 = ConvModule(in_channels, in_channels, 3, stride=stride,
                                padding=dilation, dilation=dilation, **kw)
        self.conv2 = ConvModule(in_channels, in_channels, 3, padding=1, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class FeatureFusionBlock(nn.Module):
    """Top-down fusion: residual units, 2x upsample, 1 x 1 projection."""

    def __init__(self, in_channels: int, act_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None, expand: bool = False,
                 align_corners: bool = False, with_unit1: bool = True):
        super().__init__()
        out = in_channels // 2 if expand else in_channels
        self.align_corners = align_corners
        self.project = ConvModule(in_channels, out, 1, act_cfg=None)
        if with_unit1:
            self.res_conv_unit1 = PreActResidualConvUnit(in_channels,
                                                         act_cfg, norm_cfg)
        self.res_conv_unit2 = PreActResidualConvUnit(in_channels, act_cfg,
                                                     norm_cfg)

    def forward(self, x, skip=None):
        if skip is not None:
            if x.shape != skip.shape:
                skip = resize(skip, size=x.shape[2:], mode="bilinear",
                              align_corners=False)
            x = x + self.res_conv_unit1(skip)
        x = self.res_conv_unit2(x)
        x = resize(x, size=(2 * x.shape[2], 2 * x.shape[3]),
                   mode="bilinear", align_corners=self.align_corners)
        return self.project(x)


@DECODEHEAD.register()
class DPTHead(BaseDecodeHead):

    def __init__(self, embed_dims: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = "ignore", patch_size: int = 16,
                 expand_channels: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.reassemble_blocks = ReassembleBlocks(
            embed_dims, post_process_channels, readout_type, patch_size)
        ppc = [c * 2 ** i if expand_channels else c
               for i, c in enumerate(post_process_channels)]
        self.convs = nn.ModuleList(
            ConvModule(c, self.channels, 3, padding=1, act_cfg=None,
                       bias=False) for c in ppc)
        self.fusion_blocks = nn.ModuleList(
            FeatureFusionBlock(self.channels, self.act_cfg, self.norm_cfg,
                               align_corners=self.align_corners,
                               with_unit1=i != 0)
            for i in range(len(ppc)))
        self.project = ConvModule(self.channels, self.channels, 3,
                                  padding=1, norm_cfg=self.norm_cfg)

    def init_weights(self, generator):
        super().init_weights(generator)
        blocks = self.reassemble_blocks
        for m in (*blocks.resize_layers, *getattr(blocks, "readout_projects",
                                                  ())):
            if isinstance(m, nn.Identity):
                continue
            bound = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))
            for t in (m.weight, m.bias):
                t.uniform_(-bound, bound, generator=generator)

    def forward(self, inputs):
        x = self.reassemble_blocks(self._transform_inputs(inputs))
        x = [conv(f) for conv, f in zip(self.convs, x)]
        out = self.fusion_blocks[0](x[-1])
        for i in range(1, len(self.fusion_blocks)):
            out = self.fusion_blocks[i](out, x[-(i + 1)])
        return self.cls_seg(self.project(out))
