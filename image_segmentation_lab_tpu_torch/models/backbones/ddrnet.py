"""DDRNet backbone (counterpart of ``models/backbones/ddrnet.py``; Hong et
al., 2021; DDRNet-23-slim at ``channels=32``, DDRNet-23 at 64).

After a shared 1/8 trunk the network forks into a spatial branch that stays
at 1/8 and a context branch that strides on to 1/64; after stages 3 and 4
the branches exchange features (a 1 x 1 compression resized up into the
spatial branch, a strided 3 x 3 chain down into the context branch), and
``DAPPM`` summarises the 1/64 features before the final resize-and-add at
1/8.  As in the JAX package the blocks are the always-ReLU ``BasicBlock``
and ``Bottleneck`` of ``resnet.py`` (upstream ends its stages without a
ReLU), so the ReLUs at the stage boundaries are idempotent; none runs in
place, since a branch's input feeds other branches too.

Outputs ``(spatial tap after stage 3's fusion @1/8 2C, merged @1/8 4C)``.
Submodules carry the JAX names (``stem_<i>``, ``layer3_s_<j>``,
``down4_<i>``, ``spp.scales_<i>``, ...).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import BACKBONE
from ...ops.pooling import avg_pool2d
from ...utils.ops import resize
from ..common.conv_module import ConvModule
from .resnet import BasicBlock, Bottleneck, NormEval

PREACT = ("norm", "act", "conv")


def pyramid_pools(x):
    """The DAPPM/PAPPM pools of ``x``: 5/2, 9/4 and 17/8 averages (the
    padding counted) and the global mean."""
    return [avg_pool2d(x, 5, 2, padding=2), avg_pool2d(x, 9, 4, padding=4),
            avg_pool2d(x, 17, 8, padding=8), x.mean((2, 3), keepdim=True)]


def preact(in_channels, out_channels, kernel_size, norm_cfg, **kwargs):
    """BN -> ReLU -> conv (not in place: the input is kept by the
    caller)."""
    return ConvModule(in_channels, out_channels, kernel_size,
                      norm_cfg=dict(norm_cfg), act_cfg=dict(type="ReLU"),
                      order=PREACT, **kwargs)


def run_blocks(blocks, x):
    for block in blocks:
        x = block(x)
    return x


class DAPPM(nn.Module):
    """Deep Aggregation Pyramid Pooling: branch ``i`` pools, projects by
    1 x 1, resizes up and is refined by a 3 x 3 conv of (branch + the
    previous refined branch), a cascade; pre-activation throughout."""

    def __init__(self, in_channels: int, branch_channels: int,
                 out_channels: int, norm_cfg: Optional[Dict] = None):
        super().__init__()
        ncfg = dict(norm_cfg or dict(type="BN"))
        bc = branch_channels
        self.scale0 = preact(in_channels, bc, 1, ncfg)
        self.scales = nn.ModuleList(preact(in_channels, bc, 1, ncfg)
                                    for _ in range(4))
        self.processes = nn.ModuleList(preact(bc, bc, 3, ncfg, padding=1)
                                       for _ in range(4))
        self.compression = preact(bc * 5, out_channels, 1, ncfg)
        self.shortcut = preact(in_channels, out_channels, 1, ncfg)

    def forward(self, x):
        size = x.shape[2:]
        outs = [self.scale0(x)]
        for pool, scale, process in zip(pyramid_pools(x), self.scales,
                                        self.processes):
            y = resize(scale(pool), size=size, mode="bilinear",
                       align_corners=False)
            outs.append(process(y + outs[-1]))
        return self.compression(torch.cat(outs, dim=1)) + self.shortcut(x)


@BACKBONE.register()
class DDRNet(NormEval, nn.Module):

    def __init__(self,
                 in_channels: int = 3,
                 channels: int = 32,
                 ppm_channels: int = 128,
                 align_corners: bool = False,
                 norm_cfg: Optional[Dict] = None,
                 norm_eval: bool = False,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        C = channels
        self.align_corners = align_corners
        self.norm_eval = norm_eval
        norm_cfg = dict(norm_cfg or dict(type="BN", requires_grad=True))
        ck = dict(norm_cfg=norm_cfg, act_cfg=dict(type="ReLU"))
        nk = dict(norm_cfg=norm_cfg, act_cfg=None)

        def blocks(n, cin, cout, stride):
            return nn.ModuleList(
                BasicBlock(cin if j == 0 else cout, cout,
                           stride=stride if j == 0 else 1, norm_cfg=norm_cfg)
                for j in range(n))

        self.stem = nn.ModuleList([
            ConvModule(in_channels, C, 3, stride=2, padding=1, **ck),
            ConvModule(C, C, 3, stride=2, padding=1, **ck)])
        self.layer1 = blocks(2, C, C, 1)
        self.layer2 = blocks(2, C, 2 * C, 2)
        self.layer3 = blocks(2, 2 * C, 4 * C, 2)
        self.layer4 = blocks(2, 4 * C, 8 * C, 2)
        self.layer5 = nn.ModuleList([Bottleneck(8 * C, 8 * C // 4 * 2,
                                                stride=2, norm_cfg=norm_cfg)])
        self.layer3_s = blocks(2, 2 * C, 2 * C, 1)
        self.layer4_s = blocks(2, 2 * C, 2 * C, 1)
        self.layer5_s = nn.ModuleList([Bottleneck(2 * C, C,
                                                  norm_cfg=norm_cfg)])
        self.compression3 = ConvModule(4 * C, 2 * C, 1, **nk)
        self.compression4 = ConvModule(8 * C, 2 * C, 1, **nk)
        self.down3 = ConvModule(2 * C, 4 * C, 3, stride=2, padding=1, **nk)
        self.down4 = nn.ModuleList([
            ConvModule(2 * C, 4 * C, 3, stride=2, padding=1, **ck),
            ConvModule(4 * C, 8 * C, 3, stride=2, padding=1, **nk)])
        self.spp = DAPPM(16 * C, ppm_channels, 4 * C, norm_cfg=norm_cfg)
        self.final_compression = ConvModule(4 * C, 4 * C, 1, **nk)

    def _up(self, x, like):
        return resize(x, size=like.shape[2:], mode="bilinear",
                      align_corners=self.align_corners)

    def forward(self, x):
        for conv in self.stem:
            x = conv(x)
        x = run_blocks(self.layer1, x)
        x = run_blocks(self.layer2, F.relu(x))

        xc = run_blocks(self.layer3, F.relu(x))                 # 1/16
        xs = run_blocks(self.layer3_s, F.relu(x))               # 1/8
        comp = self._up(self.compression3(F.relu(xc)), xs)
        down = self.down3(F.relu(xs))
        xs, xc = xs + comp, xc + down
        aux = xs

        xc = run_blocks(self.layer4, F.relu(xc))                # 1/32
        xs = run_blocks(self.layer4_s, F.relu(xs))
        comp = self._up(self.compression4(F.relu(xc)), xs)
        down = self.down4[1](self.down4[0](F.relu(xs)))
        xs, xc = xs + comp, xc + down

        xs = run_blocks(self.layer5_s, F.relu(xs))
        xc = run_blocks(self.layer5, F.relu(xc))                # 1/64, 16C
        ctx = self.final_compression(self.spp(xc))
        return aux, xs + self._up(ctx, xs)
