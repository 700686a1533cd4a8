"""PIDNet backbone (counterpart of ``models/backbones/pidnet.py``; Xu et
al., CVPR 2023).

After DDRNet's shared 1/8 trunk three branches run: P (detail) stays at 1/8
and takes the I branch's compressed features through ``PagFM`` (a sigmoid
gate of a channel dot product); I (context) strides on to 1/64 and is
summarised by ``PAPPM`` (PIDNet-S: the four pooled branches refined by one
grouped 3 x 3 conv) or ``DAPPM`` (-M/-L); D (boundary) is fed by strided
"diff" taps off the I branch, and its sigmoid steers the final ``LightBag``
(-S) or ``Bag`` (-M/-L) fusion.  The switch is ``num_stem_blocks == 2``,
as upstream's.

As in the JAX package (its module docstring): the blocks are the
always-ReLU ``BasicBlock`` and the expansion-4 ``Bottleneck`` of
``resnet.py`` at ``planes = cout // 4`` (upstream's PIDNet Bottleneck has
expansion 2), so the stage-boundary ReLUs are idempotent.  A map that
feeds several branches (the trunk's ``x``, the I branch's ``x_i``) is
never rectified in place.

Outputs ``(x_p after stage 3 @1/8 2C, x_d after stage 4 @1/8, merged
@1/8 4C)``.  Submodules carry the JAX names (``i_layer3_<j>``,
``pag3.f_i``, ``spp.scales_<i>``, ``dfm``, ...).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import BACKBONE
from ...utils.ops import resize
from ..common.conv_module import ConvModule
from .ddrnet import DAPPM, preact, pyramid_pools, run_blocks
from .resnet import BasicBlock, Bottleneck, NormEval


class PagFM(nn.Module):
    """``sigma * up(x_i) + (1 - sigma) * x_p`` with ``sigma =
    sigmoid(<f_p(x_p), up(f_i(x_i))>)`` over channels (or a 1 x 1 conv of
    the product, ``with_channel``)."""

    def __init__(self, in_channels: int, channels: int,
                 after_relu: bool = False, with_channel: bool = False,
                 align_corners: bool = False,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        ncfg = dict(norm_cfg or dict(type="BN"))
        self.after_relu = after_relu
        self.with_channel = with_channel
        self.align_corners = align_corners
        self.f_i = ConvModule(in_channels, channels, 1, norm_cfg=ncfg,
                              act_cfg=None)
        self.f_p = ConvModule(in_channels, channels, 1, norm_cfg=ncfg,
                              act_cfg=None)
        if with_channel:
            self.up = ConvModule(channels, in_channels, 1, norm_cfg=ncfg,
                                 act_cfg=None)

    def forward(self, x_p, x_i):
        if self.after_relu:
            x_p, x_i = F.relu(x_p), F.relu(x_i)
        up = dict(size=x_p.shape[2:], mode="bilinear",
                  align_corners=self.align_corners)
        f_i = resize(self.f_i(x_i), **up)
        f_p = self.f_p(x_p)
        if self.with_channel:
            sigma = torch.sigmoid(self.up(f_p * f_i))
        else:
            sigma = torch.sigmoid((f_p * f_i).sum(1, keepdim=True))
        return sigma * resize(x_i, **up) + (1 - sigma) * x_p


class PAPPM(nn.Module):
    """DAPPM's pools, with the four (branch + scale0) sums refined by one
    grouped 3 x 3 conv side by side; pre-activation throughout."""

    def __init__(self, in_channels: int, branch_channels: int,
                 out_channels: int, norm_cfg: Optional[Dict] = None,
                 align_corners: bool = False):
        super().__init__()
        ncfg = dict(norm_cfg or dict(type="BN"))
        bc = branch_channels
        self.align_corners = align_corners
        self.scale0 = preact(in_channels, bc, 1, ncfg)
        self.scales = nn.ModuleList(preact(in_channels, bc, 1, ncfg)
                                    for _ in range(4))
        self.processes = preact(bc * 4, bc * 4, 3, ncfg, padding=1,
                                groups=4)
        self.compression = preact(bc * 5, out_channels, 1, ncfg)
        self.shortcut = preact(in_channels, out_channels, 1, ncfg)

    def forward(self, x):
        x_ = self.scale0(x)
        feats = [resize(scale(pool), size=x.shape[2:], mode="bilinear",
                        align_corners=self.align_corners) + x_
                 for pool, scale in zip(pyramid_pools(x), self.scales)]
        scale_out = self.processes(torch.cat(feats, dim=1))
        out = self.compression(torch.cat([x_, scale_out], dim=1))
        return out + self.shortcut(x)


class Bag(nn.Module):
    """Boundary-attention-guided fusion: the D branch's sigmoid takes P's
    features at boundaries and I's inside, then BN -> ReLU -> 3 x 3."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.conv = preact(in_channels, out_channels, 3,
                           dict(norm_cfg or dict(type="BN")), padding=1)

    def forward(self, x_p, x_i, x_d):
        sigma = torch.sigmoid(x_d)
        return self.conv(sigma * x_p + (1 - sigma) * x_i)


class LightBag(nn.Module):
    """Bag with two 1 x 1 convs (PIDNet-S)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        ncfg = dict(norm_cfg or dict(type="BN"))
        self.f_p = ConvModule(in_channels, out_channels, 1, norm_cfg=ncfg,
                              act_cfg=None)
        self.f_i = ConvModule(in_channels, out_channels, 1, norm_cfg=ncfg,
                              act_cfg=None)

    def forward(self, x_p, x_i, x_d):
        sigma = torch.sigmoid(x_d)
        return (self.f_p((1 - sigma) * x_i + x_p)
                + self.f_i(x_i + sigma * x_p))


@BACKBONE.register()
class PIDNet(NormEval, nn.Module):
    """PIDNet-S: ``channels=32, ppm_channels=96, num_stem_blocks=2,
    num_branch_blocks=3``; -M: ``channels=64``; -L: ``channels=64,
    ppm_channels=112, num_stem_blocks=3, num_branch_blocks=4``."""

    def __init__(self,
                 in_channels: int = 3,
                 channels: int = 32,
                 ppm_channels: int = 96,
                 num_stem_blocks: int = 2,
                 num_branch_blocks: int = 3,
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

        def basics(n, cin, cout, stride=1):
            return nn.ModuleList(
                BasicBlock(cin if j == 0 else cout, cout,
                           stride=stride if j == 0 else 1, norm_cfg=norm_cfg)
                for j in range(n))

        def bottles(n, cin, cout, stride=1):
            assert cout % 4 == 0, cout
            return nn.ModuleList(
                Bottleneck(cin if j == 0 else cout, cout // 4,
                           stride=stride if j == 0 else 1, norm_cfg=norm_cfg)
                for j in range(n))

        self.stem = nn.ModuleList([
            ConvModule(in_channels, C, 3, stride=2, padding=1, **ck),
            ConvModule(C, C, 3, stride=2, padding=1, **ck)])
        ns, nb = num_stem_blocks, num_branch_blocks
        self.layer1 = basics(ns, C, C)
        self.layer2 = basics(ns, C, 2 * C, 2)
        self.i_layer3 = basics(nb, 2 * C, 4 * C, 2)
        self.i_layer4 = basics(nb, 4 * C, 8 * C, 2)
        self.i_layer5 = bottles(2, 8 * C, 16 * C, 2)
        self.p_layer3 = basics(ns, 2 * C, 2 * C)
        self.p_layer4 = basics(ns, 2 * C, 2 * C)
        self.p_layer5 = bottles(1, 2 * C, 4 * C)
        self.compression3 = ConvModule(4 * C, 2 * C, 1, **nk)
        self.compression4 = ConvModule(8 * C, 2 * C, 1, **nk)
        self.pag3 = PagFM(2 * C, C, norm_cfg=norm_cfg,
                          align_corners=align_corners)
        self.pag4 = PagFM(2 * C, C, norm_cfg=norm_cfg,
                          align_corners=align_corners)
        if num_stem_blocks == 2:
            self.d_layer3 = basics(1, 2 * C, C)
            self.d_layer4 = bottles(1, C, 2 * C)
            spp_cls, bag_cls, d_width = PAPPM, LightBag, C
        else:
            self.d_layer3 = basics(1, 2 * C, 2 * C)
            self.d_layer4 = basics(1, 2 * C, 2 * C)
            spp_cls, bag_cls, d_width = DAPPM, Bag, 2 * C
        self.d_layer5 = bottles(1, 2 * C, 4 * C)
        self.diff3 = ConvModule(4 * C, d_width, 3, padding=1, **nk)
        self.diff4 = ConvModule(8 * C, 2 * C, 3, padding=1, **nk)
        self.spp = spp_cls(16 * C, ppm_channels, 4 * C, norm_cfg=norm_cfg)
        self.dfm = bag_cls(4 * C, 4 * C, norm_cfg=norm_cfg)

    def _up(self, x, like):
        return resize(x, size=like.shape[2:], mode="bilinear",
                      align_corners=self.align_corners)

    def forward(self, x):
        for conv in self.stem:
            x = conv(x)
        x = run_blocks(self.layer1, x)
        x = run_blocks(self.layer2, F.relu(x))

        # stage 3: the I branch forks off; P gated by it, D fed by a diff
        x_i = run_blocks(self.i_layer3, F.relu(x))              # 1/16 4C
        x_p = run_blocks(self.p_layer3, x)                      # 1/8 2C
        x_d = run_blocks(self.d_layer3, x)
        x_p = self.pag3(x_p, self.compression3(F.relu(x_i)))
        x_d = x_d + self._up(self.diff3(F.relu(x_i)), x_d)
        p_tap = x_p

        # stage 4
        x_i = run_blocks(self.i_layer4, F.relu(x_i))            # 1/32 8C
        x_p = run_blocks(self.p_layer4, F.relu(x_p))
        x_d = run_blocks(self.d_layer4, F.relu(x_d))            # 2C
        x_p = self.pag4(x_p, self.compression4(F.relu(x_i)))
        x_d = x_d + self._up(self.diff4(F.relu(x_i)), x_d)
        d_tap = x_d

        # stage 5, the pyramid and the boundary-guided merge at 1/8
        x_i = run_blocks(self.i_layer5, F.relu(x_i))            # 1/64 16C
        x_p = run_blocks(self.p_layer5, F.relu(x_p))            # 4C
        x_d = run_blocks(self.d_layer5, F.relu(x_d))            # 4C
        ctx = self._up(self.spp(x_i), x_p)
        return p_tap, d_tap, self.dfm(x_p, ctx, x_d)
