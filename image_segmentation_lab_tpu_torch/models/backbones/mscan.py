"""MSCAN backbone, SegNeXt's encoder (counterpart of
``models/backbones/mscan.py``; Guo et al., NeurIPS 2022).

NCHW maps throughout.  Each block gates its input with multi-scale
convolutional attention: a 5 x 5 depthwise conv, then three depthwise strip
pairs (1 x 7 / 7 x 1, 1 x 11 / 11 x 1, 1 x 21 / 21 x 1), summed and mixed
by a 1 x 1 conv, times the input.  Block: ``x += DropPath(ls1 ·
attn(BN x))``, ``x += DropPath(ls2 · mlp(BN x))``, with exact GELU and
per-channel layer scales (1e-2 at init); each stage ends in a channel
LayerNorm (``LayerNorm2d``).  The stem is two stride-2 3 x 3 convs with BN
(and a GELU between), each later stage opens with a stride-2 3 x 3 conv
and BN.

Submodules carry the JAX names: ``stem_conv1``/``stem_conv2``,
``embed<i>_conv``, the embeds' norms ``patch_embeds_<i>_<j>``,
``stage<i>_block<j>`` (``norm1``, ``attn.proj_1``,
``attn.spatial_gating_unit.conv0``/``conv<k>_1``/``conv<k>_2``/``conv3``,
``attn.proj_2``, ``norm2``, ``mlp.fc1``/``dwconv``/``fc2``,
``layer_scale_1``/``layer_scale_2``) and ``norm<i>``.  ``frozen_stages``
and ``with_cp`` are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import BACKBONE
from ..basic.convolution import Conv2d
from ..basic.drop import DropPath
from ..basic.normalization import LayerNorm2d
from ..builder import build_norm_layer
from .resnet import NormEval

ARCH_TABLE = {
    "tiny": dict(dims=(32, 64, 160, 256), depths=(3, 3, 5, 2),
                 mlp_ratios=(8, 8, 4, 4)),
    "small": dict(dims=(64, 128, 320, 512), depths=(2, 2, 4, 2),
                  mlp_ratios=(8, 8, 4, 4)),
    "base": dict(dims=(64, 128, 320, 512), depths=(3, 3, 12, 3),
                 mlp_ratios=(8, 8, 4, 4)),
    "large": dict(dims=(64, 128, 320, 512), depths=(3, 5, 27, 3),
                  mlp_ratios=(8, 8, 4, 4)),
}

ATTN_KERNELS = ((1, 7), (1, 11), (1, 21))   # after the 5 x 5 opener


class MSCAAttention(nn.Module):
    """5 x 5 depthwise, three depthwise strip pairs, 1 x 1 mix, gate."""

    def __init__(self, channels: int):
        super().__init__()
        C = channels
        self.conv0 = Conv2d(C, C, 5, padding=2, groups=C)
        for i, (a, b) in enumerate(ATTN_KERNELS):
            self.add_module(f"conv{i}_1", Conv2d(C, C, (a, b),
                                                 padding=(0, b // 2),
                                                 groups=C))
            self.add_module(f"conv{i}_2", Conv2d(C, C, (b, a),
                                                 padding=(b // 2, 0),
                                                 groups=C))
        self.conv3 = Conv2d(C, C, 1)

    def forward(self, x):
        attn = self.conv0(x)
        total = attn
        for i in range(len(ATTN_KERNELS)):
            total = total + getattr(self, f"conv{i}_2")(
                getattr(self, f"conv{i}_1")(attn))
        return self.conv3(total) * x


class MSCASpatialAttention(nn.Module):
    """proj -> GELU -> MSCA gate -> proj, plus the input."""

    def __init__(self, channels: int):
        super().__init__()
        self.proj_1 = Conv2d(channels, channels, 1)
        self.spatial_gating_unit = MSCAAttention(channels)
        self.proj_2 = Conv2d(channels, channels, 1)

    def forward(self, x):
        h = self.spatial_gating_unit(F.gelu(self.proj_1(x)))
        return self.proj_2(h) + x


class MSCAMlp(nn.Module):
    """1 x 1 expand -> 3 x 3 depthwise -> GELU -> 1 x 1 project."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.fc1 = Conv2d(channels, hidden, 1)
        self.dwconv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = Conv2d(hidden, channels, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class MSCABlock(nn.Module):
    """BN -> attention (x ls1, drop path) -> BN -> MLP (x ls2, drop
    path), each with its residual."""

    def __init__(self, channels: int, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.0,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        ncfg = dict(norm_cfg or dict(type="BN"))
        self.norm1 = build_norm_layer(ncfg, channels)[1]
        self.attn = MSCASpatialAttention(channels)
        self.norm2 = build_norm_layer(ncfg, channels)[1]
        self.mlp = MSCAMlp(channels, channels * mlp_ratio)
        self.drop_path = DropPath(drop_path_rate)
        self.layer_scale_1 = nn.Parameter(torch.full((channels,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((channels,), 1e-2))

    def forward(self, x):
        h = self.attn(self.norm1(x))
        x = x + self.drop_path(
            self.layer_scale_1.to(h.dtype)[:, None, None] * h)
        h = self.mlp(self.norm2(x))
        return x + self.drop_path(
            self.layer_scale_2.to(h.dtype)[:, None, None] * h)


@BACKBONE.register()
class MSCAN(NormEval, nn.Module):

    def __init__(self,
                 arch: str = "tiny",
                 in_channels: int = 3,
                 embed_dims: Optional[Sequence[int]] = None,
                 depths: Optional[Sequence[int]] = None,
                 mlp_ratios: Optional[Sequence[int]] = None,
                 drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 norm_cfg: Optional[Dict] = None,
                 frozen_stages: int = -1,
                 norm_eval: bool = False,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        if arch not in ARCH_TABLE and (embed_dims is None or depths is None):
            raise KeyError(f"unknown MSCAN arch {arch!r}; choose from "
                           f"{sorted(ARCH_TABLE)} or pass embed_dims+depths")
        unported = dict(frozen_stages=frozen_stages >= 0, with_cp=with_cp)
        if any(unported.values()):
            raise NotImplementedError(
                "not ported yet (ROADMAP.md Queue 1 item 8): "
                + ", ".join(k for k, v in unported.items() if v))
        table = ARCH_TABLE.get(arch, {})
        dims = tuple(embed_dims or table["dims"])
        self.depths = tuple(depths or table["depths"])
        ratios = tuple(mlp_ratios or table.get("mlp_ratios", (8, 8, 4, 4)))
        assert len(dims) == len(self.depths) == len(ratios)
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        norm_cfg = dict(norm_cfg or dict(type="SyncBatchNorm",
                                         requires_grad=True))
        total = sum(self.depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur, in_ch = 0, in_channels
        for i, (dim, depth, ratio) in enumerate(zip(dims, self.depths,
                                                    ratios)):
            if i == 0:
                self.stem_conv1 = Conv2d(in_ch, dim // 2, 3, stride=2,
                                         padding=1)
                self.patch_embeds_0_1 = build_norm_layer(norm_cfg,
                                                         dim // 2)[1]
                self.stem_conv2 = Conv2d(dim // 2, dim, 3, stride=2,
                                         padding=1)
                self.patch_embeds_0_3 = build_norm_layer(norm_cfg, dim)[1]
            else:
                self.add_module(f"embed{i}_conv", Conv2d(in_ch, dim, 3,
                                                         stride=2, padding=1))
                self.add_module(f"patch_embeds_{i}_1",
                                build_norm_layer(norm_cfg, dim)[1])
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", MSCABlock(
                    dim, ratio, rates[cur + j], norm_cfg))
            self.add_module(f"norm{i}", LayerNorm2d(dim))
            cur += depth
            in_ch = dim

    def forward(self, x):
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = F.gelu(self.patch_embeds_0_1(self.stem_conv1(x)))
                x = self.patch_embeds_0_3(self.stem_conv2(x))
            else:
                x = getattr(self, f"patch_embeds_{i}_1")(
                    getattr(self, f"embed{i}_conv")(x))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            x = getattr(self, f"norm{i}")(x)
            if i in self.out_indices:
                outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)
