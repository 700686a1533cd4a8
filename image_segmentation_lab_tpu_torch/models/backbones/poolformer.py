"""PoolFormer backbone, the MetaFormer with a pooling token mixer
(counterpart of ``models/backbones/poolformer.py``).

NCHW maps throughout.  Block: ``x += DropPath(ls1 · (avgpool3x3(GN x) -
GN x))`` with ``count_include_pad=False`` (``ops/pooling.avg_pool2d``),
then ``x += DropPath(ls2 · fc2(GELU(fc1(GN x))))`` with 1 x 1 convs; the
norms are ``GroupNorm(1)`` (the port's float32 ``GroupNorm``) and the
layer scales per-channel vectors initialised to 1e-5.  A 7 x 7 stride-4
stem and 3 x 3 stride-2 transitions; each emitted map gets its own
``GroupNorm(1)``.  Submodules carry the JAX names ``patch_embed<i>``,
``stage<i>_block<j>`` (``norm1``, ``layer_scale_1``, ``norm2``, ``fc1``,
``fc2``, ``layer_scale_2``) and ``norm<i>``.  Init (``init_weights``):
truncated normal (std 0.02) for every conv, zero biases.  ``frozen_stages``
and ``with_cp`` are not ported yet and raise.

Arch table (mlp ratio 4): s12 (2, 2, 6, 2) x (64, 128, 320, 512), s24
(4, 4, 12, 4), s36 (6, 6, 18, 6) on the same widths, m36 (6, 6, 18, 6) x
(96, 192, 384, 768), m48 (8, 8, 24, 8) on those.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ...core.registry_hub import BACKBONE
from ...ops.pooling import avg_pool2d
from ..basic.convolution import Conv2d
from ..basic.drop import DropPath
from ..basic.normalization import GroupNorm

ARCH_TABLE = {
    "s12": dict(depths=(2, 2, 6, 2), dims=(64, 128, 320, 512)),
    "s24": dict(depths=(4, 4, 12, 4), dims=(64, 128, 320, 512)),
    "s36": dict(depths=(6, 6, 18, 6), dims=(64, 128, 320, 512)),
    "m36": dict(depths=(6, 6, 18, 6), dims=(96, 192, 384, 768)),
    "m48": dict(depths=(8, 8, 24, 8), dims=(96, 192, 384, 768)),
}


class PoolFormerBlock(nn.Module):
    """GN -> (avgpool3x3 - id) -> ls1 -> +res; GN -> MLP -> ls2 -> +res."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-5):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = GroupNorm(1, dim)
        self.norm2 = GroupNorm(1, dim)
        self.fc1 = Conv2d(dim, hidden, 1)
        self.act = nn.GELU()  # exact, as the JAX module's gelu
        self.fc2 = Conv2d(hidden, dim, 1)
        self.drop_path1 = DropPath(drop_path_rate)
        self.drop_path2 = DropPath(drop_path_rate)
        self.scaled = layer_scale_init_value > 0
        if self.scaled:
            self.layer_scale_1 = nn.Parameter(
                torch.full((dim,), layer_scale_init_value))
            self.layer_scale_2 = nn.Parameter(
                torch.full((dim,), layer_scale_init_value))

    def forward(self, x):
        h = self.norm1(x)
        h = avg_pool2d(h, 3, 1, padding=1, count_include_pad=False) - h
        if self.scaled:
            h = h * self.layer_scale_1.to(h.dtype)[:, None, None]
        x = x + self.drop_path1(h)
        h = self.fc2(self.act(self.fc1(self.norm2(x))))
        if self.scaled:
            h = h * self.layer_scale_2.to(h.dtype)[:, None, None]
        return x + self.drop_path2(h)


@BACKBONE.register()
class PoolFormer(nn.Module):

    def __init__(self,
                 arch: str = "s12",
                 in_channels: int = 3,
                 depths: Optional[Sequence[int]] = None,
                 dims: Optional[Sequence[int]] = None,
                 mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-5,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        if arch not in ARCH_TABLE and (depths is None or dims is None):
            raise KeyError(f"unknown PoolFormer arch {arch!r}; choose from "
                           f"{sorted(ARCH_TABLE)} or pass depths+dims")
        unported = dict(frozen_stages=frozen_stages >= 0, with_cp=with_cp)
        if any(unported.values()):
            raise NotImplementedError(
                "not ported yet (ROADMAP.md Queue 1 item 5): "
                + ", ".join(k for k, v in unported.items() if v))
        table = ARCH_TABLE.get(arch, {})
        self.depths = tuple(depths or table["depths"])
        dims = tuple(dims or table["dims"])
        assert len(self.depths) == len(dims)
        assert max(out_indices) < len(self.depths)
        self.out_indices = tuple(out_indices)
        total = sum(self.depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur, in_ch = 0, in_channels
        for i, (depth, dim) in enumerate(zip(self.depths, dims)):
            self.add_module(f"patch_embed{i}", (
                Conv2d(in_ch, dim, 7, stride=4, padding=2) if i == 0
                else Conv2d(in_ch, dim, 3, stride=2, padding=1)))
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", PoolFormerBlock(
                    dim, mlp_ratio, rates[cur + j], layer_scale_init_value))
            if i in self.out_indices:
                self.add_module(f"norm{i}", GroupNorm(1, dim))
            cur += depth
            in_ch = dim

    def init_weights(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, x):
        outs = []
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"patch_embed{i}")(x)
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
        return outs[0] if len(outs) == 1 else tuple(outs)
