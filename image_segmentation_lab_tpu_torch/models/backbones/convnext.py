"""ConvNeXt backbone (counterpart of ``models/backbones/convnext.py``).

The JAX module is NHWC throughout, so its LayerNorms act on the last
axis.  Here the maps between blocks are NCHW; a block runs its 7 x 7
depthwise conv on the map and the rest channels-last, as upstream ConvNeXt
does: the map viewed as ``(N, H, W, C)``, LayerNorm, the two pointwise
projections (JAX 1 x 1 convs, here ``PointwiseLinear``), exact GELU, the
layer scale ``gamma``, back to NCHW for the residual and drop path.  The
stem (4 x 4 stride-4 conv, LayerNorm), the downsamples (LayerNorm, 2 x 2
stride-2 conv) and the per-output LayerNorms normalise over the channels
of an NCHW map (``channel_norm``).

Submodules carry the JAX names: ``stem_conv``, ``stem_norm``,
``downsample<i>_norm``, ``downsample<i>_conv``, ``stage<i>_block<j>`` and
``norm<i>``.  Init (``init_weights``): truncated normal (std 0.02) for
every conv and projection, zero biases, ``gamma`` at
``layer_scale_init_value``.  ``frozen_stages`` and ``with_cp`` are not
ported yet and raise.

Arch table: tiny (3, 3, 9, 3) x (96, 192, 384, 768); small (3, 3, 27, 3)
with the same dims; base (3, 3, 27, 3) x (128, 256, 512, 1024); large
(3, 3, 27, 3) x (192, 384, 768, 1536); xlarge (3, 3, 27, 3) x (256, 512,
1024, 2048).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ...core.registry_hub import BACKBONE
from ..basic.convolution import Conv2d, PointwiseLinear
from ..basic.drop import DropPath
from ..basic.normalization import LayerNorm
from .swin import unported

ARCH_TABLE = {
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "xlarge": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)),
}


def channel_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """dw7x7 -> LN -> pw(4·dim) -> GELU -> pw(dim) -> gamma -> residual."""

    def __init__(self, dim: int, drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.layer_scale_init_value = layer_scale_init_value
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = PointwiseLinear(dim, 4 * dim)
        self.act = nn.GELU()  # exact, as the JAX block's gelu
        self.pwconv2 = PointwiseLinear(4 * dim, dim)
        if layer_scale_init_value > 0:
            self.gamma = nn.Parameter(
                torch.full((dim,), float(layer_scale_init_value)))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.pwconv2(self.act(self.pwconv1(y)))
        if self.layer_scale_init_value > 0:
            y = y * self.gamma
        return x + self.drop_path(y.permute(0, 3, 1, 2))


@BACKBONE.register()
class ConvNeXt(nn.Module):

    def __init__(self,
                 arch: str = "tiny",
                 in_channels: int = 3,
                 depths: Optional[Sequence[int]] = None,
                 dims: Optional[Sequence[int]] = None,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-6,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        unported(frozen_stages=frozen_stages >= 0, with_cp=with_cp)
        if arch not in ARCH_TABLE and None in (depths, dims):
            raise KeyError(f"unknown ConvNeXt arch {arch!r}; choose from "
                           f"{sorted(ARCH_TABLE)} or pass depths+dims")
        table = ARCH_TABLE.get(arch, {})
        depths = tuple(depths or table["depths"])
        dims = tuple(dims or table["dims"])
        assert len(depths) == len(dims)
        assert max(out_indices) < len(depths)
        self.depths = depths
        self.out_indices = tuple(out_indices)
        self.layer_scale_init_value = layer_scale_init_value
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur, in_ch = 0, in_channels
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i == 0:
                self.stem_conv = Conv2d(in_ch, dim, 4, stride=4)
                self.stem_norm = LayerNorm(dim)
            else:
                self.add_module(f"downsample{i}_norm", LayerNorm(in_ch))
                self.add_module(f"downsample{i}_conv",
                                Conv2d(in_ch, dim, 2, stride=2))
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", ConvNeXtBlock(
                    dim, drop_path_rate=rates[cur + j],
                    layer_scale_init_value=layer_scale_init_value))
            if i in self.out_indices:
                self.add_module(f"norm{i}", LayerNorm(dim))
            cur += depth
            in_ch = dim

    def init_weights(self, generator):
        """Truncated normal (std 0.02) for the convs and projections, zero
        biases, the layer scale at its initial value."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, ConvNeXtBlock) and hasattr(m, "gamma"):
                nn.init.constant_(m.gamma, self.layer_scale_init_value)

    def forward(self, x):
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = channel_norm(self.stem_norm, self.stem_conv(x))
            else:
                x = getattr(self, f"downsample{i}_conv")(channel_norm(
                    getattr(self, f"downsample{i}_norm"), x))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i in self.out_indices:
                outs.append(channel_norm(getattr(self, f"norm{i}"),
                                         x).contiguous())
        return outs[0] if len(outs) == 1 else tuple(outs)
