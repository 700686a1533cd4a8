"""MixVisionTransformer (MiT), the SegFormer encoder (counterpart of
``models/backbones/mit.py``).

* Tokens keep an ``(N, L, C)`` layout inside each stage; every projection
  the JAX module writes as a 1 x 1 conv (``q``, ``kv``, ``proj``, ``fc1``,
  ``fc2``) is a ``PointwiseLinear`` on them.  Only the real convs see a
  map: the spatial-reduction ``sr`` conv and the depthwise ``pe_conv`` take
  the tokens as a channels-last NCHW view, and the patch embedding a
  contiguous NCHW map.  Each stage's output is a contiguous NCHW map.
* Efficient (spatially reduced) attention: keys and values come from the
  ``sr`` conv (kernel and stride ``sr_ratio``) and ``sr_norm``, so Lq = H·W
  queries meet Lk = H·W / sr² keys (25600 against 400 in stage 1 at 640²).
  The call goes through ``ops/attention.py``: on a CUDA tensor the flash
  kernels, reading k and v in place as strided views of the fused ``kv``
  output (head ``j`` of ``kv[..., :C]`` holds channels ``j·d ... j·d+d-1``).
  Attention-probability dropout in training keeps a materialised score
  tensor, as the JAX module does.
* Mix-FFN: ``fc1``, the 3 x 3 depthwise ``pe_conv``, exact GELU, ``fc2``.
* Pre-norm blocks with drop path ``rate * i / max(total - 1, 1)`` over all
  blocks; a LayerNorm closes each stage.

Submodules carry the JAX names: ``patch_embed<i>_proj``,
``patch_embed<i>_norm``, ``stage<i>_block<j>`` (from 1) and ``norm<i>``.
Init (``init_weights``): truncated normal (std 0.02) for the pointwise
projections with zero biases; the real convs take the port's default
kaiming normal (fan_out) with zero biases, as the JAX module's do.
``frozen_stages`` and ``with_cp`` are not ported yet and raise.

Arch table: B0 = embed_dims 32, depths (2, 2, 2, 2); B1 = 64, (2, 2, 2, 2);
B2 = 64, (3, 4, 6, 3); B3 = 64, (3, 4, 18, 3); B4 = 64, (3, 8, 27, 3);
B5 = 64, (3, 6, 40, 3).  Heads (1, 2, 5, 8), SR (8, 4, 2, 1), MLP ratio 4.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn

from ...core.registry_hub import BACKBONE
from ...ops.attention import multihead_attention
from ..basic.convolution import Conv2d, PointwiseLinear
from ..basic.drop import Dropout, DropPath
from ..basic.normalization import LayerNorm


def tokens_to_map(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``(N, H·W, C)`` tokens as an ``(N, C, H, W)`` view (channels-last
    strides, no copy)."""
    return x.transpose(1, 2).unflatten(2, tuple(hw))


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """``(N, C, H, W)`` as ``(N, H·W, C)`` tokens (a view)."""
    return x.flatten(2).transpose(1, 2)


class EfficientMultiheadAttention(nn.Module):
    """Spatially reduced multi-head self-attention over ``(N, L, C)``
    tokens of an ``hw`` map."""

    def __init__(self, embed_dims: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, attn_drop_rate: float = 0.0,
                 proj_drop_rate: float = 0.0):
        super().__init__()
        assert embed_dims % num_heads == 0, (embed_dims, num_heads)
        C = embed_dims
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = PointwiseLinear(C, C, bias=qkv_bias)
        if sr_ratio > 1:
            self.sr = Conv2d(C, C, sr_ratio, stride=sr_ratio)
            self.sr_norm = LayerNorm(C)
        self.kv = PointwiseLinear(C, 2 * C, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop_rate)
        self.proj = PointwiseLinear(C, C)
        self.proj_drop = Dropout(proj_drop_rate)

    def forward(self, x, hw):
        N, L, C = x.shape
        h = self.num_heads
        d = C // h
        scale = 1.0 / math.sqrt(d)
        q = self.q(x).unflatten(-1, (h, d))
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(map_to_tokens(self.sr(tokens_to_map(x, hw))))
        k, v = (t.unflatten(-1, (h, d))
                for t in self.kv(kv_in).split(C, dim=-1))
        if self.attn_drop.p > 0.0 and self.training:
            # probability dropout needs the materialised scores (float32,
            # also under autocast)
            with torch.autocast(x.device.type, enabled=False):
                scores = torch.einsum("nlhd,nshd->nhls", q.float(),
                                      k.float())
                attn = self.attn_drop(torch.softmax(scores * scale, dim=-1))
                out = torch.einsum("nhls,nshd->nlhd", attn.to(v.dtype), v)
        else:
            out = multihead_attention(q, k, v, scale)
        return self.proj_drop(self.proj(out.reshape(N, L, C)))


class MixFFN(nn.Module):
    """fc1 -> 3x3 depthwise (positional) conv -> GELU -> fc2."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 drop_rate: float = 0.0):
        super().__init__()
        C, Ch = embed_dims, feedforward_channels
        self.fc1 = PointwiseLinear(C, Ch)
        self.pe_conv = Conv2d(Ch, Ch, 3, padding=1, groups=Ch)
        self.act = nn.GELU()  # exact, as the JAX module's gelu
        self.drop1 = Dropout(drop_rate)
        self.fc2 = PointwiseLinear(Ch, C)
        self.drop2 = Dropout(drop_rate)

    def forward(self, x, hw):
        x = map_to_tokens(self.pe_conv(tokens_to_map(self.fc1(x), hw)))
        return self.drop2(self.fc2(self.drop1(self.act(x))))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm: x += DropPath(Attn(LN x)); x += DropPath(FFN(LN x))."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(embed_dims)
        self.attn = EfficientMultiheadAttention(
            embed_dims, num_heads, sr_ratio=sr_ratio, qkv_bias=qkv_bias,
            attn_drop_rate=attn_drop_rate, proj_drop_rate=drop_rate)
        self.drop_path1 = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(embed_dims)
        self.ffn = MixFFN(embed_dims, feedforward_channels,
                          drop_rate=drop_rate)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x, hw):
        x = x + self.drop_path1(self.attn(self.norm1(x), hw))
        return x + self.drop_path2(self.ffn(self.norm2(x), hw))


@BACKBONE.register("MixVisionTransformer", aliases=("MiT",))
class MixVisionTransformer(nn.Module):

    def __init__(self,
                 in_channels: int = 3,
                 embed_dims: int = 32,
                 num_stages: int = 4,
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 patch_sizes: Sequence[int] = (7, 3, 3, 3),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 mlp_ratio: int = 4,
                 qkv_bias: bool = True,
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        assert num_stages == len(num_layers) == len(num_heads) \
            == len(patch_sizes) == len(strides) == len(sr_ratios)
        assert max(out_indices) < num_stages
        unported = dict(frozen_stages=frozen_stages >= 0, with_cp=with_cp)
        if any(unported.values()):
            raise NotImplementedError(
                "not ported yet (ROADMAP.md Queue 1 item 5): "
                + ", ".join(k for k, v in unported.items() if v))
        self.num_stages = num_stages
        self.num_layers = tuple(num_layers)
        self.out_indices = tuple(out_indices)
        total = sum(num_layers)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        in_ch, cur = in_channels, 0
        for i in range(num_stages):
            dims = embed_dims * num_heads[i]
            self.add_module(f"patch_embed{i + 1}_proj", Conv2d(
                in_ch, dims, patch_sizes[i], stride=strides[i],
                padding=patch_sizes[i] // 2))
            self.add_module(f"patch_embed{i + 1}_norm", LayerNorm(dims))
            for j in range(num_layers[i]):
                self.add_module(f"stage{i + 1}_block{j + 1}",
                                TransformerEncoderLayer(
                                    dims, num_heads[i],
                                    feedforward_channels=mlp_ratio * dims,
                                    sr_ratio=sr_ratios[i], qkv_bias=qkv_bias,
                                    drop_rate=drop_rate,
                                    attn_drop_rate=attn_drop_rate,
                                    drop_path_rate=rates[cur + j]))
            self.add_module(f"norm{i + 1}", LayerNorm(dims))
            cur += num_layers[i]
            in_ch = dims

    def init_weights(self, generator):
        """The JAX module's "linear-role" init: truncated normal (std
        0.02) for the pointwise projections, zero biases."""
        for m in self.modules():
            if isinstance(m, PointwiseLinear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x):
        outs = []
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"patch_embed{i}_proj")(x)
            hw = tuple(x.shape[2:])
            x = getattr(self, f"patch_embed{i}_norm")(map_to_tokens(x))
            for j in range(1, self.num_layers[i - 1] + 1):
                x = getattr(self, f"stage{i}_block{j}")(x, hw)
            x = tokens_to_map(getattr(self, f"norm{i}")(x), hw).contiguous()
            if i - 1 in self.out_indices:
                outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)
