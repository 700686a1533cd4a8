"""Twins backbones, PCPVT and SVT (counterpart of
``models/backbones/twins.py``).

* Tokens keep an ``(N, L, C)`` layout inside each stage, as MiT's do
  (``mit.tokens_to_map``/``map_to_tokens``); each stage's output is a
  contiguous NCHW map.
* Stage ``i``: a patch embedding (a conv of kernel and stride 4, then 2)
  and its LayerNorm, the blocks, with the PEG (``ConditionalPositionEncoding``:
  a residual depthwise 3 x 3 conv) after the first, and for SVT a LayerNorm
  after the stage.
* Global sub-sampled attention (``GSAEncoderLayer``) is MiT's
  ``EfficientMultiheadAttention``, so keys and values stay strided views of
  the fused ``kv`` output and a CUDA tensor runs the flash kernels (PCPVT-S
  at head dim 64, SVT-S at 32).
* Locally grouped attention (``LocallyGroupedSelfAttention``, SVT's even
  blocks): full attention inside ``ws x ws`` groups of the map, padded at
  the bottom and right to a multiple of ``ws``; where there is padding a
  pair of a padded and a real position gets -1000 on its score.  As in the
  JAX module's einsums, the scores are float32 and no flash kernel is used:
  ``ops/attention.biased_attention`` with the ``(G, P, P)`` mask.
* ``TwinsFFN``: ``Linear``, exact GELU, ``Linear`` (no conv).

Submodules carry the JAX names: ``embed<i>_conv``, ``embed<i>_norm``,
``stage<i>_block<j>`` (``norm1``, ``attn``, ``norm2``, ``ffn.fc1``,
``ffn.fc2``), ``peg<i>.proj`` and ``norm_after<i>``.  Init
(``init_weights``): truncated normal (std 0.02) for every linear weight
(the attention's pointwise projections too), zero biases.
``frozen_stages`` and ``with_cp`` are not ported yet and raise.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import BACKBONE
from ...ops.attention import biased_attention
from ..basic.convolution import Conv2d, Linear
from ..basic.drop import Dropout, DropPath
from ..basic.normalization import LayerNorm
from .mit import EfficientMultiheadAttention, map_to_tokens, tokens_to_map

ARCH_TABLE = {
    # (embed_dims, depths, num_heads, mlp_ratios, sr_ratios, wss)
    "pcpvt-small": dict(dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
                        heads=(1, 2, 5, 8), mlps=(8, 8, 4, 4),
                        srs=(8, 4, 2, 1), wss=None),
    "pcpvt-base": dict(dims=(64, 128, 320, 512), depths=(3, 4, 18, 3),
                       heads=(1, 2, 5, 8), mlps=(8, 8, 4, 4),
                       srs=(8, 4, 2, 1), wss=None),
    "pcpvt-large": dict(dims=(64, 128, 320, 512), depths=(3, 8, 27, 3),
                        heads=(1, 2, 5, 8), mlps=(8, 8, 4, 4),
                        srs=(8, 4, 2, 1), wss=None),
    "svt-small": dict(dims=(64, 128, 256, 512), depths=(2, 2, 10, 4),
                      heads=(2, 4, 8, 16), mlps=(4, 4, 4, 4),
                      srs=(8, 4, 2, 1), wss=(7, 7, 7, 7)),
    "svt-base": dict(dims=(96, 192, 384, 768), depths=(2, 2, 18, 2),
                     heads=(3, 6, 12, 24), mlps=(4, 4, 4, 4),
                     srs=(8, 4, 2, 1), wss=(7, 7, 7, 7)),
    "svt-large": dict(dims=(128, 256, 512, 1024), depths=(2, 2, 18, 2),
                      heads=(4, 8, 16, 32), mlps=(4, 4, 4, 4),
                      srs=(8, 4, 2, 1), wss=(7, 7, 7, 7)),
}


class ConditionalPositionEncoding(nn.Module):
    """PEG: a residual depthwise 3 x 3 conv over ``(N, L, C)`` tokens."""

    def __init__(self, embed_dims: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.proj = Conv2d(embed_dims, embed_dims, 3, stride=stride,
                           padding=1, groups=embed_dims)

    def forward(self, x, hw):
        y = map_to_tokens(self.proj(tokens_to_map(x, hw)))
        return y + x if self.stride == 1 else y


class TwinsFFN(nn.Module):
    """``Linear`` -> GELU -> drop -> ``Linear`` -> drop."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 drop_rate: float = 0.0):
        super().__init__()
        self.fc1 = Linear(embed_dims, feedforward_channels)
        self.act = nn.GELU()  # exact, as the JAX module's gelu
        self.drop1 = Dropout(drop_rate)
        self.fc2 = Linear(feedforward_channels, embed_dims)
        self.drop2 = Dropout(drop_rate)

    def forward(self, x):
        return self.drop2(self.fc2(self.drop1(self.act(self.fc1(x)))))


@functools.lru_cache(maxsize=64)
def pad_mask(hp: int, wp: int, pad_b: int, pad_r: int, ws: int,
             device: torch.device) -> torch.Tensor:
    """``(G, P, P)`` float32: -1000 where one position of a pair lies in
    the padding and the other does not, else 0."""
    pad = np.zeros((hp, wp), np.float32)
    pad[hp - pad_b:, :] = 1.0
    pad[:, wp - pad_r:] = 1.0
    pad = pad.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3) \
             .reshape(-1, ws * ws)
    mask = np.where(pad[:, :, None] != pad[:, None, :], -1000.0, 0.0)
    return torch.from_numpy(mask.astype(np.float32)).to(device)


class LocallyGroupedSelfAttention(nn.Module):
    """LSA: full attention inside padded ``ws x ws`` groups (no shift)."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int = 7,
                 qkv_bias: bool = True):
        super().__init__()
        assert embed_dims % num_heads == 0, (embed_dims, num_heads)
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = Linear(embed_dims, 3 * embed_dims, bias=qkv_bias)
        self.proj = Linear(embed_dims, embed_dims)

    def forward(self, x, hw):
        N, L, C = x.shape
        (H, W), ws, h = hw, self.window_size, self.num_heads
        d = C // h
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        xp = F.pad(x.reshape(N, H, W, C), (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        nh, nw = Hp // ws, Wp // ws
        G, P = nh * nw, ws * ws
        groups = xp.view(N, nh, ws, nw, ws, C).transpose(2, 3).reshape(
            N, G, P, C)
        q, k, v = self.qkv(groups).view(N, G, P, 3, h, d).permute(
            3, 0, 1, 4, 2, 5).reshape(3, N * G, h, P, d)
        mask = (pad_mask(Hp, Wp, pad_b, pad_r, ws, x.device)
                if pad_b or pad_r else None)
        out = biased_attention(q, k, v, 1.0 / math.sqrt(d), mask=mask)
        out = out.view(N, nh, nw, h, ws, ws, d).permute(
            0, 1, 4, 2, 5, 3, 6).reshape(N, Hp, Wp, C)[:, :H, :W]
        return self.proj(out.reshape(N, L, C))


class _EncoderLayer(nn.Module):
    """Pre-norm: x += DropPath(attn(LN x)); x += DropPath(FFN(LN x))."""

    def __init__(self, embed_dims, attn, feedforward_channels, drop_rate,
                 drop_path_rate):
        super().__init__()
        self.norm1 = LayerNorm(embed_dims)
        self.attn = attn
        self.drop_path1 = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(embed_dims)
        self.ffn = TwinsFFN(embed_dims, feedforward_channels, drop_rate)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x, hw):
        x = x + self.drop_path1(self.attn(self.norm1(x), hw))
        return x + self.drop_path2(self.ffn(self.norm2(x)))


class GSAEncoderLayer(_EncoderLayer):
    """LN -> global sub-sampled attention -> LN -> FFN."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, sr_ratio: int = 1,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__(embed_dims, EfficientMultiheadAttention(
            embed_dims, num_heads, sr_ratio=sr_ratio, qkv_bias=qkv_bias,
            attn_drop_rate=attn_drop_rate, proj_drop_rate=drop_rate),
            feedforward_channels, drop_rate, drop_path_rate)


class LSAEncoderLayer(_EncoderLayer):
    """LN -> locally grouped attention -> LN -> FFN."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, window_size: int = 7,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__(embed_dims, LocallyGroupedSelfAttention(
            embed_dims, num_heads, window_size, qkv_bias=qkv_bias),
            feedforward_channels, drop_rate, drop_path_rate)


@BACKBONE.register("PCPVT", aliases=("Twins-PCPVT",))
class PCPVT(nn.Module):
    """GSA stages with a PEG after each stage's first block."""

    default_arch = "pcpvt-small"
    default_norm_after_stage = False

    def __init__(self,
                 arch: Optional[str] = None,
                 in_channels: int = 3,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 qkv_bias: bool = True,
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 norm_after_stage: Optional[bool] = None,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        arch = arch or self.default_arch
        if arch not in ARCH_TABLE:
            raise KeyError(f"unknown Twins arch {arch!r}; choose from "
                           f"{sorted(ARCH_TABLE)}")
        unported = dict(frozen_stages=frozen_stages >= 0, with_cp=with_cp)
        if any(unported.values()):
            raise NotImplementedError(
                "not ported yet (ROADMAP.md Queue 1 item 5): "
                + ", ".join(k for k, v in unported.items() if v))
        if norm_after_stage is None:
            norm_after_stage = self.default_norm_after_stage
        table = ARCH_TABLE[arch]
        self.depths = table["depths"]
        self.out_indices = tuple(out_indices)
        self.norm_after_stage = norm_after_stage
        self.kw = dict(qkv_bias=qkv_bias, drop_rate=drop_rate,
                       attn_drop_rate=attn_drop_rate)
        total = sum(self.depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur, in_ch = 0, in_channels
        for i, (dim, depth) in enumerate(zip(table["dims"], self.depths)):
            ps = 4 if i == 0 else 2
            self.add_module(f"embed{i}_conv",
                            Conv2d(in_ch, dim, ps, stride=ps))
            self.add_module(f"embed{i}_norm", LayerNorm(dim))
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}",
                                self._block(i, j, table, rates[cur + j]))
            self.add_module(f"peg{i}", ConditionalPositionEncoding(dim))
            if norm_after_stage:
                self.add_module(f"norm_after{i}", LayerNorm(dim))
            cur += depth
            in_ch = dim
        self.pos_drop = Dropout(drop_rate)

    def _block(self, stage, j, table, drop_path_rate):
        dims = table["dims"][stage]
        return GSAEncoderLayer(
            dims, table["heads"][stage], table["mlps"][stage] * dims,
            sr_ratio=table["srs"][stage], drop_path_rate=drop_path_rate,
            **self.kw)

    def init_weights(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x):
        outs = []
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"embed{i}_conv")(x)
            hw = tuple(x.shape[2:])
            x = self.pos_drop(getattr(self, f"embed{i}_norm")(
                map_to_tokens(x)))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x, hw)
                if j == 0:
                    x = getattr(self, f"peg{i}")(x, hw)
            if self.norm_after_stage:
                x = getattr(self, f"norm_after{i}")(x)
            x = tokens_to_map(x, hw).contiguous()
            if i in self.out_indices:
                outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)


@BACKBONE.register("SVT", aliases=("Twins-SVT",))
class SVT(PCPVT):
    """Even blocks locally grouped (LSA), odd blocks global (GSA); a
    LayerNorm after each stage."""

    default_arch = "svt-small"
    default_norm_after_stage = True

    def _block(self, stage, j, table, drop_path_rate):
        if j % 2:
            return super()._block(stage, j, table, drop_path_rate)
        dims = table["dims"][stage]
        return LSAEncoderLayer(
            dims, table["heads"][stage], table["mlps"][stage] * dims,
            window_size=table["wss"][stage], qkv_bias=self.kw["qkv_bias"],
            drop_rate=self.kw["drop_rate"], drop_path_rate=drop_path_rate)
