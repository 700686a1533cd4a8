"""Swin Transformer backbone (counterpart of ``models/backbones/swin.py``).

* Inside the backbone the maps are channels-last ``(N, H, W, C)`` tensors
  (LayerNorms and projections act on the last axis, as in the JAX
  module); each stage output is returned as a contiguous NCHW map.
* Window attention: the map is padded to the window grid first, then
  rolled by ``-shift`` (the odd blocks of a stage), cut into ``ws x ws``
  windows by a reshape, and attends inside each window through
  ``ops/attention.py``'s ``biased_attention`` (float32 scores and softmax,
  as the JAX einsums): the relative-position bias is the block's table
  gathered by a fixed ``(ws², ws²)`` index, and the additive mask keeps
  tokens of different shifted regions, and padding, apart.  A map no
  larger than one window is not shifted.  The index and each geometry's
  mask are built once (numpy, the JAX package's rules) and kept on the
  device.
* ``PatchMerging``: odd sizes padded, the 2 x 2 neighbours concatenated in
  torch's order ``[(0, 0), (1, 0), (0, 1), (1, 1)]``, LayerNorm, a linear
  map 4C -> 2C without bias.

Submodules carry the JAX names: ``patch_embed_proj``, ``patch_embed_norm``,
``stage<i>_block<j>``, ``downsample<i>`` and ``norm<i>``.  Init
(``init_weights``): truncated normal (std 0.02) for every linear weight,
the patch embedding and the bias tables; zero biases.  ``frozen_stages``
and ``with_cp`` are not ported yet and raise.

Arch table: tiny = depths (2, 2, 6, 2), dims 96, heads (3, 6, 12, 24);
small = (2, 2, 18, 2), 96; base = (2, 2, 18, 2), 128, (4, 8, 16, 32);
large = (2, 2, 18, 2), 192, (6, 12, 24, 48).  Window 7, MLP ratio 4.
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

ARCH_TABLE = {
    "tiny": dict(depths=(2, 2, 6, 2), embed_dims=96,
                 num_heads=(3, 6, 12, 24)),
    "small": dict(depths=(2, 2, 18, 2), embed_dims=96,
                  num_heads=(3, 6, 12, 24)),
    "base": dict(depths=(2, 2, 18, 2), embed_dims=128,
                 num_heads=(4, 8, 16, 32)),
    "large": dict(depths=(2, 2, 18, 2), embed_dims=192,
                  num_heads=(6, 12, 24, 48)),
}


def unported(**features):
    """Raise on the backbone options the port does not have yet."""
    if any(features.values()):
        raise NotImplementedError(
            "not ported yet (ROADMAP.md Queue 1 item 5): "
            + ", ".join(k for k, v in features.items() if v))


def relative_position_index(ws: int) -> np.ndarray:
    """``(ws², ws²)`` index into the ``(2ws-1)²``-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_attention_mask(hp: int, wp: int, ws: int, shift: int,
                         h_real: int, w_real: int) -> np.ndarray:
    """``(nW, ws², ws²)`` additive mask: -100 where two tokens of a window
    come from different shifted regions or either is padding."""
    def groups(n):
        g = np.zeros(n, np.int64)
        if shift:
            g[:shift] = 2
            g[n - ws + shift:] = 1
        return g

    region = groups(hp)[:, None] * 3 + groups(wp)[None, :]
    pad_region = region.max() + 1
    region[h_real:, :] = pad_region
    region[:, w_real:] = pad_region
    if shift:
        region = np.roll(region, (-shift, -shift), axis=(0, 1))
    win = region.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    same = win[:, :, None] == win[:, None, :]
    return np.where(same, 0.0, -100.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _index(ws: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(ws)).to(device)


@functools.lru_cache(maxsize=64)
def _mask(hp: int, wp: int, ws: int, shift: int, h: int, w: int,
          device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shift_attention_mask(hp, wp, ws, shift, h,
                                                 w)).to(device)


class WindowMSA(nn.Module):
    """Multi-head self-attention within windows ``(B, ws², C)`` with the
    relative-position bias and an optional ``(nW, ws², ws²)`` mask."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, attn_drop_rate: float = 0.0,
                 proj_drop_rate: float = 0.0):
        super().__init__()
        C, ws = embed_dims, window_size
        self.num_heads, self.window_size = num_heads, ws
        self.qkv = Linear(C, 3 * C, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.attn_drop = Dropout(attn_drop_rate)
        self.proj = Linear(C, C)
        self.proj_drop = Dropout(proj_drop_rate)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        B, L, C = x.shape
        h = self.num_heads
        d = C // h
        q, k, v = self.qkv(x).reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4)
        index = _index(self.window_size, x.device)
        bias = self.relative_position_bias_table[index].permute(2, 0, 1)
        out = biased_attention(
            q, k, v, 1.0 / math.sqrt(d), bias, mask,
            self.attn_drop if self.attn_drop.p > 0.0 else None)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(B, L,
                                                                    C)))


class SwinBlock(nn.Module):
    """Pre-norm: x += DropPath(W-MSA(LN x)); x += DropPath(FFN(LN x)) on an
    ``(N, H, W, C)`` map; ``shift`` is 0 or ws // 2."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: int = 4, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        C = embed_dims
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(C)
        self.attn = WindowMSA(C, num_heads, window_size, qkv_bias=qkv_bias,
                              attn_drop_rate=attn_drop_rate,
                              proj_drop_rate=drop_rate)
        self.drop_path1 = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(C)
        self.fc1 = Linear(C, mlp_ratio * C)
        self.act = nn.GELU()  # exact, as the JAX block's gelu
        self.drop1 = Dropout(drop_rate)
        self.fc2 = Linear(mlp_ratio * C, C)
        self.drop2 = Dropout(drop_rate)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x):
        N, H, W, C = x.shape
        ws = self.window_size
        shift = self.shift if min(H, W) > ws else 0
        hp, wp = -(-H // ws) * ws, -(-W // ws) * ws
        y = self.norm1(x)
        # pad to the window grid first, then roll the padded map: the mask
        # models the roll modulo (hp, wp)
        if (hp, wp) != (H, W):
            y = F.pad(y, (0, 0, 0, wp - W, 0, hp - H))
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = (_mask(hp, wp, ws, shift, H, W, x.device)
                if shift or (hp, wp) != (H, W) else None)
        nh, nw = hp // ws, wp // ws
        y = y.reshape(N, nh, ws, nw, ws, C).transpose(2, 3).reshape(
            N * nh * nw, ws * ws, C)
        y = self.attn(y, mask)
        y = y.reshape(N, nh, nw, ws, ws, C).transpose(2, 3).reshape(N, hp, wp,
                                                                 C)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path1(y[:, :H, :W])
        y = self.drop1(self.act(self.fc1(self.norm2(x))))
        return x + self.drop_path2(self.drop2(self.fc2(y)))


class PatchMerging(nn.Module):
    """2 x 2 neighbourhood concat (4C) -> LN -> Linear(4C -> 2C, no bias)."""

    def __init__(self, in_dims: int):
        super().__init__()
        self.norm = LayerNorm(4 * in_dims)
        self.reduction = Linear(4 * in_dims, 2 * in_dims, bias=False)

    def forward(self, x):
        N, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = x.shape[1:3]
        x = x.reshape(N, H // 2, 2, W // 2, 2, C)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


@BACKBONE.register("SwinTransformer", aliases=("Swin",))
class SwinTransformer(nn.Module):

    def __init__(self,
                 arch: str = "tiny",
                 in_channels: int = 3,
                 depths: Optional[Sequence[int]] = None,
                 embed_dims: Optional[int] = None,
                 num_heads: Optional[Sequence[int]] = None,
                 window_size: int = 7,
                 patch_size: int = 4,
                 mlp_ratio: int = 4,
                 qkv_bias: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        unported(frozen_stages=frozen_stages >= 0, with_cp=with_cp)
        if arch not in ARCH_TABLE and None in (depths, embed_dims,
                                               num_heads):
            raise KeyError(f"unknown Swin arch {arch!r}; choose from "
                           f"{sorted(ARCH_TABLE)} or pass "
                           "depths+embed_dims+num_heads")
        table = ARCH_TABLE.get(arch, {})
        depths = tuple(depths or table["depths"])
        heads = tuple(num_heads or table["num_heads"])
        dims0 = embed_dims or table["embed_dims"]
        assert len(depths) == len(heads)
        assert max(out_indices) < len(depths)
        self.depths = depths
        self.out_indices = tuple(out_indices)
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.patch_embed_proj = Conv2d(in_channels, dims0, patch_size,
                                       stride=patch_size)
        self.patch_embed_norm = LayerNorm(dims0)
        self.pos_drop = Dropout(drop_rate)
        cur = 0
        for i, depth in enumerate(depths):
            dim = dims0 * 2 ** i
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dim, heads[i], window_size=window_size,
                    shift=0 if j % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                    drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                    drop_path_rate=rates[cur + j]))
            if i in self.out_indices:
                self.add_module(f"norm{i}", LayerNorm(dim))
            if i < len(depths) - 1:
                self.add_module(f"downsample{i}", PatchMerging(dim))
            cur += depth

    def init_weights(self, generator):
        """Truncated normal (std 0.02) for the linear weights, the patch
        embedding and the bias tables; zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Linear) or m is self.patch_embed_proj:
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, WindowMSA):
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=0.02, generator=generator)

    def forward(self, x):
        x = self.patch_embed_proj(x).permute(0, 2, 3, 1)
        x = self.pos_drop(self.patch_embed_norm(x))
        outs = []
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x).permute(
                    0, 3, 1, 2).contiguous())
            if i < len(self.depths) - 1:
                x = getattr(self, f"downsample{i}")(x)
        return outs[0] if len(outs) == 1 else tuple(outs)
