"""Vision Transformer backbone, the SETR encoder (counterpart of
``models/backbones/vit.py``).

* Tokens keep an ``(N, L, C)`` layout between blocks; the tapped
  ``out_indices`` are returned as NCHW maps (one map, or a tuple).
* Every attention call goes through ``ops/attention.py``: the flash kernel
  on a CUDA tensor, reading q, k and v in place from the qkv projection.
  Attention-probability dropout in training keeps a materialised score
  tensor, as in the JAX module.
* The learned position table lives at the pretraining grid
  (``pretrain_img_size // patch_size``) and is resized to the input's patch
  grid with bicubic (or bilinear) interpolation at call time.
* Submodules carry the JAX names: ``patch_embed_proj``, ``cls_token``,
  ``pos_embed``, ``block0`` ... ``block<depth-1>`` and, with
  ``final_norm``, ``norm1``.

Arch table (ViT paper Table 1 + DeiT-Ti/S): tiny = 192 dims, 12 layers,
3 heads; small = 384/12/6; base = 768/12/12; large = 1024/24/16.  The MoE
FFN (``num_experts >= 2``), ``with_cp``, ``output_cls_token`` and
``frozen_stages`` are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ...core.registry_hub import BACKBONE
from ...ops.attention import multihead_attention
from ...utils.ops import resize
from ..basic.convolution import Conv2d, Linear
from ..basic.drop import Dropout, DropPath
from ..basic.normalization import LayerNorm

ARCH_TABLE = {
    "tiny": dict(embed_dims=192, num_layers=12, num_heads=3),
    "small": dict(embed_dims=384, num_layers=12, num_heads=6),
    "base": dict(embed_dims=768, num_layers=12, num_heads=12),
    "large": dict(embed_dims=1024, num_layers=24, num_heads=16),
}


class MultiheadAttention(nn.Module):
    """Full self-attention over the token sequence."""

    def __init__(self, embed_dims: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0):
        super().__init__()
        assert embed_dims % num_heads == 0, (embed_dims, num_heads)
        self.num_heads = num_heads
        self.qkv = Linear(embed_dims, 3 * embed_dims, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop_rate)
        self.proj = Linear(embed_dims, embed_dims)
        self.proj_drop = Dropout(proj_drop_rate)

    def forward(self, x):
        N, L, C = x.shape
        h = self.num_heads
        d = C // h
        scale = 1.0 / math.sqrt(d)
        q, k, v = (t.unflatten(-1, (h, d))
                   for t in self.qkv(x).split(C, dim=-1))
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


class ViTBlock(nn.Module):
    """Pre-norm: x += DropPath(MHSA(LN x)); x += DropPath(MLP(LN x))."""

    def __init__(self, embed_dims: int, num_heads: int, mlp_ratio: int = 4,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        C = embed_dims
        self.norm1 = LayerNorm(C)
        self.attn = MultiheadAttention(C, num_heads, qkv_bias=qkv_bias,
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
        x = x + self.drop_path1(self.attn(self.norm1(x)))
        y = self.drop1(self.act(self.fc1(self.norm2(x))))
        return x + self.drop_path2(self.drop2(self.fc2(y)))


@BACKBONE.register("VisionTransformer", aliases=("ViT",))
class VisionTransformer(nn.Module):

    def __init__(self,
                 arch: str = "base",
                 in_channels: int = 3,
                 embed_dims: Optional[int] = None,
                 num_layers: Optional[int] = None,
                 num_heads: Optional[int] = None,
                 patch_size: int = 16,
                 pretrain_img_size: int = 224,
                 with_cls_token: bool = True,
                 out_indices: Sequence[int] = (-1,),
                 output_cls_token: bool = False,
                 final_norm: bool = False,
                 interpolate_mode: str = "bicubic",
                 mlp_ratio: int = 4,
                 qkv_bias: bool = True,
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None,
                 num_experts: int = 0,
                 moe_layers: Optional[Sequence[int]] = None,
                 moe_capacity_factor: float = 1.25,
                 moe_aux_loss_weight: float = 0.01):
        super().__init__()
        unported = dict(num_experts=num_experts >= 2, with_cp=with_cp,
                        output_cls_token=output_cls_token,
                        frozen_stages=frozen_stages >= 0)
        if any(unported.values()):
            raise NotImplementedError(
                "not ported yet: "
                + ", ".join(k for k, v in unported.items() if v))
        if arch not in ARCH_TABLE and None in (embed_dims, num_layers,
                                               num_heads):
            raise KeyError(f"unknown ViT arch {arch!r}; choose from "
                           f"{sorted(ARCH_TABLE)} or pass "
                           "embed_dims+num_layers+num_heads")
        if interpolate_mode not in ("bicubic", "bilinear"):
            raise ValueError(f"interpolate_mode must be bicubic|bilinear, "
                             f"got {interpolate_mode!r}")
        table = ARCH_TABLE.get(arch, {})
        dims = embed_dims or table["embed_dims"]
        depth = num_layers or table["num_layers"]
        heads = num_heads or table["num_heads"]
        self.dims, self.depth = dims, depth
        self.out_ids = tuple(i % depth for i in out_indices)
        self.grid = pretrain_img_size // patch_size
        self.with_cls_token = with_cls_token
        self.final_norm = final_norm
        self.interpolate_mode = interpolate_mode

        self.patch_embed_proj = Conv2d(in_channels, dims, patch_size,
                                       stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dims))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid * self.grid + 1, dims))
        self.pos_drop = Dropout(drop_rate)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(
                dims, heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                drop_path_rate=drop_path_rate * i / max(depth - 1, 1)))
        if final_norm:
            self.norm1 = LayerNorm(dims)

    def init_weights(self, generator):
        """The JAX defaults: truncated normal (std 0.02) for the patch
        embedding, the position table and every linear weight; zero biases
        and class token."""
        for w in (self.patch_embed_proj.weight, self.pos_embed,
                  *(m.weight for m in self.modules()
                    if isinstance(m, nn.Linear))):
            nn.init.trunc_normal_(w, std=0.02, generator=generator)
        for b in (self.patch_embed_proj.bias, self.cls_token,
                  *(m.bias for m in self.modules()
                    if isinstance(m, nn.Linear) and m.bias is not None)):
            nn.init.zeros_(b)

    def _resized_pos_embed(self, gh: int, gw: int):
        """The position table adapted to the (gh, gw) patch grid."""
        pos = self.pos_embed
        if (gh, gw) == (self.grid, self.grid):
            return pos
        maps = pos[:, 1:].reshape(1, self.grid, self.grid, self.dims)
        maps = resize(maps.permute(0, 3, 1, 2).float(), (gh, gw),
                      mode=self.interpolate_mode, align_corners=False)
        maps = maps.permute(0, 2, 3, 1).reshape(1, gh * gw, self.dims)
        return torch.cat([pos[:, :1], maps.to(pos.dtype)], dim=1)

    def forward(self, x):
        N = x.shape[0]
        x = self.patch_embed_proj(x)                  # (N, C, gh, gw)
        gh, gw = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)              # (N, gh*gw, C)
        x = torch.cat([self.cls_token.to(x.dtype).expand(N, -1, -1), x],
                      dim=1)
        x = x + self._resized_pos_embed(gh, gw).to(x.dtype)
        lead = 1 if self.with_cls_token else 0
        x = self.pos_drop(x[:, 1 - lead:])

        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
            if i == self.depth - 1 and self.final_norm:
                x = self.norm1(x)
            if i in self.out_ids:
                outs.append(x[:, lead:].reshape(N, gh, gw, self.dims)
                            .permute(0, 3, 1, 2))
        return outs[0] if len(outs) == 1 else tuple(outs)
