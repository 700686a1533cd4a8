"""BEiT backbone (counterpart of ``models/backbones/beit.py``).

A ViT without an absolute position table: positions enter each layer's
attention as a relative-position bias.

* ``BEiTAttention``: a qkv projection without bias, plus the ``q_bias`` and
  ``v_bias`` vectors (none on k); the bias table holds ``(2g-1)²`` rows of
  grid offsets at the pretraining grid ``g = pretrain_img_size //
  patch_size`` and three rows for cls -> token, token -> cls and cls ->
  cls.  At another grid (40 x 40 at 640²) the ``(2g-1)²`` field is
  resampled bicubically on every forward (``utils/ops.resize_bicubic``,
  two matrix products, so its backward is deterministic), the three cls
  rows kept; a fixed ``(L+1, L+1)`` index gathers the bias, which is added
  to the float32 scores (``ops/attention.py``'s ``biased_attention``).
  Each grid's index is built once and kept on the device.
* ``BEiTBlock``: pre-norm with layer scale, ``x += DropPath(gamma_1 ·
  attn(LN x))``, ``x += DropPath(gamma_2 · MLP(LN x))``.
* The tapped ``out_indices`` are returned as NCHW maps of the patch grid
  (without the cls token).

Submodules carry the JAX names: ``patch_embed_proj``, ``cls_token``,
``block<i>`` and, with ``final_norm``, ``norm1``.  Init
(``init_weights``): truncated normal (std 0.02) for the patch embedding and
every linear weight, each block's ``attn.proj`` and ``fc2`` weights divided
by its ``init_rescale`` (MAE's ``fix_init_weight``; 1 in BEiT), zero
biases, ``q_bias``, ``v_bias``, tables and class token, the layer scales
at ``layer_scale_init_value``.  ``frozen_stages`` and ``with_cp`` are not
ported yet and raise.

Arch table: base = 768 dims, 12 layers, 12 heads; large = 1024/24/16.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...core.registry_hub import BACKBONE
from ...ops.attention import biased_attention
from ...utils.ops import resize_bicubic
from ..basic.convolution import Conv2d, Linear
from ..basic.drop import DropPath
from ..basic.normalization import LayerNorm
from .swin import unported

ARCH_TABLE = {
    "base": dict(embed_dims=768, num_layers=12, num_heads=12),
    "large": dict(embed_dims=1024, num_layers=24, num_heads=16),
}


def relative_position_index(gh: int, gw: int) -> np.ndarray:
    """``(L+1, L+1)`` index into a ``((2gh-1)(2gw-1) + 3)``-row table, the
    cls token first; the last three rows are cls -> token, token -> cls
    and cls -> cls."""
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw),
                                  indexing="ij"), 0).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[..., 0] += gh - 1
    rel[..., 1] += gw - 1
    rel[..., 0] *= 2 * gw - 1
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    L = gh * gw
    index = np.zeros((L + 1, L + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 1:] = num_rel
    index[1:, 0] = num_rel + 1
    index[0, 0] = num_rel + 2
    return index


@functools.lru_cache(maxsize=64)
def _index(gh: int, gw: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(gh, gw)).to(device)


class BEiTAttention(nn.Module):
    """Self-attention with q/v-only bias and the relative-position bias
    over ``(N, L+1, C)`` tokens of a square patch grid, cls first."""

    def __init__(self, embed_dims: int, num_heads: int, pretrain_grid: int,
                 qv_bias: bool = True):
        super().__init__()
        C, g = embed_dims, pretrain_grid
        self.num_heads, self.pretrain_grid = num_heads, g
        self.qkv = Linear(C, 3 * C, bias=False)
        if qv_bias:
            self.q_bias = nn.Parameter(torch.zeros(C))
            self.v_bias = nn.Parameter(torch.zeros(C))
        self.qv_bias = qv_bias
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * g - 1) ** 2 + 3, num_heads))
        self.proj = Linear(C, C)

    def relative_bias(self, gh: int, gw: int,
                      device: torch.device) -> torch.Tensor:
        """``(h, L+1, L+1)``: the table at the ``(gh, gw)`` grid, gathered."""
        table = self.relative_position_bias_table
        g0, h = self.pretrain_grid, self.num_heads
        if (gh, gw) != (g0, g0):
            n0 = (2 * g0 - 1) ** 2
            field = table[:n0].T.reshape(1, h, 2 * g0 - 1, 2 * g0 - 1)
            field = resize_bicubic(field, (2 * gh - 1, 2 * gw - 1))
            table = torch.cat([field.reshape(h, -1).T,
                               table[n0:].to(field.dtype)])
        return table[_index(gh, gw, device)].permute(2, 0, 1)

    def forward(self, x):
        N, L1, C = x.shape
        h = self.num_heads
        d = C // h
        g = math.isqrt(L1 - 1)
        assert g * g == L1 - 1, f"BEiT needs a square grid, got {L1 - 1}"
        qkv = self.qkv(x)
        if self.qv_bias:
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(qkv.dtype)
        q, k, v = qkv.reshape(N, L1, 3, h, d).permute(2, 0, 3, 1, 4)
        out = biased_attention(q, k, v, 1.0 / math.sqrt(d),
                               self.relative_bias(g, g, x.device))
        return self.proj(out.transpose(1, 2).reshape(N, L1, C))


class BEiTBlock(nn.Module):
    """x += DropPath(g1·attn(LN x)); x += DropPath(g2·MLP(LN x)), with the
    layer scales ``gamma_1`` and ``gamma_2`` as g1 and g2."""

    def __init__(self, embed_dims: int, num_heads: int, pretrain_grid: int,
                 mlp_ratio: int = 4, qv_bias: bool = True,
                 drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 0.1,
                 init_rescale: float = 1.0):
        super().__init__()
        C = embed_dims
        self.layer_scale_init_value = layer_scale_init_value
        self.init_rescale = init_rescale
        self.gamma_1 = nn.Parameter(torch.full((C,),
                                               float(layer_scale_init_value)))
        self.gamma_2 = nn.Parameter(torch.full((C,),
                                               float(layer_scale_init_value)))
        self.norm1 = LayerNorm(C)
        self.attn = BEiTAttention(C, num_heads, pretrain_grid, qv_bias)
        self.drop_path1 = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(C)
        self.fc1 = Linear(C, mlp_ratio * C)
        self.act = nn.GELU()  # exact, as the JAX block's gelu
        self.fc2 = Linear(mlp_ratio * C, C)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x):
        x = x + self.drop_path1(self.gamma_1 * self.attn(self.norm1(x)))
        y = self.fc2(self.act(self.fc1(self.norm2(x))))
        return x + self.drop_path2(self.gamma_2 * y)


@BACKBONE.register()
class BEiT(nn.Module):

    def __init__(self,
                 arch: str = "base",
                 in_channels: int = 3,
                 embed_dims: Optional[int] = None,
                 num_layers: Optional[int] = None,
                 num_heads: Optional[int] = None,
                 patch_size: int = 16,
                 pretrain_img_size: int = 224,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 mlp_ratio: int = 4,
                 qv_bias: bool = True,
                 drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 0.1,
                 final_norm: bool = False,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        unported(frozen_stages=frozen_stages >= 0, with_cp=with_cp)
        kind = type(self).__name__
        if arch not in ARCH_TABLE and None in (embed_dims, num_layers,
                                               num_heads):
            raise KeyError(f"unknown {kind} arch {arch!r}; choose from "
                           f"{sorted(ARCH_TABLE)} or pass "
                           "embed_dims+num_layers+num_heads")
        table = ARCH_TABLE.get(arch, {})
        dims = embed_dims or table["embed_dims"]
        depth = num_layers or table["num_layers"]
        heads = num_heads or table["num_heads"]
        self.dims, self.depth = dims, depth
        self.out_ids = tuple(i % depth for i in out_indices)
        self.grid = pretrain_img_size // patch_size
        self.final_norm = final_norm
        self.patch_embed_proj = Conv2d(in_channels, dims, patch_size,
                                       stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dims))
        for i in range(depth):
            self.add_module(f"block{i}", BEiTBlock(
                dims, heads, self.grid, mlp_ratio=mlp_ratio, qv_bias=qv_bias,
                drop_path_rate=drop_path_rate * i / max(depth - 1, 1),
                layer_scale_init_value=layer_scale_init_value))
        if final_norm:
            self.norm1 = LayerNorm(dims)

    def init_weights(self, generator):
        """The JAX defaults (module docstring)."""
        for w in (self.patch_embed_proj.weight,
                  *(m.weight for m in self.modules()
                    if isinstance(m, nn.Linear))):
            nn.init.trunc_normal_(w, std=0.02, generator=generator)
        for name, p in self.named_parameters():
            if name.endswith(("bias", "cls_token", "bias_table")):
                nn.init.zeros_(p)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            with torch.no_grad():
                for w in (block.attn.proj.weight, block.fc2.weight):
                    w.div_(block.init_rescale)
            for g in (block.gamma_1, block.gamma_2):
                nn.init.constant_(g, block.layer_scale_init_value)

    def embed(self, x):
        """Patch tokens with the class token in front, and the grid."""
        N = x.shape[0]
        x = self.patch_embed_proj(x)
        grid = tuple(x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        return torch.cat([self.cls_token.to(x.dtype).expand(N, -1, -1), x],
                         dim=1), grid

    def forward(self, x):
        N = x.shape[0]
        x, (gh, gw) = self.embed(x)
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
            if i == self.depth - 1 and self.final_norm:
                x = self.norm1(x)
            if i in self.out_ids:
                outs.append(x[:, 1:].reshape(N, gh, gw, self.dims)
                            .permute(0, 3, 1, 2))
        return outs[0] if len(outs) == 1 else tuple(outs)
