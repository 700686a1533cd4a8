"""MAE backbone (counterpart of ``models/backbones/mae.py``): MAE's
fine-tuning encoder is the BEiT encoder (``beit.py``) with three changes:

* a learned absolute position table ``pos_embed`` of shape ``(1, g² + 1,
  C)`` at the pretraining grid ``g``, added after the class token is put
  in front; at another grid its patch part is resampled bicubically
  (``utils/ops.resize_bicubic``) on every forward, the class row kept;
* layer scale initialised to 1.0 (BEiT: 0.1);
* the depth-rescaled init (``fix_init``, upstream ``fix_init_weight``):
  block ``i`` (from 0) divides its ``attn.proj`` and ``fc2`` weights by
  ``sqrt(2 (i + 1))``.

Init (``init_weights``): BEiT's, and truncated normal (std 0.02) for
``pos_embed``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ...core.registry_hub import BACKBONE
from ...utils.ops import resize_bicubic
from .beit import BEiT


@BACKBONE.register()
class MAE(BEiT):

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
                 layer_scale_init_value: float = 1.0,
                 final_norm: bool = False,
                 fix_init: bool = True,
                 frozen_stages: int = -1,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__(
            arch=arch, in_channels=in_channels, embed_dims=embed_dims,
            num_layers=num_layers, num_heads=num_heads,
            patch_size=patch_size, pretrain_img_size=pretrain_img_size,
            out_indices=out_indices, mlp_ratio=mlp_ratio, qv_bias=qv_bias,
            drop_path_rate=drop_path_rate,
            layer_scale_init_value=layer_scale_init_value,
            final_norm=final_norm, frozen_stages=frozen_stages,
            with_cp=with_cp)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid * self.grid + 1, self.dims))
        if fix_init:
            for i in range(self.depth):
                getattr(self, f"block{i}").init_rescale = math.sqrt(
                    2.0 * (i + 1))

    def init_weights(self, generator):
        super().init_weights(generator)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)

    def _resized_pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """The position table at the ``(gh, gw)`` patch grid."""
        pos = self.pos_embed
        if (gh, gw) == (self.grid, self.grid):
            return pos
        maps = pos[:, 1:].reshape(1, self.grid, self.grid, self.dims)
        maps = resize_bicubic(maps.permute(0, 3, 1, 2), (gh, gw))
        maps = maps.permute(0, 2, 3, 1).reshape(1, gh * gw, self.dims)
        return torch.cat([pos[:, :1], maps], dim=1)

    def embed(self, x):
        x, grid = super().embed(x)
        return x + self._resized_pos_embed(*grid).to(x.dtype), grid
