"""Normalization layers (counterpart of ``models/basic/normalization.py``).

On one card ``SyncBatchNorm`` is ``nn.BatchNorm2d`` (eps 1e-5, momentum
0.1, as the JAX ``_BatchNorm``); the ``BN``/``SyncBN`` config aliases are
registered as in the JAX package.  ``LayerNorm`` (alias ``LN``) normalises
over the trailing dims in float32 and casts back, with the JAX package's
eps of 1e-5 (upstream MMSeg's ViT uses 1e-6; the JAX package is the
reference); ``LayerNorm2d`` is the same over the channels of an NCHW
map.  ``GroupNorm`` (alias ``GN``) does the same per group of
channels of an NCHW map: float32 statistics and affine, cast back to the
input's dtype, also under autocast (where ``nn.GroupNorm`` would return
float32); a float64 input stays float64.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import NORMALIZATION

BatchNorm2d = NORMALIZATION.register(
    "BatchNorm2d",
    aliases=("BatchNorm", "BN", "SyncBatchNorm", "SyncBN"))(nn.BatchNorm2d)


@NORMALIZATION.register("LayerNorm", aliases=("LN",))
class LayerNorm(nn.LayerNorm):

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


@NORMALIZATION.register("LayerNorm2d")
class LayerNorm2d(LayerNorm):
    """``LayerNorm`` over the channels of an NCHW map (the JAX package's
    ``LayerNorm2d``, a LayerNorm over C of its NHWC map)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


@NORMALIZATION.register("GroupNorm", aliases=("GN",))
class GroupNorm(nn.GroupNorm):

    def forward(self, x):
        acc = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            return F.group_norm(x.to(acc), self.num_groups, self.weight,
                                self.bias, self.eps).to(x.dtype)
