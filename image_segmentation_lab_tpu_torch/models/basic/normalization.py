"""Normalization layers (counterpart of ``models/basic/normalization.py``).

On one card ``SyncBatchNorm`` is ``nn.BatchNorm2d`` (eps 1e-5, momentum
0.1, as the JAX ``_BatchNorm``); the ``BN``/``SyncBN`` config aliases are
registered as in the JAX package.  ``LayerNorm`` (alias ``LN``) normalises
over the trailing dims in float32 and casts back, with the JAX package's
eps of 1e-5 (upstream MMSeg's ViT uses 1e-6; the JAX package is the
reference).
"""

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
