"""Normalization layers (counterpart of ``models/basic/normalization.py``).

On one card ``SyncBatchNorm`` is ``nn.BatchNorm2d`` (eps 1e-5, momentum
0.1, as the JAX ``_BatchNorm``); the ``BN``/``SyncBN`` config aliases are
registered as in the JAX package.
"""

from torch import nn

from ...core.registry_hub import NORMALIZATION

BatchNorm2d = NORMALIZATION.register(
    "BatchNorm2d",
    aliases=("BatchNorm", "BN", "SyncBatchNorm", "SyncBN"))(nn.BatchNorm2d)
