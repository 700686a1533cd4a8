"""Dropout layers (counterpart of ``models/basic/drop.py``).

``Dropout2d`` zeroes whole channels in training and is the identity in
eval mode, as the JAX ``Dropout2d`` is without ``train=True``.
"""

from torch import nn

from ...core.registry_hub import DROPOUT

Dropout2d = DROPOUT.register("Dropout2d")(nn.Dropout2d)
