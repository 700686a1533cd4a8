"""Activation layers (counterpart of ``models/basic/activations.py``)."""

from torch import nn

from ...core.registry_hub import ACTIVATION

ReLU = ACTIVATION.register("ReLU")(nn.ReLU)
