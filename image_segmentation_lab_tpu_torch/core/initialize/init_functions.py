"""Default weight initialisation from an explicit ``torch.Generator``.

The same distributions as the JAX package's defaults: kaiming-normal
(fan_out, relu) conv weights with zero biases, unit/zero batch norms with
fresh running statistics, then each module's own ``init_weights(generator)``
hook (a decode head's normal(0, 0.01) classifier, a ResNet block's
zero-initialised residual norm).  The numbers differ from JAX's, whose
random bits torch cannot reproduce.
"""

from __future__ import annotations

import torch
from torch import nn


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
        for m in model.modules():
            hook = getattr(m, "init_weights", None)
            if hook is not None:
                hook(generator)
