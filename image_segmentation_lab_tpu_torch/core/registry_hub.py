"""The port's registries, one instance each, created in one place.

Only the registries the inference slice fills exist so far; the others
(datasets, losses, optimizers, ...) arrive with the modules that fill them.
"""

from ..registry import Register

ACTIVATION = Register("activation")
CONVOLUTION = Register("convolution")
DROPOUT = Register("dropout")
NORMALIZATION = Register("normalization")
BACKBONE = Register("backbone")
NECK = Register("neck")
DECODEHEAD = Register("decodehead")
SEGMENTOR = Register("segmentor")

__all__ = ["ACTIVATION", "CONVOLUTION", "DROPOUT", "NORMALIZATION",
           "BACKBONE", "NECK", "DECODEHEAD", "SEGMENTOR"]
