"""The port's registries, one instance each, created in one place.

Only the registries the ported slices fill exist so far; the others
(samplers, initializers, ...) arrive with the modules that fill them.
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
LOSS = Register("loss")
OPTIMIZER = Register("optimizer")
LR_SCHEDULER = Register("lr_scheduler")
DATASET = Register("dataset")

__all__ = ["ACTIVATION", "CONVOLUTION", "DROPOUT", "NORMALIZATION",
           "BACKBONE", "NECK", "DECODEHEAD", "SEGMENTOR", "LOSS", "OPTIMIZER",
           "LR_SCHEDULER", "DATASET"]
