"""Convolution layers (counterpart of ``models/basic/convolution.py``).

``Conv2d`` is ``nn.Conv2d`` (NCHW, weights OIHW).  The JAX package rewrites
large-dilation 3x3 convs as a centre matmul plus boundary slabs
(``ops/dilated_conv.py``); that rewrite computes exactly what a dilated conv
computes, so here the dilated conv is cuDNN's.
"""

from torch import nn

from ...core.registry_hub import CONVOLUTION

Conv2d = CONVOLUTION.register("Conv2d", aliases=("Conv",))(nn.Conv2d)
