"""Convolution and dense layers (counterpart of
``models/basic/convolution.py``).

``Conv2d`` is ``nn.Conv2d`` (NCHW, weights OIHW).  The JAX package rewrites
large-dilation 3x3 convs as a centre matmul plus boundary slabs
(``ops/dilated_conv.py``); that rewrite computes exactly what a dilated conv
computes, so here the dilated conv is cuDNN's.

``Linear`` is ``nn.Linear``, whose weight is ``(out, in)``: the transpose of
the JAX ``Linear``'s ``(in, out)`` kernel, which ``bridge.py`` transposes.
Like the JAX one it is in no registry.

``ConvTranspose2d`` (alias ``deconv``) is ``nn.ConvTranspose2d``, weights
``(in, out, kh, kw)``.  The JAX module stores ``(kh, kw, out, in)`` and
rotates it by 180 degrees inside its input-dilated forward convolution, which
makes the same transposed convolution as torch's unrotated weight:
``bridge.py`` maps the layout by this type, with no flip.

``PointwiseLinear`` is an ``nn.Linear`` over channels-last tokens that
stands for a JAX 1 x 1 ``Conv2d`` (MiT's projections): the same product,
with the weight stored ``(1, 1, in, out)`` on the JAX side, which
``bridge.py`` maps by this type.
"""

from torch import nn

from ...core.registry_hub import CONVOLUTION

Conv2d = CONVOLUTION.register("Conv2d", aliases=("Conv",))(nn.Conv2d)
ConvTranspose2d = CONVOLUTION.register(
    "ConvTranspose2d", aliases=("deconv",))(nn.ConvTranspose2d)
Linear = nn.Linear


class PointwiseLinear(nn.Linear):
    """A JAX 1 x 1 convolution, applied to ``(..., in)`` tokens."""
