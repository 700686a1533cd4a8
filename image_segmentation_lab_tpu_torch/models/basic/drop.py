"""Dropout layers (counterpart of ``models/basic/drop.py``).

``Dropout`` and ``Dropout2d`` zero elements or whole channels in training
and are the identity in eval mode, as the JAX layers are without
``train=True``.  ``DropPath`` (stochastic depth) zeroes a whole sample's
residual branch with probability ``drop_prob`` in training and rescales
the kept ones by ``1 / (1 - drop_prob)``.

Random bits never come from torch's global generator.  A layer that draws
(training mode, ``p > 0``) takes them from the generator installed by
``use_generator(g)``, as the JAX layers take the ``'dropout'`` rng stream a
train step hands in, and raises without one.  The generator lives on the
tensors' device (a CUDA generator on the card).  Its bits cannot equal
JAX's.
"""

import contextlib
from typing import Optional

import torch
from torch import nn

from ...core.registry_hub import DROPOUT

_generator: Optional[torch.Generator] = None


@contextlib.contextmanager
def use_generator(generator: torch.Generator):
    """Draw every dropout mask inside the block from ``generator``."""
    global _generator
    previous, _generator = _generator, generator
    try:
        yield generator
    finally:
        _generator = previous


def current_generator() -> Optional[torch.Generator]:
    """The generator installed by ``use_generator``, or None outside it."""
    return _generator


def keep_mask(shape, keep: float, like: torch.Tensor) -> torch.Tensor:
    """Bernoulli(keep) mask of ``shape`` in ``like``'s dtype and device,
    drawn from the installed generator."""
    if _generator is None:
        raise RuntimeError("dropout in training needs a generator: run the "
                           "forward under models.basic.drop.use_generator(g)")
    return torch.empty(shape, dtype=like.dtype,
                       device=like.device).bernoulli_(keep,
                                                      generator=_generator)


class _Dropout(nn.Module):
    """Inverted dropout; ``channel_wise`` shares one mask value over each
    channel's spatial positions (NCHW)."""

    channel_wise = False

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[:2] + (1,) * (x.dim() - 2) if self.channel_wise
                 else x.shape)
        return torch.where(keep_mask(shape, keep, x) != 0, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


@DROPOUT.register("Dropout")
class Dropout(_Dropout):
    pass


@DROPOUT.register("Dropout2d")
class Dropout2d(_Dropout):
    """Channel dropout: zeroes whole channels of an NCHW tensor."""

    channel_wise = True


@DROPOUT.register("DropPath")
class DropPath(nn.Module):

    def __init__(self, drop_prob: float = 0.1):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x):
        if not self.training or self.drop_prob == 0.0:
            return x
        keep = 1.0 - self.drop_prob
        return x / keep * keep_mask((x.shape[0],) + (1,) * (x.dim() - 1),
                                    keep, x)
