"""Optimizer registry (counterpart of ``core/optimizers/optimizers.py``).

Each factory takes the parameters and the torch argument names of the
schedule configs (``lr``, ``momentum``, ``weight_decay``, ``betas``,
``eps``) with the JAX factories' defaults and asserts, and returns a
``torch.optim`` optimizer, whose update the JAX package's optax chains
reproduce (``tests/test_optimizers_torch_parity.py``): L2 weight decay
added to the gradient for SGD and Adam, decoupled for AdamW.  ``lr`` is
the base rate; a schedule scales it through ``lr_schedulers.py``.  The
other names the JAX package registers raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..registry_hub import OPTIMIZER


@OPTIMIZER.register("SGD")
def sgd(params, lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
        dampening: float = 0.0, nesterov: bool = False):
    assert dampening == 0.0, "dampening is not supported"
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


@OPTIMIZER.register("Adam")
def adam(params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, amsgrad: bool = False):
    assert not amsgrad, "amsgrad is not supported"
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


@OPTIMIZER.register("AdamW")
def adamw(params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, amsgrad: bool = False):
    assert not amsgrad, "amsgrad is not supported"
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _not_ported(name):
    def factory(params, **kwargs):
        raise NotImplementedError(
            f"optimizer {name} is not ported yet (ROADMAP Queue 1 item 5)")
    return factory


for _name in ("SparseAdam", "Adadelta", "ASGD", "RMSprop", "Rprop", "RAdam",
              "NAdam", "Adamax", "LBFGS"):
    OPTIMIZER.register(_name)(_not_ported(_name))
