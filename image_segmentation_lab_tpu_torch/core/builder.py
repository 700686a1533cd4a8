"""Config-dict builders of the core side (counterpart of
``core/builder.py``): ``build_from_cfg`` and ``build_optimizer``, and the
DATASET registry (``build_from_cfg(cfg, DATASET)`` builds the configs of
``configs/dataset/``)."""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Dict

from ..registry import Register
from . import dataset, optimizers  # noqa: F401  (registration)
from .optimizers.paramwise import param_groups
from .registry_hub import DATASET, LR_SCHEDULER, OPTIMIZER


def build_from_cfg(cfg: Dict[str, Any], registry: Register) -> Any:
    """``registry.get(cfg['type'])(**rest)``."""
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise KeyError(f'cfg must be a dict containing "type", got {cfg}')
    args = copy.deepcopy(dict(cfg))
    return registry.get(args.pop("type"))(**args)


def build_optimizer(cfg: Dict[str, Any], params, frozen_mask: Any = None):
    """A ``torch.optim`` optimizer from a ``dict(type='SGD', lr=..., ...)``
    cfg over ``params``: ``(name, parameter)`` pairs as
    ``model.named_parameters()`` gives them, or, without ``paramwise_cfg``,
    the parameters alone.  ``paramwise_cfg`` makes the param groups of
    ``core/optimizers/paramwise.py``.  Frozen parameters are those with
    ``requires_grad=False`` (they get no gradient, so no update)."""
    cfg = copy.deepcopy(dict(cfg))
    opt_type = cfg.pop("type")
    paramwise_cfg = cfg.pop("paramwise_cfg", None)
    if frozen_mask is not None:
        raise NotImplementedError(
            "frozen_mask is not ported: freeze with requires_grad=False")
    params = list(params)
    named = bool(params) and isinstance(params[0], tuple)
    if paramwise_cfg:
        if not named:
            raise NotImplementedError(
                "paramwise_cfg resolves each parameter's multipliers from "
                "its name: pass (name, parameter) pairs, as "
                "model.named_parameters() gives them")
        params = param_groups(params, paramwise_cfg, cfg["lr"],
                              cfg.get("weight_decay", 0.0) or 0.0)
    elif named:
        params = [p for _, p in params]
    return OPTIMIZER.get(opt_type)(params, **cfg)


__all__ = ["DATASET", "LR_SCHEDULER", "OPTIMIZER", "build_from_cfg",
           "build_optimizer"]
