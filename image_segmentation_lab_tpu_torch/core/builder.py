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
from .registry_hub import DATASET, LR_SCHEDULER, OPTIMIZER


def build_from_cfg(cfg: Dict[str, Any], registry: Register) -> Any:
    """``registry.get(cfg['type'])(**rest)``."""
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise KeyError(f'cfg must be a dict containing "type", got {cfg}')
    args = copy.deepcopy(dict(cfg))
    return registry.get(args.pop("type"))(**args)


def build_optimizer(cfg: Dict[str, Any], params, frozen_mask: Any = None):
    """A ``torch.optim`` optimizer over ``params`` from a ``dict(type='SGD',
    lr=..., ...)`` cfg.  Frozen parameters are those with
    ``requires_grad=False`` (they get no gradient, so no update)."""
    cfg = copy.deepcopy(dict(cfg))
    opt_type = cfg.pop("type")
    if cfg.pop("paramwise_cfg", None):
        raise NotImplementedError(
            "paramwise_cfg is not ported yet (ROADMAP Queue 1 item 5; it "
            "comes with BEiT/Swin)")
    if frozen_mask is not None:
        raise NotImplementedError(
            "frozen_mask is not ported: freeze with requires_grad=False")
    return OPTIMIZER.get(opt_type)(params, **cfg)


__all__ = ["DATASET", "LR_SCHEDULER", "OPTIMIZER", "build_from_cfg",
           "build_optimizer"]
