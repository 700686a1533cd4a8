"""Model-side builders (counterpart of ``models/builder.py``).

Configs are the same ``dict(type=..., **kwargs)`` dicts the JAX package
reads; each ``type`` resolves in the port's own registries.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

from ..core.registry_hub import (ACTIVATION, BACKBONE, CONVOLUTION,
                                 DECODEHEAD, DROPOUT, LOSS, NECK,
                                 NORMALIZATION, SEGMENTOR)
from ..registry import Register

# registries buildable through build_module_from_cfg
_MODULE = (BACKBONE, NECK, DECODEHEAD)


def _typed_cfg(cfg) -> Tuple[str, Dict[str, Any]]:
    if not isinstance(cfg, Mapping) or "type" not in cfg:
        raise KeyError(f'cfg must be a dict containing "type", got {cfg}')
    cfg_ = copy.deepcopy(dict(cfg))
    return cfg_.pop("type"), cfg_


def build_conv_layer(cfg: Optional[Dict], *args, **kwargs):
    """Build a convolution layer; ``cfg=None`` gives ``Conv2d``."""
    layer_type, cfg_ = _typed_cfg(cfg or dict(type="Conv2d"))
    return CONVOLUTION.get(layer_type)(*args, **kwargs, **cfg_)


def infer_norm_abbr(class_name: str) -> str:
    """Abbreviated attribute name of a norm layer (``bn``, ``gn``, ...)."""
    name = class_name.lower()
    for key, abbr in (("batch", "bn"), ("group", "gn"), ("layer", "ln"),
                      ("instance", "in")):
        if key in name:
            return abbr
    return "norm_layer"


def build_norm_layer(cfg: Dict, num_features: int,
                     postfix: Any = "") -> Tuple[str, Any]:
    """Build a norm layer, returning ``(name, layer)``; ``requires_grad``
    freezes its affine parameters and ``eps`` defaults to 1e-5; GroupNorm
    needs ``num_groups`` and takes the channels as ``num_channels``."""
    layer_type, cfg_ = _typed_cfg(cfg)
    norm_layer = NORMALIZATION.get(layer_type)
    assert isinstance(postfix, (int, str))
    name = infer_norm_abbr(norm_layer.__name__) + str(postfix)
    requires_grad = cfg_.pop("requires_grad", True)
    cfg_.setdefault("eps", 1e-5)
    if name.startswith("gn"):
        assert "num_groups" in cfg_, "GroupNorm cfg needs `num_groups`"
        layer = norm_layer(num_channels=num_features, **cfg_)
    else:
        layer = norm_layer(num_features, **cfg_)
    for param in layer.parameters():
        param.requires_grad = requires_grad
    return name, layer


def build_activation_layer(cfg: Dict):
    layer_type, cfg_ = _typed_cfg(cfg)
    return ACTIVATION.get(layer_type)(**cfg_)


def build_dropout(cfg: Dict):
    layer_type, cfg_ = _typed_cfg(cfg)
    return DROPOUT.get(layer_type)(**cfg_)


def build_module_from_cfg(cfg: Dict, registry: Register,
                          default_args: Optional[Dict] = None):
    """Build a backbone/neck/decode head from cfg."""
    if not isinstance(cfg, Mapping):
        raise TypeError(f"cfg must be a dict, but got {type(cfg)}")
    if registry not in _MODULE:
        raise TypeError(
            f"registry must be one of {tuple(r.name for r in _MODULE)}, "
            f"but got {registry.name}")
    args = copy.deepcopy(dict(cfg))
    for name, value in (default_args or {}).items():
        args.setdefault(name, value)
    if "type" not in args:
        raise KeyError(f'`cfg` or `default_args` must contain the key "type", '
                       f"but got {cfg}\n{default_args}")
    obj_type = args.pop("type")
    obj_cls = registry.get(obj_type) if isinstance(obj_type, str) else obj_type
    return obj_cls(**args)


def build_loss(cfg: Dict):
    layer_type, cfg_ = _typed_cfg(cfg)
    return LOSS.get(layer_type)(**cfg_)


def build_segmentor(cfg: Dict):
    layer_type, cfg_ = _typed_cfg(cfg)
    return SEGMENTOR.get(layer_type)(**cfg_)
