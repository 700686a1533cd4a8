"""Config-driven weight initialisation: the ``init_cfg`` hooks (counterpart
of ``core/initialize/weight_init.py``).

The initializers (``Constant``, ``Xavier``, ``Normal``, ``TruncNormal``,
``Uniform``, ``Kaiming``, ``Caffe2Xavier``, ``Pretrained``) act in place on
a flat view of a module's parameters, keyed by their JAX paths
(``bridge.jax_name`` split at the dots), with the JAX package's rules:

* layer matching by leaf: ``weight`` with ndim >= 3 is a conv, 2 a linear,
  1 a norm affine; a ``bias`` follows the weight beside it;
* ``override`` re-initialises a named subtree: a dotted name anchors at the
  root, a bare name prefers a top-level child, else must be unique;
* ``Pretrained`` copies a checkpoint's arrays (JAX layout, converted by the
  module type) into the parameters of the same name and shape, from the
  subtree under ``prefix`` where given; buffers (BN statistics) are left
  alone, as the JAX package fills only its ``params`` collection.

Random draws come from a ``torch.Generator``; fans are torch's (OIHW and
``(out, in)``), which the JAX package computes on its HWIO and ``(in,
out)`` layouts, so the distributions are the same, not the numbers.
Which initializer last touched each parameter is recorded for
``dump_init_info``.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...bridge import jax_name, layout_maps
from ..registry_hub import INITIALIZERS

PathT = Tuple[str, ...]

_INIT_INFO: Dict[str, str] = {}


def update_init_info(path, init_info: str) -> None:
    key = ".".join(path) if isinstance(path, (tuple, list)) else str(path)
    _INIT_INFO[key] = init_info


def get_init_info() -> Dict[str, str]:
    return dict(_INIT_INFO)


def reset_init_info() -> None:
    _INIT_INFO.clear()


def dump_init_info(logger=print) -> None:
    """Log every recorded parameter's initializer, sorted by name."""
    for name in sorted(_INIT_INFO):
        logger(f"{name} - {_INIT_INFO[name]}")


def flat_params(module: nn.Module) -> Dict[PathT, torch.Tensor]:
    """``{JAX path: parameter}`` of ``module``."""
    return {tuple(jax_name(name).split(".")): p
            for name, p in module.named_parameters()}


# ------------------------------------------------------------ draws
def _fans(shape):
    """torch's fans of an OIHW conv or ``(out, in)`` linear weight; a
    vector's length for both."""
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def bias_init_with_prob(prior_prob: float) -> float:
    """The bias whose sigmoid is ``prior_prob``."""
    return float(-np.log((1 - prior_prob) / prior_prob))


def _normal(t, std, g, mean=0.0):
    return t.normal_(mean, std, generator=g)


def _uniform(t, bound, g):
    return t.uniform_(-bound, bound, generator=g)


# ------------------------------------------------------------ initializers
_CONV_LAYERS = {"Conv", "Conv1d", "Conv2d", "Conv3d", "_ConvND",
                "Conv2dAdaptivePadding"}
_LINEAR_LAYERS = {"Linear"}
_NORM_LAYERS = {"_BatchNorm", "BatchNorm", "BatchNorm1d", "BatchNorm2d",
                "BatchNorm3d", "SyncBatchNorm", "GroupNorm", "LayerNorm",
                "LayerNorm2d", "InstanceNorm", "InstanceNorm1d",
                "InstanceNorm2d", "InstanceNorm3d"}


def _leaf_kind(path: PathT, leaf) -> Optional[str]:
    if path[-1] == "weight":
        return {1: "norm", 2: "linear"}.get(leaf.dim(),
                                            "conv" if leaf.dim() >= 3
                                            else None)
    return "bias" if path[-1] == "bias" else None


def _wanted(layers: Optional[List[str]]):
    if layers is None:
        return None
    kinds = {"conv": _CONV_LAYERS, "linear": _LINEAR_LAYERS,
             "norm": _NORM_LAYERS}
    return {next((k for k, names in kinds.items() if layer in names), layer)
            for layer in layers}


class BaseInit:
    """Layer filter and bias handling; subclasses fill a weight."""

    def __init__(self, *, bias: float = 0, bias_prob: Optional[float] = None,
                 layer: Optional[Union[str, List[str]]] = None):
        if bias_prob is not None:
            bias = bias_init_with_prob(bias_prob)
        self.bias = bias
        self.layer = [layer] if isinstance(layer, str) else layer

    def fill_(self, tensor: torch.Tensor, generator: torch.Generator):
        raise NotImplementedError

    def _get_init_info(self) -> str:
        attrs = ", ".join(f"{k}={v}" for k, v in sorted(vars(self).items())
                          if not k.startswith("_"))
        return f"{type(self).__name__}({attrs})"

    @torch.no_grad()
    def __call__(self, params: Dict[PathT, torch.Tensor],
                 generator: torch.Generator) -> None:
        wanted = _wanted(self.layer)
        owner = {p[:-1]: _leaf_kind(p, t) for p, t in params.items()
                 if p[-1] == "weight"}
        for path, leaf in params.items():
            kind = _leaf_kind(path, leaf)
            if kind == "bias":
                owner_kind = owner.get(path[:-1])
                if owner_kind is None or (wanted is not None
                                          and owner_kind not in wanted):
                    continue
                leaf.fill_(self.bias)
            elif kind is not None and (wanted is None or kind in wanted):
                self.fill_(leaf, generator)
            else:
                continue
            update_init_info(path, self._get_init_info())


@INITIALIZERS.register("Constant")
class ConstantInit(BaseInit):
    def __init__(self, val: float, **kwargs):
        super().__init__(**kwargs)
        self.val = val

    def fill_(self, tensor, generator):
        tensor.fill_(self.val)


@INITIALIZERS.register("Xavier")
class XavierInit(BaseInit):
    def __init__(self, gain: float = 1, distribution: str = "normal",
                 **kwargs):
        super().__init__(**kwargs)
        assert distribution in ("normal", "uniform")
        self.gain, self.distribution = gain, distribution

    def fill_(self, tensor, generator):
        fan_in, fan_out = _fans(tensor.shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        if self.distribution == "normal":
            _normal(tensor, std, generator)
        else:
            _uniform(tensor, math.sqrt(3.0) * std, generator)


@INITIALIZERS.register("Normal")
class NormalInit(BaseInit):
    def __init__(self, mean: float = 0, std: float = 1, **kwargs):
        super().__init__(**kwargs)
        self.mean, self.std = mean, std

    def fill_(self, tensor, generator):
        _normal(tensor, self.std, generator, self.mean)


@INITIALIZERS.register("TruncNormal")
class TruncNormalInit(BaseInit):
    """Normal truncated to the absolute bounds ``[a, b]``."""

    def __init__(self, mean: float = 0, std: float = 1,
                 a: float = -2, b: float = 2, **kwargs):
        super().__init__(**kwargs)
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def fill_(self, tensor, generator):
        nn.init.trunc_normal_(tensor, self.mean, self.std, self.a, self.b,
                              generator=generator)


@INITIALIZERS.register("Uniform")
class UniformInit(BaseInit):
    def __init__(self, a: float = 0, b: float = 1, **kwargs):
        super().__init__(**kwargs)
        self.a, self.b = a, b

    def fill_(self, tensor, generator):
        tensor.uniform_(self.a, self.b, generator=generator)


@INITIALIZERS.register("Kaiming")
class KaimingInit(BaseInit):
    def __init__(self, a: float = 0, mode: str = "fan_out",
                 nonlinearity: str = "relu",
                 distribution: str = "normal", **kwargs):
        super().__init__(**kwargs)
        assert mode in ("fan_in", "fan_out")
        assert distribution in ("normal", "uniform")
        self.a, self.mode = a, mode
        self.nonlinearity, self.distribution = nonlinearity, distribution

    def fill_(self, tensor, generator):
        fan_in, fan_out = _fans(tensor.shape)
        fan = fan_in if self.mode == "fan_in" else fan_out
        std = nn.init.calculate_gain(self.nonlinearity, self.a) / math.sqrt(fan)
        if self.distribution == "normal":
            _normal(tensor, std, generator)
        else:
            _uniform(tensor, math.sqrt(3.0) * std, generator)


@INITIALIZERS.register("Caffe2Xavier")
class Caffe2XavierInit(KaimingInit):
    def __init__(self, **kwargs):
        super().__init__(a=1, mode="fan_in", nonlinearity="leaky_relu",
                         distribution="uniform", **kwargs)


@INITIALIZERS.register("Pretrained")
class PretrainedInit:
    """Copy a checkpoint of this project (``save_checkpoint``, either
    package) into the parameters, from the subtree under ``prefix`` (e.g.
    ``'backbone.'``) where given.  The layouts come from ``module``, the
    module whose parameters are filled (set by ``initialize``)."""

    def __init__(self, checkpoint: str, prefix: Optional[str] = None,
                 map_location: str = "cpu"):
        self.checkpoint = checkpoint
        self.prefix = prefix
        self.map_location = map_location
        self.module: Optional[nn.Module] = None

    @torch.no_grad()
    def __call__(self, params: Dict[PathT, torch.Tensor],
                 generator=None) -> None:
        from .checkpoint import load_file, load_checkpoint_with_prefix
        if self.prefix:
            state_dict = load_checkpoint_with_prefix(self.prefix,
                                                     self.checkpoint)
        else:
            state_dict = load_file(self.checkpoint)
            state_dict = state_dict.get("state_dict", state_dict)
        layouts = ({tuple(jax_name(k).split(".")): fn for k, fn in
                    layout_maps(self.module).items()}
                   if self.module is not None else {})
        info = f"PretrainedInit: load from {self.checkpoint}"
        for path, leaf in params.items():
            arr = state_dict.get(".".join(path))
            if arr is None:
                continue
            arr = np.asarray(arr)
            if path in layouts:
                arr = layouts[path](arr)
            if tuple(arr.shape) != tuple(leaf.shape):
                continue
            leaf.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            update_init_info(path, info)


def _subtree_paths(flat, name: str):
    """The paths an override ``name`` selects: a dotted name anchors at the
    root; a bare name that is a top-level child selects that child; else a
    deeper subtree, which must be the only one of that name."""
    comps = tuple(name.split("."))
    k = len(comps)
    if k > 1 or any(p and p[0] == name for p in flat):
        return {p for p in flat if p[:k] == comps}
    anchors, matches = set(), set()
    for p in flat:
        for i in range(len(p) - k + 1):
            if p[i:i + k] == comps:
                anchors.add(p[:i + k])
                matches.add(p)
                break
    if len(anchors) > 1:
        raise ValueError(
            f"override name '{name}' is ambiguous — it matches "
            f"{sorted('.'.join(a) for a in anchors)}; use a dotted path")
    return matches


def _build(cfg: Dict[str, Any], module: nn.Module):
    func = INITIALIZERS.get(cfg.pop("type"))(**cfg)
    if isinstance(func, PretrainedInit):
        func.module = module
    return func


def initialize(module: nn.Module, init_cfg, generator: torch.Generator
               ) -> nn.Module:
    """Apply ``init_cfg`` (a dict or a list of dicts) to ``module``'s
    parameters in place, ``override`` entries to their named subtrees;
    returns ``module``."""
    if init_cfg is None:
        return module
    params = flat_params(module)
    for cfg in init_cfg if isinstance(init_cfg, list) else [init_cfg]:
        cfg = copy.deepcopy(cfg)
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"init_cfg must be dict(s) with `type`, got {cfg}")
        override = cfg.pop("override", None)
        func = _build(cfg, module)
        func(params, generator)
        for ov in (override if isinstance(override, list)
                   else [override] if override is not None else []):
            ov = copy.deepcopy(ov)
            name = ov.pop("name")
            ov_func = _build(ov, module) if "type" in ov else func
            target = {p: t for p, t in params.items()
                      if p in _subtree_paths(params, name)}
            if not target:
                raise RuntimeError(
                    f"override name '{name}' matches no param path")
            ov_func(target, generator)
    return module


def initialize_from_network_cfg(model: nn.Module, network_cfg,
                                generator: torch.Generator) -> nn.Module:
    """A network config's ``pretrained`` / ``init_cfg`` hooks on ``model``:
    the model-level one over the whole model, the backbone-level one over
    ``model.backbone``.  A remote locator (``torchvision://...``) raises:
    nothing is downloaded."""

    def as_init(pretrained, init_cfg):
        if pretrained:
            path = str(pretrained)
            if "://" in path:
                raise FileNotFoundError(
                    f"pretrained='{path}' is a remote locator; download the "
                    f"torch checkpoint, convert it with "
                    f"tools/convert_torch_checkpoint.py, then point "
                    f"`pretrained` at the converted file")
            return dict(type="Pretrained", checkpoint=path)
        return init_cfg

    initialize(model, as_init(network_cfg.get("pretrained"),
                              network_cfg.get("init_cfg")), generator)
    backbone_cfg = network_cfg.get("backbone") or {}
    backbone_init = as_init(backbone_cfg.get("pretrained"),
                            backbone_cfg.get("init_cfg"))
    if backbone_init is not None and hasattr(model, "backbone"):
        initialize(model.backbone, backbone_init, generator)
    return model
