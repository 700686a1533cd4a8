"""Per-parameter optimizer options, ``paramwise_cfg`` (counterpart of
``core/optimizers/paramwise.py``), as torch param groups.

Each parameter's ``(lr_mult, decay_mult)`` comes from the JAX package's
rules, applied to its JAX path (``bridge.jax_name`` of its name, joined by
'/', e.g. ``backbone/block3/attn/qkv/weight``), so the patterns and custom
keys see the same strings in both packages:

* ``custom_keys={'sub.string': dict(lr_mult=, decay_mult=)}``: the longest
  key contained in the path wins (ties alphabetically);
* ``bias_decay_mult`` / ``norm_decay_mult``, when no custom key set
  ``decay_mult``: for a leaf named ``bias``, or a path with a norm-layer
  segment (``norm``/``bn``/``gn``/``ln``);
* ``num_layers`` + ``layer_decay_rate`` (BEiT-style layer decay): ``lr_mult
  *= rate ** (num_layers + 1 - layer_id)``, with layer id 0 for the
  embeddings (``patch_embed``, ``pos_embed``, ``cls_token``,
  ``absolute_pos``, ``stem``), ``i + 1`` for ``block<i>`` (or ``blocks``,
  ``layer``, ``layers``), and ``num_layers + 1`` for everything else (the
  heads); while it is on, 1-D parameters, biases and the embeddings take no
  weight decay unless a custom key says otherwise.

The parameters of each distinct pair form one group, in the order of their
first parameter, with ``lr = base_lr·lr_mult`` and ``weight_decay =
base_wd·decay_mult``.  The JAX package scales each leaf's whole update by
``lr_mult`` and its decay term by ``decay_mult``; for SGD, Adam and AdamW
that is exactly a torch group's lr and weight decay (torch AdamW scales the
decoupled decay by the group's lr too), since their accumulators do not
depend on the lr.  An LR schedule scales each group from its own lr
(``lr_schedulers.EpochSchedule.torch_scheduler``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Tuple

import torch

from ...bridge import jax_name

_NORM_SEG = re.compile(r"(?:^|/)[^/]*(?:norm|(?<![a-z])bn|(?<![a-z])gn|"
                       r"(?<![a-z])ln)[^/]*(?:/|$)", re.IGNORECASE)
_BLOCK_ID = re.compile(r"(?:^|/)(?:block|blocks|layer|layers)[_.]?(\d+)")
_EMBED_TOKENS = ("patch_embed", "pos_embed", "cls_token", "absolute_pos",
                 "stem")


def jax_path(name: str) -> str:
    """``backbone.stem.0.weight`` -> ``backbone/stem_0/weight``."""
    return jax_name(name).replace(".", "/")


class ParamwiseRules:
    """``(lr_mult, decay_mult)`` of a parameter from its JAX path."""

    def __init__(self, paramwise_cfg: Dict[str, Any]):
        self.cfg = dict(paramwise_cfg)
        custom = self.cfg.get("custom_keys", {}) or {}
        self._custom = sorted(custom.items(), key=lambda kv: (-len(kv[0]),
                                                              kv[0]))
        self.num_layers = self.cfg.get("num_layers")
        self.layer_decay_rate = self.cfg.get("layer_decay_rate")

    def _layer_id(self, path: str) -> int:
        if any(t in path for t in _EMBED_TOKENS):
            return 0
        m = _BLOCK_ID.search(path)
        if m:
            return int(m.group(1)) + 1
        return int(self.num_layers) + 1

    def mults(self, path: str, ndim: int) -> Tuple[float, float]:
        lr_mult, decay_mult = 1.0, None
        for key, opts in self._custom:
            if key in path:
                lr_mult = float(opts.get("lr_mult", 1.0))
                if "decay_mult" in opts:
                    decay_mult = float(opts["decay_mult"])
                break
        leaf = path.rsplit("/", 1)[-1]
        if decay_mult is None:
            if leaf == "bias" and "bias_decay_mult" in self.cfg:
                decay_mult = float(self.cfg["bias_decay_mult"])
            elif _NORM_SEG.search(path) and "norm_decay_mult" in self.cfg:
                decay_mult = float(self.cfg["norm_decay_mult"])
        if self.num_layers and self.layer_decay_rate:
            lid = self._layer_id(path)
            lr_mult *= float(self.layer_decay_rate) ** (
                int(self.num_layers) + 1 - lid)
            if decay_mult is None and (
                    ndim <= 1 or any(t in path for t in _EMBED_TOKENS)):
                decay_mult = 0.0
        return lr_mult, 1.0 if decay_mult is None else decay_mult


def param_groups(named_params: Iterable[Tuple[str, torch.Tensor]],
                 paramwise_cfg: Dict[str, Any], base_lr: float,
                 base_wd: float) -> List[Dict[str, Any]]:
    """Torch param groups of ``named_params`` (``model.named_parameters()``
    names), one per distinct ``(lr_mult, decay_mult)``; each group also
    records its ``lr_mult`` and ``decay_mult``."""
    rules = ParamwiseRules(paramwise_cfg)
    groups: Dict[Tuple[float, float], Dict[str, Any]] = {}
    for name, p in named_params:
        pair = rules.mults(jax_path(name), p.dim())
        if pair not in groups:
            groups[pair] = dict(params=[], lr=base_lr * pair[0],
                                weight_decay=base_wd * pair[1],
                                lr_mult=pair[0], decay_mult=pair[1])
        groups[pair]["params"].append(p)
    return list(groups.values())
