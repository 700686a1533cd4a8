"""Weight bridge: a JAX-package state dict into a port module.

The input is the flat ``{dotted.name: np.ndarray}`` dict that the JAX
package's ``state_dict_from_variables`` writes and its pickle checkpoints
hold: every variable collection (``params``, ``frozen_params``,
``batch_stats``) flattened without the collection name.  Port submodules
are named after the JAX parameter-tree paths, so a port key maps to its JAX
key by one rule: a list index ``name.<i>`` (``nn.ModuleList``) is the flax
list attribute ``name_<i>``.  Values map by the type of the port module that
holds them, never by their shape (a square linear weight looks the same
either way round):

* ``nn.Conv2d`` weights: HWIO → OIHW;
* ``nn.Linear`` weights: ``(in, out)`` → ``(out, in)``;
* everything else (biases, norm affines and statistics, ViT's
  ``cls_token`` and ``pos_embed``): unchanged.

The load is strict: every JAX leaf must be used and every port parameter
and buffer filled (``num_batches_tracked`` has no JAX counterpart and is
left alone).
"""

from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

_LIST_INDEX = re.compile(r"\.(\d+)(?=\.|$)")


def jax_name(torch_name: str) -> str:
    """``backbone.stem.0.weight`` → ``backbone.stem_0.weight``."""
    return _LIST_INDEX.sub(r"_\1", torch_name)


def _layout_maps(model: nn.Module) -> Dict[str, Callable]:
    """Port weight name -> JAX-to-port layout map, by module type."""
    maps = {}
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, nn.Conv2d):
            maps[prefix + "weight"] = lambda a: a.transpose(3, 2, 0, 1)
        elif isinstance(module, nn.Linear):
            maps[prefix + "weight"] = np.transpose
    return maps


def load_jax_state_dict(model: nn.Module,
                        state_dict: Dict[str, np.ndarray]) -> None:
    """Copy a JAX-package state dict into ``model`` in place (strict)."""
    targets = {k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    layout = _layout_maps(model)
    remaining = dict(state_dict)
    missing, mismatched = [], []
    with torch.no_grad():
        for name, tensor in targets.items():
            key = jax_name(name)
            if key not in remaining:
                missing.append(f"{name} (JAX {key})")
                continue
            arr = np.asarray(remaining.pop(key))
            if name in layout:
                arr = layout[name](arr)
            if tuple(arr.shape) != tuple(tensor.shape):
                mismatched.append(f"{name}: checkpoint {arr.shape} vs model "
                                  f"{tuple(tensor.shape)}")
                continue
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    if missing or remaining or mismatched:
        raise KeyError(
            f"JAX state dict does not match the model: "
            f"port tensors left unfilled={missing}, "
            f"JAX leaves unused={sorted(remaining)}, "
            f"shape mismatches={mismatched}")
