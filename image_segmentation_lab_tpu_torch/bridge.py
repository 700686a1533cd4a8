"""Weight bridge: a JAX-package state dict into a port module, and back.

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
* ``nn.ConvTranspose2d`` weights: ``(kh, kw, out, in)`` → ``(in, out, kh,
  kw)`` (the JAX module's rotation happens inside its call);
* ``PointwiseLinear`` weights (a JAX 1 x 1 conv as a linear over
  channels-last tokens): ``(1, 1, in, out)`` → ``(out, in)``;
* ``nn.Linear`` weights: ``(in, out)`` → ``(out, in)``;
* everything else (biases, norm affines and statistics, the ViTs'
  ``cls_token`` and ``pos_embed``, relative-position tables, BEiT's
  ``q_bias``/``v_bias``, layer-scale ``gamma`` vectors): unchanged.

The load is strict: every JAX leaf must be used and every port parameter
and buffer filled (``num_batches_tracked`` has no JAX counterpart and is
left alone).  ``jax_state_dict`` is its inverse: the module's state as the
JAX package's flat dict (float32 numpy on the host, JAX names and layouts,
no ``num_batches_tracked``), which the JAX ``load_checkpoint`` reads.
"""

from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from .models.basic.convolution import PointwiseLinear

_LIST_INDEX = re.compile(r"\.(\d+)(?=\.|$)")


def jax_name(torch_name: str) -> str:
    """``backbone.stem.0.weight`` → ``backbone.stem_0.weight``."""
    return _LIST_INDEX.sub(r"_\1", torch_name)


# per module type, the first that matches: (JAX layout -> port layout,
# port layout -> JAX layout)
_LAYOUTS = {
    nn.Conv2d: (lambda a: a.transpose(3, 2, 0, 1),   # HWIO -> OIHW
                lambda a: a.transpose(2, 3, 1, 0)),  # OIHW -> HWIO
    nn.ConvTranspose2d: (lambda a: a.transpose(3, 2, 0, 1),  # (kh, kw, out,
                         lambda a: a.transpose(2, 3, 1, 0)),  # in) <-> IOHW
    PointwiseLinear: (lambda a: a[0, 0].T,           # (1, 1, in, out)
                      lambda a: a.T[None, None]),    # (out, in)
    nn.Linear: (np.transpose, np.transpose),
}


def layout_maps(model: nn.Module, to_jax: bool = False) -> Dict[str,
                                                                 Callable]:
    """Port weight name -> its layout map (JAX to port, or back), by the
    type of the module that holds it."""
    maps = {}
    for name, module in model.named_modules():
        for kind, pair in _LAYOUTS.items():
            if isinstance(module, kind):
                maps[f"{name}.weight" if name else "weight"] = pair[to_jax]
                break
    return maps


def jax_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """``model``'s parameters and buffers as the JAX package's flat state
    dict: ``{jax_name: float32 (or integer) numpy array}``."""
    layout = layout_maps(model, to_jax=True)
    out = {}
    for name, tensor in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = tensor.detach().cpu().numpy()
        if name in layout:
            arr = layout[name](arr)
        out[jax_name(name)] = np.ascontiguousarray(arr)
    return out


def mapped_state_dict(model: nn.Module, state_dict: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Port tensor name -> its JAX array in the port's layout (a view where
    the layout map allows one), checked strictly against the shapes of
    ``model.state_dict()``; a model on the ``meta`` device and arrays that
    are zero-stride views check a full-size mapping without memory."""
    targets = {k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    layout = layout_maps(model)
    remaining = dict(state_dict)
    missing, mismatched, mapped = [], [], {}
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
        mapped[name] = arr
    if missing or remaining or mismatched:
        raise KeyError(
            f"JAX state dict does not match the model: "
            f"port tensors left unfilled={missing}, "
            f"JAX leaves unused={sorted(remaining)}, "
            f"shape mismatches={mismatched}")
    return mapped


def load_jax_state_dict(model: nn.Module,
                        state_dict: Dict[str, np.ndarray]) -> None:
    """Copy a JAX-package state dict into ``model`` in place (strict)."""
    targets = model.state_dict()
    with torch.no_grad():
        for name, arr in mapped_state_dict(model, state_dict).items():
            targets[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
