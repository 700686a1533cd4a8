"""Checkpoint files (counterpart of ``core/initialize/checkpoint.py``).

A checkpoint is the JAX package's pickle file, ``{'metadata',
'state_dict'[, 'train_state']}``, with the flat state dict of numpy arrays
under the JAX names and layouts (``bridge.py``), so either package reads
the other's weights.  ``save_checkpoint`` writes it to ``<file>.tmp`` and
renames it into place, so a crash never leaves half a file.  Like the JAX
loader this unpickles the file, so load only checkpoints this project
wrote.  The orbax backends (directories) are neither written nor read:
the card's machine has no orbax.

The ``train_state`` of a resumable checkpoint is the port's own: the torch
optimizer's and LR scheduler's ``state_dict()``, the step, the BatchNorm
``num_batches_tracked`` counters and the EMA tensors, each tensor as a
numpy array (the file unpickles with numpy alone), tagged ``"framework":
"torch"``.  An optax train state has no torch counterpart: resume works
only within one package (``--load-from`` takes the weights of either).
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...bridge import jax_state_dict, load_jax_state_dict

FRAMEWORK = "torch"


def load_file(filename) -> Dict[str, Any]:
    filename = Path(filename)
    if filename.is_dir():
        raise NotImplementedError(
            f"{filename} is an orbax checkpoint directory; only pickle "
            f"checkpoint files are read")
    if not filename.is_file():
        raise FileNotFoundError(f"checkpoint file not found: {filename}")
    with open(filename, "rb") as f:
        return pickle.load(f)


def load_checkpoint(model: nn.Module, filename,
                    revise_keys=((r"^module\.", ""),)) -> Dict[str, Any]:
    """Load a pickle checkpoint into ``model`` (strict), after applying the
    ``revise_keys`` regex substitutions to every state-dict key.  Returns
    the checkpoint dict."""
    ckpt = load_file(filename)
    state_dict = ckpt.get("state_dict", ckpt)
    for pattern, replacement in revise_keys:
        state_dict = {re.sub(pattern, replacement, k): v
                      for k, v in state_dict.items()}
    load_jax_state_dict(model, state_dict)
    return ckpt


def load_checkpoint_with_prefix(prefix: str, filename) -> Dict[str,
                                                                np.ndarray]:
    """The sub-state-dict under ``prefix``, with the prefix stripped."""
    state_dict = load_file(filename)
    state_dict = state_dict.get("state_dict", state_dict)
    if not prefix.endswith("."):
        prefix += "."
    out = {k[len(prefix):]: v for k, v in state_dict.items()
           if k.startswith(prefix)}
    assert out, f"{prefix} is not in the checkpoint"
    return out


def to_numpy(tree):
    """``tree`` (dicts, lists, tuples) with every tensor a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def to_tensors(tree):
    """The inverse of ``to_numpy``: every numpy array a tensor."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_tensors(v) for v in tree)
    return tree


def pack_train_state(state, ema_params=None) -> Dict[str, Any]:
    """The resumable state of a ``TrainState`` as numpy: optimizer,
    scheduler, step, BN counters and (optional) EMA tensors."""
    counters = {name: buf for name, buf in state.model.named_buffers()
                if name.endswith("num_batches_tracked")}
    packed = {
        "framework": FRAMEWORK,
        "step": np.asarray(state.step, np.int64),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": (state.scheduler.state_dict()
                      if state.scheduler is not None else None),
        "num_batches_tracked": counters,
    }
    if ema_params is not None:
        packed["ema_params"] = dict(ema_params)
    return to_numpy(packed)


def unpack_train_state(state, train_state: Dict[str, Any], source):
    """Restore ``pack_train_state``'s output into ``state`` (in place);
    returns the EMA tensors (or None).  A train state that another package
    wrote (an optax tree) raises ``SystemExit``."""
    if not isinstance(train_state, dict) or \
            train_state.get("framework") != FRAMEWORK:
        raise SystemExit(
            f"{source}: its train_state was not written by the PyTorch "
            f"port (an optax state has no torch counterpart), so training "
            f"cannot resume from it; start from its weights with "
            f"--load-from instead")
    state.step = int(train_state["step"])
    state.optimizer.load_state_dict(to_tensors(train_state["optimizer"]))
    if state.scheduler is not None and train_state["scheduler"] is not None:
        state.scheduler.load_state_dict(train_state["scheduler"])
    buffers = dict(state.model.named_buffers())
    with torch.no_grad():
        for name, value in train_state["num_batches_tracked"].items():
            buffers[name].copy_(torch.from_numpy(np.array(value)))
    ema = train_state.get("ema_params")
    return None if ema is None else to_tensors(ema)


def save_checkpoint(model: nn.Module, filename,
                    metadata: Optional[Dict[str, Any]] = None,
                    train_state: Optional[Dict[str, Any]] = None,
                    backend: str = "pickle") -> None:
    """Write ``{'metadata', 'state_dict'[, 'train_state']}`` to
    ``filename`` (pickle, through ``<filename>.tmp``); ``train_state``:
    ``pack_train_state``'s output."""
    if backend in ("orbax", "orbax_async"):
        raise NotImplementedError(
            f"checkpoint backend {backend!r} is not ported: the card's "
            f"machine has no orbax; use the pickle backend")
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    payload: Dict[str, Any] = {"metadata": metadata or {},
                               "state_dict": jax_state_dict(model)}
    if train_state is not None:
        payload["train_state"] = train_state
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(str(filename) + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    tmp.replace(filename)
