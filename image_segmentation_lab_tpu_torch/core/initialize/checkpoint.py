"""Checkpoint loading (counterpart of ``core/initialize/checkpoint.py``).

Reads the JAX package's pickle checkpoints, ``{'metadata', 'state_dict'[,
'train_state']}`` with a flat state dict of numpy arrays, and loads them
through the weight bridge.  Like the JAX loader this unpickles the file, so
load only checkpoints this project wrote.  Orbax checkpoint directories are
not read.
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Any, Dict

from torch import nn

from ...bridge import load_jax_state_dict


def load_checkpoint(model: nn.Module, filename,
                    revise_keys=((r"^module\.", ""),)) -> Dict[str, Any]:
    """Load a pickle checkpoint into ``model`` (strict), after applying the
    ``revise_keys`` regex substitutions to every state-dict key.  Returns
    the checkpoint dict."""
    filename = Path(filename)
    if filename.is_dir():
        raise NotImplementedError(
            f"{filename} is an orbax checkpoint directory; only pickle "
            f"checkpoint files are read")
    if not filename.is_file():
        raise FileNotFoundError(f"checkpoint file not found: {filename}")
    with open(filename, "rb") as f:
        ckpt = pickle.load(f)
    state_dict = ckpt.get("state_dict", ckpt)
    for pattern, replacement in revise_keys:
        state_dict = {re.sub(pattern, replacement, k): v
                      for k, v in state_dict.items()}
    load_jax_state_dict(model, state_dict)
    return ckpt
