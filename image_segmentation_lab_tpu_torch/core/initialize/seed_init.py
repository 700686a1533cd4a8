"""Seeding (counterpart of ``core/initialize/seed_init.py``).

``init_random_seed`` picks the run's seed; ``set_random_seed`` seeds
Python's and numpy's generators and torch's global one, sets the
determinism switches, and returns the root seed from which the train CLI
derives each ``torch.Generator`` with ``derive_seed`` (as the JAX package
folds its root key): every draw of the port comes from an explicit
generator.

``deterministic=True`` (set by the Kvasir and synthetic schedules) turns on
``torch.use_deterministic_algorithms``, ``cudnn.deterministic`` and turns
off ``cudnn.benchmark``: an op with no deterministic CUDA implementation
then raises instead of running.  cuBLAS needs a fixed workspace for that
(``CUBLAS_WORKSPACE_CONFIG``), which is set here unless the environment
sets it.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch


def init_random_seed(seed: Optional[int] = None, device=None) -> int:
    """``seed``, or a random one when it is None (one process: nothing to
    broadcast)."""
    if seed is not None:
        return int(seed)
    return int.from_bytes(os.urandom(4), "little") % (2 ** 31)


def set_random_seed(seed: int, deterministic: bool = False) -> int:
    """Seed ``random``, numpy and torch's global generator with ``seed``,
    set the determinism switches, and return ``seed``, the root of every
    generator a run derives (``derive_seed``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(deterministic)
    return int(seed)


def derive_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream named by ``keys`` under the root
    ``seed`` (numpy's ``SeedSequence``): distinct keys give independent
    streams, the same keys the same one."""
    state = np.random.SeedSequence([int(seed), *map(int, keys)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))
