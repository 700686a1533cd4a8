"""Mixed-precision dtype policy (counterpart of
``core/mixed_precision/policy.py``).

The schedule flag ``amp=True`` maps to the ``bf16`` policy: float32
parameters, bfloat16 compute, no loss scaler (bf16 keeps float32's
exponent range).  In PyTorch that compute policy is ``torch.autocast``
with ``dtype=torch.bfloat16`` over the float32 parameters:
``compute_autocast(device_type)`` is the one region, entered by
``EncoderDecoder.encode_decode`` and ``forward_train``, so that
``inference``, ``predict``, ``inference_model`` and ``make_train_step``
all run under it.  Norm statistics and the losses stay in float32, as in
the JAX package.  ``bf16_full`` (bf16 parameters too) is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Union

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


_POLICIES = {
    "fp32": Policy(torch.float32, torch.float32, torch.float32),
    "float32": Policy(torch.float32, torch.float32, torch.float32),
    "bf16": Policy(torch.float32, torch.bfloat16, torch.float32),
    "bfloat16": Policy(torch.float32, torch.bfloat16, torch.float32),
    # bf16 parameters too, for inference-only deployments: not ported
    "bf16_full": Policy(torch.bfloat16, torch.bfloat16, torch.bfloat16),
}

_current_policy: Policy = _POLICIES["fp32"]


def get_policy() -> Policy:
    return _current_policy


def set_policy(policy: Union[str, Policy]) -> Policy:
    """Set the global dtype policy from a name or a ``Policy``;
    ``set_policy('bf16')`` is the schedule's ``amp=True``."""
    global _current_policy
    if isinstance(policy, str):
        policy = _POLICIES[policy]
    if not isinstance(policy, Policy):
        raise TypeError(f"policy must be a str or Policy, got {type(policy)}")
    if policy.param_dtype != torch.float32:
        raise NotImplementedError(
            "bf16 parameters (bf16_full) are not ported yet: ROADMAP.md, "
            "Queue 1")
    _current_policy = policy
    return policy


def amp_policy(amp: bool) -> Policy:
    """Map the schedule's boolean ``amp`` flag to a policy."""
    return set_policy("bf16" if amp else "fp32")


@contextlib.contextmanager
def policy_scope(policy: Union[str, Policy]):
    """Switch the global policy for the duration of a block."""
    global _current_policy
    prev = _current_policy
    set_policy(policy)
    try:
        yield _current_policy
    finally:
        _current_policy = prev


def compute_autocast(device_type: str):
    """The compute region of the current policy: ``torch.autocast`` to
    its compute dtype, or nothing when that is float32."""
    dtype = _current_policy.compute_dtype
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=dtype)
