from .policy import (Policy, amp_policy, compute_autocast,
                     float32_precision, get_policy, policy_scope, set_policy)

__all__ = ["Policy", "amp_policy", "compute_autocast", "float32_precision",
           "get_policy", "policy_scope", "set_policy"]
