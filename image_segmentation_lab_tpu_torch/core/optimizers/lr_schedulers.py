"""LR scheduler registry (counterpart of ``core/optimizers/lr_schedulers.py``).

As in the JAX package, a scheduler holds an epoch rule
(``lr_at_epoch(epoch, base_lr)``) and ``schedule(base_lr, steps_per_epoch)``
lowers it to a function of the global step with ``epoch = step //
steps_per_epoch``.  ``torch_scheduler(optimizer, steps_per_epoch)`` applies
that function through ``torch.optim.lr_scheduler.LambdaLR``: stepped once
per train step, after the optimizer, so update ``i`` (from 0) runs at the
rate of step ``i``, as optax evaluates a schedule at the update count.
Unknown config keys are ignored, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..registry_hub import LR_SCHEDULER


class EpochSchedule:
    """Base: subclasses define ``lr_at_epoch(epoch, base_lr) -> float``."""

    def lr_at_epoch(self, epoch: int, base_lr: float) -> float:
        raise NotImplementedError

    def schedule(self, base_lr: float, steps_per_epoch: int) -> Callable:
        """The rate as a function of the global step."""
        def fn(step):
            return self.lr_at_epoch(int(step) // max(steps_per_epoch, 1),
                                    base_lr)
        return fn

    def torch_scheduler(self, optimizer: torch.optim.Optimizer,
                        steps_per_epoch: int):
        """A ``LambdaLR`` giving each param group ``schedule(its lr)``."""
        def factor(base_lr):
            fn = self.schedule(base_lr, steps_per_epoch)
            return lambda step: fn(step) / base_lr if base_lr else 0.0
        return torch.optim.lr_scheduler.LambdaLR(
            optimizer, [factor(g["lr"]) for g in optimizer.param_groups])


@LR_SCHEDULER.register("StepLR")
class StepLR(EpochSchedule):
    def __init__(self, step_size: int, gamma: float = 0.1, **kwargs):
        self.step_size = step_size
        self.gamma = gamma

    def lr_at_epoch(self, epoch, base_lr):
        return base_lr * self.gamma ** (epoch // self.step_size)


@LR_SCHEDULER.register("PolynomialLR")
class PolynomialLR(EpochSchedule):
    def __init__(self, total_iters: int = 5, power: float = 1.0, **kwargs):
        self.total_iters = total_iters
        self.power = power

    def lr_at_epoch(self, epoch, base_lr):
        frac = min(epoch, self.total_iters) / self.total_iters
        return base_lr * (1.0 - frac) ** self.power


@LR_SCHEDULER.register("ExponentialLR")
class ExponentialLR(EpochSchedule):
    def __init__(self, gamma: float, **kwargs):
        self.gamma = gamma

    def lr_at_epoch(self, epoch, base_lr):
        return base_lr * self.gamma ** epoch


@LR_SCHEDULER.register("LambdaLR")
class LambdaLR(EpochSchedule):
    def __init__(self, lr_lambda: Callable, **kwargs):
        self.lr_lambda = lr_lambda

    def lr_at_epoch(self, epoch, base_lr):
        return base_lr * self.lr_lambda(epoch)


@LR_SCHEDULER.register("WarmScheduler")
class WarmScheduler(EpochSchedule):
    """Linear or exponential warmup from ``start_lr`` (default
    ``base_lr * warmup_ratio``) to ``end_lr`` (default ``base_lr``) over
    ``warmup_epochs`` (alias ``warmup_iters``), then the base rate, or the
    ``after`` scheduler counted from the end of the warmup."""

    def __init__(self, warmup_epochs: Optional[int] = None,
                 warmup_iters: Optional[int] = None, mode: str = "linear",
                 warmup_ratio: Optional[float] = None,
                 start_ratio: Optional[float] = None,
                 start_lr: Optional[float] = None,
                 end_lr: Optional[float] = None,
                 after: Optional[dict] = None, **kwargs):
        assert mode in ("linear", "exp", "exponential"), (
            f"Unsupported warmup mode: {mode}")
        self.mode = "exp" if mode == "exponential" else mode
        w = warmup_iters if warmup_iters is not None else warmup_epochs
        self.warmup_epochs = int(w) if w is not None else 1
        r = start_ratio if start_ratio is not None else warmup_ratio
        self.warmup_ratio = 0.1 if r is None else float(r)
        self.start_lr = start_lr
        self.end_lr = end_lr
        if after is not None:
            from ..builder import build_from_cfg
            self.after = build_from_cfg(after, LR_SCHEDULER)
        else:
            self.after = None

    def lr_at_epoch(self, epoch, base_lr):
        if epoch >= self.warmup_epochs:
            if self.after is None:
                return base_lr
            return self.after.lr_at_epoch(epoch - self.warmup_epochs,
                                          base_lr)
        start = (self.start_lr if self.start_lr is not None
                 else base_lr * self.warmup_ratio)
        end = self.end_lr if self.end_lr is not None else base_lr
        frac = min(max(epoch / self.warmup_epochs, 0.0), 1.0)
        if self.mode == "linear":
            return (end - start) * frac + start
        return start * (end / max(start, 1e-12)) ** frac
