from . import lr_schedulers, optimizers  # noqa: F401  (registration)
from .lr_schedulers import (EpochSchedule, ExponentialLR,  # noqa: F401
                            LambdaLR, PolynomialLR, StepLR, WarmScheduler)
