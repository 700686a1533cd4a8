from .accuracy import accuracy  # noqa: F401
from .boundary_loss import BoundaryLoss  # noqa: F401
from .cross_entropy_loss import (CrossEntropyLoss,  # noqa: F401
                                 binary_cross_entropy, cross_entropy,
                                 mask_cross_entropy)
from .ohem_cross_entropy import OhemCrossEntropy  # noqa: F401
from .utils import (get_class_weight, reduce_loss,  # noqa: F401
                    weight_reduce_loss)
