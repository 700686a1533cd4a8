from .activations import ReLU  # noqa: F401
from .convolution import Conv2d  # noqa: F401
from .drop import Dropout2d  # noqa: F401
from .normalization import BatchNorm2d  # noqa: F401
