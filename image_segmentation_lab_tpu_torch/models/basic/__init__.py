from .activations import ReLU  # noqa: F401
from .convolution import Conv2d, Linear, PointwiseLinear  # noqa: F401
from .drop import Dropout, Dropout2d, DropPath  # noqa: F401
from .normalization import BatchNorm2d, LayerNorm  # noqa: F401
