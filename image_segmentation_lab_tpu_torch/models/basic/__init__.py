from .activations import ReLU  # noqa: F401
from .convolution import (Conv2d, ConvTranspose2d, Linear,  # noqa: F401
                          PointwiseLinear)
from .drop import Dropout, Dropout2d, DropPath  # noqa: F401
from .normalization import BatchNorm2d, LayerNorm  # noqa: F401
