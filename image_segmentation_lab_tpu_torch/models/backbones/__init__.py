from .beit import BEiT  # noqa: F401
from .convnext import ConvNeXt  # noqa: F401
from .ddrnet import DAPPM, DDRNet  # noqa: F401
from .mae import MAE  # noqa: F401
from .mit import MixVisionTransformer  # noqa: F401
from .mscan import MSCAN  # noqa: F401
from .pidnet import PAPPM, Bag, LightBag, PagFM, PIDNet  # noqa: F401
from .poolformer import PoolFormer  # noqa: F401
from .resnet import (BasicBlock, Bottleneck, ResNet, ResNetV1c,  # noqa: F401
                     ResNetV1d)
from .swin import SwinTransformer  # noqa: F401
from .twins import PCPVT, SVT  # noqa: F401
from .vit import VisionTransformer  # noqa: F401
