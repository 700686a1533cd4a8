from .beit import BEiT  # noqa: F401
from .convnext import ConvNeXt  # noqa: F401
from .mae import MAE  # noqa: F401
from .mit import MixVisionTransformer  # noqa: F401
from .resnet import BasicBlock, Bottleneck, ResNet, ResNetV1c  # noqa: F401
from .swin import SwinTransformer  # noqa: F401
from .vit import VisionTransformer  # noqa: F401
