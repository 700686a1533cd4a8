from .mit import MixVisionTransformer  # noqa: F401
from .resnet import BasicBlock, Bottleneck, ResNet, ResNetV1c  # noqa: F401
from .vit import VisionTransformer  # noqa: F401
