from .resnet import BasicBlock, Bottleneck, ResNet, ResNetV1c  # noqa: F401
