from .conv_module import ConvModule  # noqa: F401
