from .depthwise_separable_conv_module import \
    DepthwiseSeparableConvModule  # noqa: F401
from .non_local import NonLocal2d  # noqa: F401
from .res_layer import ResLayer  # noqa: F401
from .self_attention_block import SelfAttentionBlock  # noqa: F401
