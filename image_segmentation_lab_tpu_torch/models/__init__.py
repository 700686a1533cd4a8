from . import basic  # noqa: F401  (imports register the layers)
from . import backbones, decode_heads, losses, segmentors  # noqa: F401
from .builder import build_loss, build_segmentor  # noqa: F401
