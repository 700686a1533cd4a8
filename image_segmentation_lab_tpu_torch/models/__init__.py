from . import basic  # noqa: F401  (imports register the layers)
from . import backbones, decode_heads, segmentors  # noqa: F401
from .builder import build_segmentor  # noqa: F401
