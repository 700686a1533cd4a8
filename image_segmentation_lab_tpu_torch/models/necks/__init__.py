from .featurepyramid import Feature2Pyramid  # noqa: F401
from .fpn import FPN  # noqa: F401
from .mla_neck import MLAModule, MLANeck  # noqa: F401
from .multilevel_neck import MultiLevelNeck  # noqa: F401
