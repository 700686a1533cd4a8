"""Feature Pyramid Network neck (counterpart of ``models/necks/fpn.py``).

1 x 1 lateral ``ConvModule``s on the levels from ``start_level`` to
``end_level``, the top-down sums through a nearest resize to the next
finer level's size (the JAX rule, ``utils/ops.resize``: two index
selections, whose backward is ``index_select``'s, an index add), 3 x 3
output ``ConvModule``s, and with ``num_outs`` above the levels used,
extra levels as max pools of window 1 and stride 2 of the last output
(``ops/pooling.max_pool2d``).  Submodules carry the JAX names
``lateral_convs_<i>`` and ``fpn_convs_<i>``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from ...core.registry_hub import NECK
from ...ops.pooling import max_pool2d
from ...utils.ops import resize
from ..common.conv_module import ConvModule


@NECK.register()
class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int],
                 out_channels: int = 256,
                 num_outs: Optional[int] = None,
                 start_level: int = 0,
                 end_level: int = -1,
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Any = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        assert isinstance(in_channels, (list, tuple))
        self.num_inputs = len(in_channels)
        end = len(in_channels) if end_level == -1 else end_level + 1
        self.used_levels = list(range(start_level, end))
        self.num_outs = num_outs
        if num_outs is not None:
            assert num_outs >= len(self.used_levels), (
                f"num_outs={num_outs} < {len(self.used_levels)} used levels")
        kw = dict(conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i], out_channels, 1, **kw)
            for i in self.used_levels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1, **kw)
            for _ in self.used_levels)

    def forward(self, inputs):
        assert len(inputs) == self.num_inputs, (
            f"FPN expects {self.num_inputs} input levels, got {len(inputs)}")
        laterals = [conv(inputs[i])
                    for conv, i in zip(self.lateral_convs, self.used_levels)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest")
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        for _ in range((self.num_outs or len(outs)) - len(outs)):
            outs.append(max_pool2d(outs[-1], 1, 2))
        return tuple(outs)
