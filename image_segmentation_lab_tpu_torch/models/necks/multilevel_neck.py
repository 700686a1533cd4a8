"""MultiLevelNeck, the "MLN" adapter of UPerNet-ViT (counterpart of
``models/necks/multilevel_neck.py``).

A 1 x 1 lateral ``ConvModule`` per tap (a single tap is shared by every
scale), a bilinear resize of each level by its scale factor (4, 2, 1, 0.5
turn four stride-16 taps into a 4/8/16/32 pyramid), then a 3 x 3
``ConvModule``.  The resize takes the factor, not a size: ``int(H·s)``
rows read at step ``1/s`` (``utils/ops.resize``), so at 0.5 an odd grid
(25 at 400²) gives 12 rows at step 2.  Submodules carry the JAX names
``lateral_convs_<i>`` and ``convs_<i>``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from ...core.registry_hub import NECK
from ...utils.ops import resize
from ..common.conv_module import ConvModule


@NECK.register()
class MultiLevelNeck(nn.Module):

    def __init__(self, in_channels: Sequence[int],
                 out_channels: int = 256,
                 scales: Sequence[float] = (0.5, 1, 2, 4),
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Any = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        assert isinstance(in_channels, (list, tuple))
        self.scales = tuple(scales)
        kw = dict(norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, **kw) for c in in_channels)
        self.convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1, **kw)
            for _ in self.scales)

    def forward(self, inputs):
        assert len(inputs) == len(self.lateral_convs), (
            f"MultiLevelNeck expects {len(self.lateral_convs)} input "
            f"levels, got {len(inputs)}")
        feats = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        if len(feats) == 1:
            feats = feats * len(self.scales)
        outs = []
        for feat, scale, conv in zip(feats, self.scales, self.convs):
            if scale != 1:
                feat = resize(feat, scale_factor=scale, mode="bilinear",
                              align_corners=False)
            outs.append(conv(feat))
        return tuple(outs)
