"""MLA neck of SETR-MLA (counterpart of ``models/necks/mla_neck.py``).

Each tapped level's channels are layer-normalised (eps 1e-6 by default, the
norm over C of an NCHW map), then ``MLAModule``: a 1 x 1 ``ConvModule``
per level, the top-down cumulative sums from the deepest level, and a
3 x 3 ``ConvModule`` on each sum.  Submodules carry the JAX names:
``norms_<i>``, ``mla.channel_proj_<i>``, ``mla.feat_extract_<i>``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from ...core.registry_hub import NECK
from ..builder import build_norm_layer
from ..common.conv_module import ConvModule


class MLAModule(nn.Module):
    """1 x 1 projections, reversed cumulative sums, 3 x 3 convs."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.channel_proj = nn.ModuleList(
            ConvModule(c, out_channels, 1, **kw) for c in in_channels)
        self.feat_extract = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1, **kw)
            for _ in in_channels)

    def forward(self, inputs):
        feats = [conv(x) for x, conv in zip(inputs, self.channel_proj)]
        mids = []
        for feat in feats[::-1]:  # deepest level first
            mids.append(feat if not mids else mids[-1] + feat)
        return tuple(conv(mid) for mid, conv in zip(mids, self.feat_extract))


@NECK.register()
class MLANeck(nn.Module):

    def __init__(self, in_channels: Sequence[int],
                 out_channels: int = 256,
                 norm_layer: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Optional[Dict] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        assert isinstance(in_channels, (list, tuple))
        norm_layer = dict(norm_layer or dict(type="LayerNorm", eps=1e-6,
                                             requires_grad=True))
        self.norms = nn.ModuleList(
            build_norm_layer(dict(norm_layer), c, postfix=i)[1]
            for i, c in enumerate(in_channels))
        self.mla = MLAModule(in_channels, out_channels, norm_cfg=norm_cfg,
                             act_cfg=act_cfg)

    def forward(self, inputs):
        assert len(inputs) == len(self.norms)
        # contiguous NCHW again, as SETRUPHead's input norm leaves it
        outs = [norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).contiguous()
                for norm, x in zip(self.norms, inputs)]
        return self.mla(outs)
