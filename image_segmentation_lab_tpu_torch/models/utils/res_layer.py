"""ResLayer — one ResNet stage (counterpart of ``models/utils/res_layer.py``).

The first block carries the stride and the downsample branch (built inside
the block, as in the JAX package); ``multi_grid`` overrides the per-block
dilations of the last stage; ``contract_dilation`` halves the first block's
dilation.  Blocks live in ``blocks`` (JAX parameter path ``blocks_<i>``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Type

from torch import nn


class ResLayer(nn.Module):

    def __init__(self,
                 block: Type[nn.Module],
                 inplanes: int,
                 planes: int,
                 num_blocks: int,
                 stride: int = 1,
                 dilation: int = 1,
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 multi_grid: Optional[Sequence[int]] = None,
                 contract_dilation: bool = False,
                 block_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        if multi_grid is not None:
            dilations = list(multi_grid)
        else:
            first = (dilation // 2 if dilation > 1 and contract_dilation
                     else dilation)
            dilations = [first] + [dilation] * (num_blocks - 1)
        blocks = []
        for i in range(num_blocks):
            blocks.append(block(
                inplanes=inplanes if i == 0 else planes * block.expansion,
                planes=planes, stride=stride if i == 0 else 1,
                dilation=dilations[i], conv_cfg=conv_cfg,
                norm_cfg=norm_cfg or dict(type="BN"),
                **(block_kwargs or {})))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x
