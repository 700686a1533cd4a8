"""ResNet / ResNetV1c / ResNetV1d backbones (counterpart of
``models/backbones/resnet.py``).

* ``BasicBlock`` (expansion 1) and ``Bottleneck`` (expansion 4, stride on
  the 3x3 conv for ``style='pytorch'``, on the first 1x1 for ``'caffe'``);
* 7x7 stem, or the ``deep_stem`` of three 3x3 convs (V1c), then a 3/2/1
  max pool;
* per-stage ``strides``/``dilations``, ``multi_grid`` on the last stage and
  ``contract_dilation`` (output stride 8 with strides (1, 2, 1, 1) and
  dilations (1, 1, 2, 4));
* ``avg_down`` (V1d): a strided block's shortcut averages ``stride x
  stride`` windows (``ops/pooling.avg_pool2d``, ``ceil_mode=True``,
  ``count_include_pad=False``) before a stride-1 1 x 1 conv;
* ``norm_eval`` keeps every batch norm on its running statistics;
* default init: kaiming (fan_out) convs, unit norms, and with
  ``zero_init_residual`` the last norm of each block at zero, but only when
  neither ``pretrained`` nor ``init_cfg`` is set.

Submodule names follow the JAX parameter tree: ``stem_<i>`` (here the
``stem`` list), ``layer<i>.blocks_<j>``, ``downsample_conv``/
``downsample_bn``.  Frozen stages, plugins and activation checkpointing are
training features that later work ports; they raise here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import BACKBONE
from ...ops.pooling import avg_pool2d
from ..builder import build_conv_layer, build_norm_layer
from ..utils.res_layer import ResLayer


class _Block(nn.Module):
    """Shared downsample branch, residual sum and zero-init of the last
    norm (named ``last_norm`` by the subclass)."""

    expansion = 1
    last_norm = ""

    def _build_downsample(self, conv_cfg, norm_cfg, inplanes, planes, stride,
                          avg_down=False):
        self.has_downsample = stride != 1 or inplanes != planes * self.expansion
        self.avg_stride = stride if avg_down and stride != 1 else 0
        if self.has_downsample:
            self.downsample_conv = build_conv_layer(
                conv_cfg, inplanes, planes * self.expansion, 1,
                stride=1 if self.avg_stride else stride, bias=False)
            self.downsample_bn = build_norm_layer(
                norm_cfg, planes * self.expansion)[1]

    def _residual(self, x, out):
        identity = x
        if self.avg_stride:
            identity = avg_pool2d(identity, self.avg_stride, self.avg_stride,
                                  ceil_mode=True, count_include_pad=False)
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)

    def init_weights(self, generator):
        if self.zero_init_residual:
            nn.init.zeros_(getattr(self, self.last_norm).weight)


class BasicBlock(_Block):
    expansion = 1
    last_norm = "bn2"

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, style: str = "pytorch",
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 zero_init_residual: bool = False,
                 avg_down: bool = False):
        super().__init__()
        self.zero_init_residual = zero_init_residual
        self.conv1 = build_conv_layer(conv_cfg, inplanes, planes, 3,
                                      stride=stride, padding=dilation,
                                      dilation=dilation, bias=False)
        self.bn1 = build_norm_layer(norm_cfg, planes, postfix=1)[1]
        self.conv2 = build_conv_layer(conv_cfg, planes, planes, 3, padding=1,
                                      bias=False)
        self.bn2 = build_norm_layer(norm_cfg, planes, postfix=2)[1]
        self._build_downsample(conv_cfg, norm_cfg, inplanes, planes, stride,
                               avg_down)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return self._residual(x, self.bn2(self.conv2(out)))


class Bottleneck(_Block):
    expansion = 4
    last_norm = "bn3"

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, style: str = "pytorch",
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 zero_init_residual: bool = False,
                 avg_down: bool = False):
        super().__init__()
        if style not in ("pytorch", "caffe"):
            raise ValueError(f"unknown ResNet style {style!r}")
        self.zero_init_residual = zero_init_residual
        conv1_stride = 1 if style == "pytorch" else stride
        conv2_stride = stride if style == "pytorch" else 1
        self.conv1 = build_conv_layer(conv_cfg, inplanes, planes, 1,
                                      stride=conv1_stride, bias=False)
        self.bn1 = build_norm_layer(norm_cfg, planes, postfix=1)[1]
        self.conv2 = build_conv_layer(conv_cfg, planes, planes, 3,
                                      stride=conv2_stride, padding=dilation,
                                      dilation=dilation, bias=False)
        self.bn2 = build_norm_layer(norm_cfg, planes, postfix=2)[1]
        self.conv3 = build_conv_layer(conv_cfg, planes,
                                      planes * self.expansion, 1, bias=False)
        self.bn3 = build_norm_layer(norm_cfg, planes * self.expansion,
                                    postfix=3)[1]
        self._build_downsample(conv_cfg, norm_cfg, inplanes, planes, stride,
                               avg_down)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return self._residual(x, self.bn3(self.conv3(out)))


class NormEval:
    """``train()`` keeps every batch norm on its running statistics when
    the backbone's ``norm_eval`` is set."""

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self


@BACKBONE.register()
class ResNet(NormEval, nn.Module):
    """ResNet backbone returning the stage features selected by
    ``out_indices``; see the module docstring."""

    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }

    def __init__(self,
                 depth: int = 50,
                 in_channels: int = 3,
                 stem_channels: int = 64,
                 base_channels: int = 64,
                 num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = "pytorch",
                 deep_stem: bool = False,
                 avg_down: bool = False,
                 frozen_stages: int = -1,
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 norm_eval: bool = False,
                 dcn: Optional[Dict] = None,
                 plugins: Optional[list] = None,
                 multi_grid: Optional[Sequence[int]] = None,
                 contract_dilation: bool = False,
                 with_cp: bool = False,
                 zero_init_residual: bool = True,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        if depth not in self.arch_settings:
            raise KeyError(f"invalid depth {depth} for resnet")
        unported = dict(frozen_stages=frozen_stages >= 0,
                        dcn=dcn is not None, plugins=plugins is not None,
                        with_cp=with_cp)
        if any(unported.values()):
            raise NotImplementedError(
                "not ported yet: "
                + ", ".join(k for k, v in unported.items() if v))
        assert 1 <= num_stages <= 4
        assert len(strides) == len(dilations) == num_stages
        assert max(out_indices) < num_stages
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.deep_stem = deep_stem
        block, stage_blocks = self.arch_settings[depth]
        norm_cfg = norm_cfg or dict(type="BN", requires_grad=True)

        if self.deep_stem:
            c = stem_channels
            stem = []
            for cin, cout, s in ((in_channels, c // 2, 2), (c // 2, c // 2, 1),
                                 (c // 2, c, 1)):
                stem.append(build_conv_layer(conv_cfg, cin, cout, 3, stride=s,
                                             padding=1, bias=False))
                stem.append(build_norm_layer(norm_cfg, cout)[1])
            self.stem = nn.ModuleList(stem)
        else:
            self.conv1 = build_conv_layer(conv_cfg, in_channels, stem_channels,
                                          7, stride=2, padding=3, bias=False)
            self.bn1 = build_norm_layer(norm_cfg, stem_channels, postfix=1)[1]

        self.layer_names = []
        inplanes = stem_channels
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = base_channels * 2 ** i
            name = f"layer{i + 1}"
            self.add_module(name, ResLayer(
                block=block, inplanes=inplanes, planes=planes,
                num_blocks=num_blocks, stride=strides[i],
                dilation=dilations[i], conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                multi_grid=multi_grid if i == num_stages - 1 else None,
                contract_dilation=contract_dilation,
                block_kwargs=dict(
                    style=style, avg_down=avg_down,
                    zero_init_residual=(zero_init_residual
                                        and pretrained is None
                                        and init_cfg is None))))
            self.layer_names.append(name)
            inplanes = planes * block.expansion

    def forward_stem(self, x):
        if self.deep_stem:
            for i in range(0, len(self.stem), 2):
                x = F.relu(self.stem[i + 1](self.stem[i](x)))
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def forward(self, x):
        x = self.forward_stem(x)
        outs = []
        for i, name in enumerate(self.layer_names):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)



@BACKBONE.register()
class ResNetV1c(ResNet):
    """ResNet with the 3x3 deep stem."""

    def __init__(self, **kwargs):
        kwargs.setdefault("deep_stem", True)
        super().__init__(**kwargs)


@BACKBONE.register()
class ResNetV1d(ResNet):
    """ResNet with the 3x3 deep stem and averaged shortcuts."""

    def __init__(self, **kwargs):
        kwargs.setdefault("deep_stem", True)
        kwargs.setdefault("avg_down", True)
        super().__init__(**kwargs)
