"""BaseDecodeHead, inference part (counterpart of
``models/decode_heads/decode_head.py``).

* the ``in_channels``/``in_index``/``input_transform`` contract
  (``None``, ``'resize_concat'``, ``'multiple_select'``);
* binary segmentation: ``out_channels == 1`` with threshold default 0.3;
* ``cls_seg``: ``Dropout2d`` then the 1x1 ``conv_seg`` classifier, whose
  default init is normal(0, 0.01) with a zero bias.

The head keeps its ``loss_decode``/``sampler`` config, but losses and
``forward_train`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from ...utils.ops import resize
from ..basic.convolution import Conv2d
from ..basic.drop import Dropout2d

DEFAULT_ACT = object()
DEFAULT_BINARY_THRESHOLD = 0.3


class BaseDecodeHead(nn.Module):

    def __init__(self,
                 in_channels: Union[int, Sequence[int]],
                 channels: int,
                 *,
                 num_classes: int,
                 out_channels: Optional[int] = None,
                 threshold: Optional[float] = None,
                 dropout_ratio: float = 0.1,
                 conv_cfg: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None,
                 act_cfg: Any = DEFAULT_ACT,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 loss_decode: Any = None,
                 ignore_index: int = 255,
                 sampler: Optional[Dict] = None,
                 align_corners: bool = False,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        if input_transform is not None:
            assert input_transform in ("resize_concat", "multiple_select")
            assert isinstance(in_channels, (list, tuple))
            assert isinstance(in_index, (list, tuple))
            assert len(in_channels) == len(in_index)
        else:
            assert isinstance(in_channels, int)
            assert isinstance(in_index, int)
        self.in_channels = in_channels
        self.channels = channels
        self.num_classes = num_classes
        self.out_channels = out_channels
        self.threshold = threshold
        self.conv_cfg = conv_cfg
        self.norm_cfg = norm_cfg
        self.act_cfg = dict(type="ReLU") if act_cfg is DEFAULT_ACT else act_cfg
        self.in_index = in_index
        self.input_transform = input_transform
        self.loss_decode = loss_decode
        self.ignore_index = ignore_index
        self.sampler = sampler
        self.align_corners = align_corners
        self.conv_seg = Conv2d(channels, self.resolved_out_channels(), 1)
        self.dropout = Dropout2d(dropout_ratio) if dropout_ratio > 0 else None

    def resolved_out_channels(self) -> int:
        if self.out_channels is None:
            return self.num_classes
        if self.out_channels not in (self.num_classes, 1):
            raise ValueError(
                "out_channels should equal num_classes, except binary "
                f"segmentation with out_channels == 1; got "
                f"out_channels={self.out_channels}, "
                f"num_classes={self.num_classes}")
        return self.out_channels

    def resolved_threshold(self) -> float:
        return (DEFAULT_BINARY_THRESHOLD if self.threshold is None
                else self.threshold)

    @property
    def fused_in_channels(self) -> int:
        """in_channels after the input transform."""
        if self.input_transform == "resize_concat":
            return sum(self.in_channels)
        return self.in_channels

    def init_weights(self, generator):
        nn.init.normal_(self.conv_seg.weight, 0.0, 0.01, generator=generator)
        nn.init.zeros_(self.conv_seg.bias)

    def _transform_inputs(self, inputs):
        """Select / fuse backbone features."""
        if self.input_transform == "resize_concat":
            selected = [inputs[i] for i in self.in_index]
            return torch.cat([resize(x, size=selected[0].shape[2:],
                                     mode="bilinear",
                                     align_corners=self.align_corners)
                              for x in selected], dim=1)
        if self.input_transform == "multiple_select":
            return [inputs[i] for i in self.in_index]
        if not isinstance(inputs, (list, tuple)):
            # single-tap backbones return the bare feature map; indexing it
            # with in_index would slice the batch axis
            return inputs
        return inputs[self.in_index]

    def cls_seg(self, feat):
        """Dropout + 1x1 classifier."""
        if self.dropout is not None:
            feat = self.dropout(feat)
        return self.conv_seg(feat)

    def forward_test(self, inputs):
        return self(inputs)
