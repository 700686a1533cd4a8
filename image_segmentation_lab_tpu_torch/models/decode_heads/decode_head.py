"""BaseDecodeHead (counterpart of ``models/decode_heads/decode_head.py``).

* the ``in_channels``/``in_index``/``input_transform`` contract
  (``None``, ``'resize_concat'``, ``'multiple_select'``);
* binary segmentation: ``out_channels == 1`` with threshold default 0.3;
* ``loss_decode`` as a dict or a list of dicts, summed per ``loss_name``
  (default: softmax ``CrossEntropyLoss``);
* ``cls_seg``: ``Dropout2d`` then the 1x1 ``conv_seg`` classifier, whose
  default init is normal(0, 0.01) with a zero bias;
* ``forward_train`` returns ``(seg_logits, losses)``; ``losses()`` resizes
  the logits to the label size, applies each loss and ``acc_seg`` (a
  one-channel head's accuracy is taken against its threshold), then
  optionally rescales to ``ori_img_size_hw`` (a tuple for a uniform batch,
  a list for per-image sizes).

A pixel ``sampler`` (OHEM) is kept in the config but not ported: the
losses raise when one is set.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from ...utils.ops import resize
from ..basic.convolution import Conv2d
from ..basic.drop import Dropout2d
from ..builder import build_loss
from ..losses import accuracy

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
        if loss_decode is None:
            loss_decode = dict(type="CrossEntropyLoss", use_sigmoid=False,
                               loss_weight=1.0)
        if isinstance(loss_decode, Mapping):
            self.losses_decode = (build_loss(loss_decode),)
        elif isinstance(loss_decode, (list, tuple)):
            self.losses_decode = tuple(build_loss(c) for c in loss_decode)
        else:
            raise TypeError(f"loss_decode must be a dict or sequence of "
                            f"dict, but got {type(loss_decode)}")
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

    def forward_train(self, inputs, gt_semantic_seg, meta_infos=None,
                      rescale: bool = False):
        return self.losses(self(inputs), gt_semantic_seg, meta_infos,
                           rescale=rescale)

    def forward_test(self, inputs):
        return self(inputs)

    def losses(self, seg_logit, seg_label, meta_infos=None,
               rescale: bool = False):
        """``(logits, loss dict)``; ``seg_label`` is ``(N, H, W)``."""
        if self.sampler is not None:
            raise NotImplementedError(
                "pixel samplers (OHEM) are not ported yet (ROADMAP Queue 1)")
        seg_logit = resize(seg_logit, size=seg_label.shape[1:],
                           mode="bilinear", align_corners=self.align_corners)
        loss = {}
        for loss_decode in self.losses_decode:
            value = loss_decode(seg_logit, seg_label,
                                ignore_index=self.ignore_index)
            name = loss_decode.loss_name
            loss[name] = loss[name] + value if name in loss else value

        acc_logit = seg_logit
        if seg_logit.shape[1] == 1:
            # binary head: pair the logit with the threshold's logit so the
            # accuracy reflects sigmoid(x) > threshold
            t = self.resolved_threshold()
            acc_logit = torch.cat([torch.full_like(
                seg_logit, math.log(t / max(1.0 - t, 1e-8))), seg_logit],
                dim=1)
        loss["acc_seg"] = accuracy(acc_logit, seg_label,
                                   ignore_index=self.ignore_index)

        ori_img_size = (meta_infos or {}).get("ori_img_size_hw")
        if not (rescale and ori_img_size):
            return seg_logit, loss
        if isinstance(ori_img_size, tuple):
            return resize(seg_logit, size=ori_img_size, mode="bilinear",
                          align_corners=self.align_corners), loss
        if isinstance(ori_img_size, list):
            assert len(seg_logit) == len(ori_img_size)
            return [resize(seg_logit[i][None], size=tuple(size),
                           mode="bilinear", align_corners=self.align_corners)
                    for i, size in enumerate(ori_img_size)], loss
        raise TypeError(f"bad ori_img_size_hw {ori_img_size!r}")
