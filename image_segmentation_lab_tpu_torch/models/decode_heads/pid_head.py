"""PIDHead, the three-logit head of PIDNet (counterpart of
``models/decode_heads/pid_head.py``).

It takes the backbone's ``(x_p, x_d, merged)`` triple.  At eval only the
merged 1/8 features run through ``i_head``; in training ``p_head`` and the
one-channel boundary head ``d_head`` run too, with four losses: the P
logits (``loss_sem_p``), the merged logits (``loss_sem_i``), the boundary
logits against the label's edge map (``loss_bd``), and the merged logits
again on the pixels the D branch calls boundary (``sigmoid(d) > 0.8``,
the rest ignored; ``loss_sem_bd``).  The head has no ``conv_seg``: each of
its ``_BasePIDHead`` blocks has its own classifier.

``boundary_from_label`` makes the edge map on the labels' device: a pixel
seeds an edge where it differs from its upper, left, upper-left or
upper-right neighbour and both are valid (four shifted comparisons,
masked where the shift wraps), and the seeds are dilated by an
``edge_width`` max window anchored as cv2.dilate anchors an even kernel
(``w // 2`` before, ``w - 1 - w // 2`` after).  The confident-boundary
mask is ``boundary_confident``, a module function looked up at call time,
so a replay can hand in a recorded mask.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..basic.convolution import Conv2d
from ..builder import build_norm_layer
from ..common.conv_module import ConvModule
from ..losses import accuracy
from .decode_head import BaseDecodeHead


def boundary_from_label(label, edge_width: int = 4,
                        ignore_index: int = 255):
    """``(N, H, W)`` integer labels -> ``(N, H, W)`` float32 {0, 1} edge
    map (see the module docstring)."""
    valid = label != ignore_index
    H, W = label.shape[1:]
    ii = torch.arange(H, device=label.device)[:, None]
    jj = torch.arange(W, device=label.device)[None, :]

    def shift_cmp(di: int, dj: int):
        nb = torch.roll(label, shifts=(-di, -dj), dims=(1, 2))
        nb_valid = torch.roll(valid, shifts=(-di, -dj), dims=(1, 2))
        inside = ((ii + di >= 0) & (ii + di < H)
                  & (jj + dj >= 0) & (jj + dj < W))
        return (label != nb) & valid & nb_valid & inside

    seeds = (shift_cmp(-1, 0) | shift_cmp(0, -1)
             | shift_cmp(-1, -1) | shift_cmp(-1, 1)).float()
    if edge_width <= 1:
        return seeds
    w = int(edge_width)
    lo, hi = w // 2, w - 1 - w // 2
    # every window holds its own pixel, so a zero pad equals the -inf one
    padded = F.pad(seeds[:, None], (lo, hi, lo, hi))
    return torch.max_pool2d(padded, w, stride=1)[:, 0]


def boundary_confident(logit_d, threshold: float):
    """``(N, H, W)`` bool: pixels whose boundary probability is above
    ``threshold``."""
    return torch.sigmoid(logit_d[:, 0]) > threshold


class _BasePIDHead(nn.Module):
    """BN -> ReLU -> 3 x 3 conv -> BN -> ReLU -> 1 x 1 classifier (the
    official PIDNet/DDRNet ``segmenthead`` block)."""

    def __init__(self, in_channels: int, channels: int, out_channels: int,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        ncfg = dict(norm_cfg or dict(type="BN"))
        self.conv = ConvModule(in_channels, channels, 3, padding=1,
                               norm_cfg=ncfg, act_cfg=dict(type="ReLU"),
                               order=("norm", "act", "conv"))
        self.norm = build_norm_layer(ncfg, channels)[1]
        self.cls = Conv2d(channels, out_channels, 1)

    def init_weights(self, generator):
        nn.init.normal_(self.cls.weight, 0.0, 0.01, generator=generator)
        nn.init.zeros_(self.cls.bias)

    def forward(self, x):
        return self.cls(F.relu(self.norm(self.conv(x))))


def rescaled(logit, meta_infos, rescale, align_corners):
    """``logit`` resized to a uniform batch's ``ori_img_size_hw`` when
    ``rescale`` asks for it."""
    size = (meta_infos or {}).get("ori_img_size_hw")
    if rescale and size and isinstance(size, tuple):
        return resize(logit, size=size, mode="bilinear",
                      align_corners=align_corners)
    return logit


@DECODEHEAD.register()
class PIDHead(BaseDecodeHead):
    """``in_channels``: the merged width (4C); the P and D taps are
    ``in_channels // 2`` wide."""

    def __init__(self, in_channels: int, channels: int, *,
                 edge_width: int = 4, bd_confidence: float = 0.8, **kwargs):
        super().__init__(in_channels, channels, **kwargs)
        assert len(self.losses_decode) == 4, (
            "PIDHead needs loss_decode=[sem_p, sem_i, boundary, sem_bd], "
            f"got {len(self.losses_decode)}")
        del self.conv_seg
        self.edge_width = edge_width
        self.bd_confidence = bd_confidence
        ncfg = dict(self.norm_cfg or dict(type="BN"))
        out_ch = self.resolved_out_channels()
        self.i_head = _BasePIDHead(in_channels, channels, out_ch, ncfg)
        self.p_head = _BasePIDHead(in_channels // 2, channels // 2, out_ch,
                                   ncfg)
        self.d_head = _BasePIDHead(in_channels // 2, in_channels // 4, 1,
                                   ncfg)

    def init_weights(self, generator):
        pass  # the classifiers are the blocks' own

    def forward(self, inputs):
        x = inputs[-1] if isinstance(inputs, (list, tuple)) else inputs
        return self.i_head(x)

    def forward_train(self, inputs, gt_semantic_seg, meta_infos=None,
                      rescale: bool = False):
        assert isinstance(inputs, (list, tuple)) and len(inputs) == 3, (
            "PIDHead expects the PIDNet (x_p, x_d, merged) triple")
        x_p, x_d, x = inputs
        label = gt_semantic_seg
        up = dict(size=label.shape[1:], mode="bilinear",
                  align_corners=self.align_corners)
        logit_i = resize(self.i_head(x), **up)
        logit_p = resize(self.p_head(x_p), **up)
        logit_d = resize(self.d_head(x_d), **up)

        sem_p, sem_i, bd, sem_bd = self.losses_decode
        ignore = self.ignore_index
        loss = dict(
            loss_sem_p=sem_p(logit_p, label, ignore_index=ignore),
            loss_sem_i=sem_i(logit_i, label, ignore_index=ignore),
            loss_bd=bd(logit_d, boundary_from_label(label, self.edge_width,
                                                    ignore)))
        masked = torch.where(boundary_confident(logit_d, self.bd_confidence),
                             label, ignore)
        loss["loss_sem_bd"] = sem_bd(logit_i, masked, ignore_index=ignore)
        loss["acc_seg"] = accuracy(logit_i, label, ignore_index=ignore)
        return rescaled(logit_i, meta_infos, rescale,
                        self.align_corners), loss
