"""EncoderDecoder segmentor, inference part (counterpart of
``models/segmentors/encoder_decoder.py``).

Slide inference keeps the JAX design: the static, edge-clamped window grid
is computed on the host, all windows of the batch go through ONE batched
``encode_decode`` call, and the window logits are summed back onto the
canvas (in place) and divided by a count map computed on the host.

Submodules are named ``backbone``, ``neck``, ``decode_head`` and
``auxiliary_head`` (a list of aux heads: ``auxiliary_head.<i>``, JAX path
``auxiliary_head_<i>``), as in the JAX parameter tree.  ``forward`` is
``inference``; ``forward_train`` returns ``({'decode': ..., 'aux': ...},
{'decode.loss_ce': ..., 'aux.loss_ce': ..., ...})`` (a list of aux heads
gives ``aux_<i>`` keys).  Test-time augmentation (with the train/test
dispatch of the JAX ``BaseSegmentor``) and panoptic/instance output are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...core.registry_hub import BACKBONE, DECODEHEAD, NECK, SEGMENTOR
from ...utils.ops import add_prefix, resize
from ..builder import build_module_from_cfg


def slide_window_origins(h_img: int, w_img: int, h_crop: int, w_crop: int,
                         h_stride: int, w_stride: int):
    """Static edge-clamped window grid: ``(origins, h_crop, w_crop)``."""
    h_crop, w_crop = min(h_crop, h_img), min(w_crop, w_img)
    h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
    w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
    origins = []
    for h_idx in range(h_grids):
        for w_idx in range(w_grids):
            y1 = min(h_idx * h_stride + h_crop, h_img) - h_crop
            x1 = min(w_idx * w_stride + w_crop, w_img) - w_crop
            origins.append((max(y1, 0), max(x1, 0)))
    return origins, h_crop, w_crop


def gather_windows(img, origins, h_crop: int, w_crop: int):
    """Stack all slide windows into one (n_win·N, C, h_crop, w_crop) batch,
    window-major."""
    return torch.cat([img[:, :, y1:y1 + h_crop, x1:x1 + w_crop]
                      for y1, x1 in origins], dim=0)


def stitch_windows(crop_logits, origins, h_crop: int, w_crop: int,
                   batch_size: int, h_img: int, w_img: int):
    """Overlap-average window logits back onto the full canvas."""
    preds = crop_logits.new_zeros(
        (batch_size, crop_logits.shape[1], h_img, w_img))
    count = np.zeros((1, 1, h_img, w_img), np.float32)
    for i, (y1, x1) in enumerate(origins):
        preds[:, :, y1:y1 + h_crop, x1:x1 + w_crop] += \
            crop_logits[i * batch_size:(i + 1) * batch_size]
        count[:, :, y1:y1 + h_crop, x1:x1 + w_crop] += 1
    assert (count == 0).sum() == 0  # the grid covers the canvas
    return preds * torch.from_numpy(1.0 / count).to(preds.device)


@SEGMENTOR.register()
class EncoderDecoder(nn.Module):

    def __init__(self,
                 backbone: Dict,
                 decode_head: Dict,
                 neck: Optional[Dict] = None,
                 auxiliary_head: Optional[Any] = None,
                 with_aux: bool = True,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[Any] = None):
        super().__init__()
        assert not (init_cfg and pretrained), \
            "init_cfg and pretrained cannot be setting at the same time"
        if pretrained is not None:
            assert backbone.get("pretrained") is None, \
                "both backbone and segmentor set pretrained weight"
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.pretrained = pretrained
        self.init_cfg = init_cfg
        self.backbone = build_module_from_cfg(backbone, BACKBONE)
        self.neck = (build_module_from_cfg(neck, NECK)
                     if neck is not None else None)
        self.decode_head = build_module_from_cfg(decode_head, DECODEHEAD)
        self.auxiliary_head = None
        if with_aux and auxiliary_head:
            if isinstance(auxiliary_head, (list, tuple)):
                self.auxiliary_head = nn.ModuleList(
                    build_module_from_cfg(cfg, DECODEHEAD)
                    for cfg in auxiliary_head)
            else:
                self.auxiliary_head = build_module_from_cfg(auxiliary_head,
                                                            DECODEHEAD)
        self.align_corners = self.decode_head.align_corners
        self.num_classes = self.decode_head.num_classes
        self.out_channels = self.decode_head.resolved_out_channels()

    def extract_feat(self, img):
        x = self.backbone(img)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def encode_decode(self, img):
        """Backbone + decode head + bilinear resize to the input size."""
        out = self.decode_head.forward_test(self.extract_feat(img))
        return resize(out, size=img.shape[2:], mode="bilinear",
                      align_corners=self.align_corners)

    def forward_train(self, img, gt_semantic_seg, meta_infos=None,
                      rescale: bool = False):
        """Logits and losses of the decode head and every aux head."""
        x = self.extract_feat(img)
        seg_logits, losses = {}, {}
        seg_logits["decode"], loss = self.decode_head.forward_train(
            x, gt_semantic_seg, meta_infos, rescale=rescale)
        losses.update(add_prefix(loss, "decode"))
        if isinstance(self.auxiliary_head, nn.ModuleList):
            seg_logits["aux"] = {}
            for idx, head in enumerate(self.auxiliary_head):
                seg_logits["aux"][idx], loss = head.forward_train(
                    x, gt_semantic_seg, meta_infos, rescale=rescale)
                losses.update(add_prefix(loss, f"aux_{idx}"))
        elif self.auxiliary_head is not None:
            seg_logits["aux"], loss = self.auxiliary_head.forward_train(
                x, gt_semantic_seg, meta_infos, rescale=rescale)
            losses.update(add_prefix(loss, "aux"))
        return seg_logits, losses

    def _rescale(self, seg_logit, ori_img_size, rescale):
        if rescale and ori_img_size is not None:
            seg_logit = resize(seg_logit, size=tuple(ori_img_size),
                               mode="bilinear",
                               align_corners=self.align_corners,
                               warning=False)
        return seg_logit

    def slide_inference(self, img, ori_img_size=None, rescale: bool = True):
        """Batched overlap-stitch sliding window (see module docstring)."""
        test_cfg = self.test_cfg or {}
        h_stride, w_stride = test_cfg["stride"]
        h_crop, w_crop = test_cfg["crop_size"]
        batch_size, _, h_img, w_img = img.shape
        origins, h_crop, w_crop = slide_window_origins(
            h_img, w_img, h_crop, w_crop, h_stride, w_stride)
        crop_logits = self.encode_decode(
            gather_windows(img, origins, h_crop, w_crop))
        preds = stitch_windows(crop_logits, origins, h_crop, w_crop,
                               batch_size, h_img, w_img)
        return self._rescale(preds, ori_img_size, rescale)

    def whole_inference(self, img, ori_img_size=None, rescale: bool = True):
        return self._rescale(self.encode_decode(img), ori_img_size, rescale)

    def inference(self, img, ori_img_size=None, rescale: bool = True,
                  mode: Optional[str] = None):
        """Whole or slide logits (``test_cfg['mode']`` unless ``mode`` is
        given), then sigmoid (one output channel) or softmax over classes."""
        if mode is None:
            mode = (self.test_cfg or {}).get("mode", "whole")
        if mode == "slide":
            seg_logit = self.slide_inference(img, ori_img_size, rescale)
        else:
            seg_logit = self.whole_inference(img, ori_img_size, rescale)
        if self.out_channels == 1:
            return torch.sigmoid(seg_logit)
        return torch.softmax(seg_logit, dim=1)

    forward = inference

    def predict(self, img, ori_img_size=None, rescale: bool = True):
        """Probabilities → (N, H, W) int32 class map (argmax, or threshold
        for a one-channel head)."""
        seg_logit = self.inference(img, ori_img_size=ori_img_size,
                                   rescale=rescale)
        if self.out_channels == 1:
            thr = self.decode_head.resolved_threshold()
            return (seg_logit[:, 0] > thr).to(torch.int32)
        return torch.argmax(seg_logit, dim=1).to(torch.int32)
