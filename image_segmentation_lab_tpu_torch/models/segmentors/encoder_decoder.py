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
gives ``aux_<i>`` keys). Both run under the compute policy
(``core/mixed_precision``): with ``bf16`` (the schedule's ``amp=True``)
under ``torch.autocast`` to bfloat16, so the logits come out in bfloat16
and the losses cast them to float32.

Test-time augmentation: ``forward_test`` routes one image (batch) to
``simple_test`` and a list of augmented views to ``batch_test`` (one
``simple_test`` per view, from view 0: the reference skipped it);
``aug_test_logits`` averages the views' probabilities.

Mask-classification heads (MaskFormer, Mask2Former) add ``panoptic``,
``panoptic_tta_probs`` and ``instances``: the head's per-query outputs at
the input resolution (nearest upsampling by ``jax.image.resize``'s rule,
``floor((i + 0.5) · in / out)`` in float32), which ``val.py --panoptic``
and ``--instances`` encode; a dense head raises ``AttributeError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...core.mixed_precision import compute_autocast
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


def _batched(img):
    """A ``(C, H, W)`` image as a batch of one; a batch as it is."""
    return img[None] if img.dim() == 3 else img


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


def nearest_upsample(x, size):
    """``x (N, C, h, w)`` to ``size`` by ``jax.image.resize``'s nearest
    rule: source ``floor((i + 0.5) · in / out)``, in float32."""
    for axis, (n_in, n_out) in zip((2, 3), zip(x.shape[2:], size)):
        if n_in != n_out:
            src = np.floor((np.arange(n_out, dtype=np.float32)
                            + np.float32(0.5)) * np.float32(n_in)
                           / np.float32(n_out)).astype(np.int64)
            x = x.index_select(axis, torch.from_numpy(src).to(x.device))
    return x


def _mask_head(head, method: str):
    if not hasattr(head, method):
        raise AttributeError(
            f"{type(head).__name__} is a dense decode head: {method} needs "
            f"a mask-classification head (MaskFormerHead/Mask2FormerHead)")
    return getattr(head, method)


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
        with compute_autocast(img.device.type):
            out = self.decode_head.forward_test(self.extract_feat(img))
            return resize(out, size=img.shape[2:], mode="bilinear",
                          align_corners=self.align_corners)

    def panoptic(self, img, object_mask_threshold: float = 0.8,
                 overlap_threshold: float = 0.8):
        """``(query_id (N, H, W), labels (N, Q), keep (N, Q))`` of the
        head's ``panoptic_map`` at the input resolution."""
        panoptic_map = _mask_head(self.decode_head, "panoptic_map")
        with compute_autocast(img.device.type):
            query_id, labels, keep = panoptic_map(
                self.extract_feat(img),
                object_mask_threshold=object_mask_threshold,
                overlap_threshold=overlap_threshold)
        query_id = nearest_upsample(query_id[:, None], img.shape[2:])[:, 0]
        return query_id, labels, keep

    def panoptic_tta_probs(self, img, out_size=None, flip: bool = False):
        """One TTA view's ``(probs (N, Q, K+1), mask_probs (N, Q, H, W))``
        in the un-augmented frame: mask probabilities resized (bilinear)
        to ``out_size`` (default: the view's size) and un-flipped; feed
        the views' means to ``maskformer_head.panoptic_from_probs``."""
        query_probs = _mask_head(self.decode_head, "query_probs")
        with compute_autocast(img.device.type):
            probs, mask_probs = query_probs(self.extract_feat(img))
        size = tuple(out_size) if out_size is not None else img.shape[2:]
        mask_probs = resize(mask_probs, size=size, mode="bilinear",
                            align_corners=False)
        if flip:
            mask_probs = mask_probs.flip(3)
        return probs, mask_probs

    def instances(self, img, score_threshold: float = 0.0):
        """``(labels (N, Q), scores (N, Q), masks (N, Q, H, W) bool)`` of
        the head's ``instance_results`` at the input resolution; gated
        queries have score 0."""
        instance_results = _mask_head(self.decode_head, "instance_results")
        with compute_autocast(img.device.type):
            labels, scores, masks = instance_results(
                self.extract_feat(img), score_threshold=score_threshold)
        return labels, scores, nearest_upsample(masks, img.shape[2:])

    def forward_train(self, img, gt_semantic_seg, meta_infos=None,
                      rescale: bool = False):
        """Logits and losses of the decode head and every aux head."""
        with compute_autocast(img.device.type):
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

    def simple_test(self, img, ori_img_size=None, rescale: bool = True):
        """Probabilities of one batch (``inference``)."""
        return self.inference(img, ori_img_size=ori_img_size,
                              rescale=rescale)

    def batch_test(self, imgs, ori_img_size=None, rescale: bool = True):
        """``simple_test`` of each view of a TTA list, from view 0; a list
        ``ori_img_size`` gives one size per view."""
        return [self.simple_test(_batched(img),
                                 ori_img_size=(ori_img_size[i]
                                               if isinstance(ori_img_size,
                                                             list)
                                               else ori_img_size),
                                 rescale=rescale)
                for i, img in enumerate(imgs)]

    def forward_test(self, imgs, meta_infos=None, rescale: bool = True):
        """``imgs``: a list of ``(C, H, W)`` or ``(N, C, H, W)`` tensors,
        one per test-time augmentation; one view goes to ``simple_test``,
        several to ``batch_test``.  ``meta_infos['ori_img_size_hw']``: one
        size, or a list with one per view."""
        sizes = (meta_infos or {}).get("ori_img_size_hw")
        if isinstance(sizes, list) and len(sizes) != len(imgs):
            raise ValueError(f"num of images ({len(imgs)}) != num of "
                             f"ori_img_sizes ({len(sizes)})")
        if len(imgs) == 1:
            size = sizes[0] if isinstance(sizes, list) else sizes
            return self.simple_test(_batched(imgs[0]), ori_img_size=size,
                                    rescale=rescale)
        return self.batch_test(imgs, ori_img_size=sizes, rescale=rescale)

    def aug_test_logits(self, imgs, ori_img_sizes=None,
                        rescale: bool = True):
        """The mean of the views' probabilities (``inference`` of each)."""
        assert rescale
        total = None
        for i, img in enumerate(imgs):
            probs = self.inference(
                _batched(img),
                ori_img_size=ori_img_sizes[i] if ori_img_sizes else None,
                rescale=rescale)
            total = probs if total is None else total + probs
        return total / len(imgs)

    def predict(self, img, ori_img_size=None, rescale: bool = True):
        """Probabilities → (N, H, W) int32 class map (argmax, or threshold
        for a one-channel head)."""
        seg_logit = self.inference(img, ori_img_size=ori_img_size,
                                   rescale=rescale)
        if self.out_channels == 1:
            thr = self.decode_head.resolved_threshold()
            return (seg_logit[:, 0] > thr).to(torch.int32)
        return torch.argmax(seg_logit, dim=1).to(torch.int32)
