"""Panoptic Quality (PQ/SQ/RQ) metric (counterpart of
``core/evaluation/panoptic.py``; numpy on the host, a copy of the JAX
package's, which the port does not import).

Kirillov et al.'s metric, the panopticapi recipe:

* segments are (class, instance) regions encoded per pixel as
  ``class * INSTANCE_OFFSET + instance`` (void < 0);
* a predicted and a ground-truth segment of the same class match iff
  ``IoU > 0.5``, with the void-aware union ``|p| + |g| - |p∩g| - |p∩void|``
  (matches are unique at this threshold);
* unmatched ground-truth segments count FN; unmatched predicted segments
  count FP unless more than half their area lies on ground-truth void;
* per class ``PQ = Σ IoU / (TP + FP/2 + FN/2)``, ``SQ = Σ IoU / TP``,
  ``RQ = TP / (TP + FP/2 + FN/2)``; the dataset metrics average over the
  classes that appear.

One ``np.unique`` over the joint ``gt * K + pred`` encoding gives an
image's pair statistics.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# id = class * INSTANCE_OFFSET + instance (mmdet/mmseg convention)
INSTANCE_OFFSET = 1000
VOID = -1


def semantic_to_panoptic(semantic: np.ndarray,
                         ignore_index: int = 255) -> np.ndarray:
    """All-stuff panoptic encoding of a semantic map: every class forms
    ONE segment (instance 1 — ids stay positive so class 0 never
    collides with the id-0 void convention of exported id2rgb PNGs).
    The standard conversion for datasets that ship semantic ground
    truth only — PQ then scores each class region as a single segment.
    ``ignore_index`` (and negative labels) become void."""
    semantic = np.asarray(semantic)
    pan = semantic.astype(np.int64) * INSTANCE_OFFSET + 1
    pan[(semantic == ignore_index) | (semantic < 0)] = VOID
    return pan


def queries_to_panoptic(query_id: np.ndarray, labels: np.ndarray,
                        keep: np.ndarray) -> np.ndarray:
    """Encode ``MaskFormerHead.panoptic_map`` output — per-pixel winning
    query (−1 void), per-query class labels, kept mask — as a panoptic
    id map.  Instances of the same class get distinct ids via their
    query index (ranked densely per class is unnecessary for PQ: ids
    only need to be unique within the image)."""
    query_id = np.asarray(query_id)
    labels = np.asarray(labels)
    keep = np.asarray(keep)
    valid = query_id >= 0
    cls = np.where(valid, labels[np.clip(query_id, 0, None)], 0)
    # instance id = query index + 1 keeps same-class queries distinct
    pan = cls.astype(np.int64) * INSTANCE_OFFSET + np.where(
        valid, query_id + 1, 0)
    pan[~valid] = VOID
    del keep  # keep is already folded into query_id's −1 voids
    return pan


class PanopticEvaluator:
    """Accumulates PQ statistics over images; ``compute()`` returns the
    dataset PQ/SQ/RQ plus per-class tables."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.iou_sum = np.zeros(num_classes, np.float64)
        self.tp = np.zeros(num_classes, np.int64)
        self.fp = np.zeros(num_classes, np.int64)
        self.fn = np.zeros(num_classes, np.int64)

    def process(self, pred_pan: np.ndarray, gt_pan: np.ndarray) -> None:
        """Accumulate one image pair — or a batch: segment ids are only
        unique WITHIN an image, so a leading batch axis is looped, never
        raveled together (two images' instance 5 are different
        segments)."""
        pred_pan = np.asarray(pred_pan)
        gt_pan = np.asarray(gt_pan)
        assert pred_pan.shape == gt_pan.shape
        if pred_pan.ndim >= 3:
            for p, g in zip(pred_pan, gt_pan):
                self.process(p, g)
            return
        pred_pan = pred_pan.ravel().astype(np.int64)
        gt_pan = gt_pan.ravel().astype(np.int64)

        # shift void (−1) to a dense non-negative id for the joint encode
        pred_ids, pred_inv = np.unique(pred_pan, return_inverse=True)
        gt_ids, gt_inv = np.unique(gt_pan, return_inverse=True)
        n_pred = len(pred_ids)
        joint = gt_inv * n_pred + pred_inv
        pair_ids, pair_counts = np.unique(joint, return_counts=True)
        gt_idx = pair_ids // n_pred
        pred_idx = pair_ids % n_pred

        gt_areas = np.bincount(gt_inv, minlength=len(gt_ids))
        pred_areas = np.bincount(pred_inv, minlength=n_pred)

        gt_void = gt_ids < 0
        pred_void = pred_ids < 0
        gt_cls = np.where(gt_void, -1, gt_ids // INSTANCE_OFFSET)
        pred_cls = np.where(pred_void, -1, pred_ids // INSTANCE_OFFSET)

        # each pred segment's overlap with GT void (for union + FP rule)
        void_overlap = np.zeros(n_pred, np.int64)
        on_void = gt_void[gt_idx]
        np.add.at(void_overlap, pred_idx[on_void], pair_counts[on_void])

        gt_matched = np.zeros(len(gt_ids), bool)
        pred_matched = np.zeros(n_pred, bool)
        same_class = (gt_cls[gt_idx] == pred_cls[pred_idx]) \
            & ~gt_void[gt_idx] & ~pred_void[pred_idx]
        for pi, gi, inter in zip(pred_idx[same_class], gt_idx[same_class],
                                 pair_counts[same_class]):
            union = (pred_areas[pi] + gt_areas[gi] - inter
                     - void_overlap[pi])
            iou = inter / union if union > 0 else 0.0
            if iou > 0.5:  # unique by construction at this threshold
                c = gt_cls[gi]
                self.tp[c] += 1
                self.iou_sum[c] += iou
                gt_matched[gi] = True
                pred_matched[pi] = True

        for gi in np.nonzero(~gt_matched & ~gt_void)[0]:
            self.fn[gt_cls[gi]] += 1
        for pi in np.nonzero(~pred_matched & ~pred_void)[0]:
            # panopticapi void exemption: mostly-void predictions are
            # neither right nor wrong
            if void_overlap[pi] / max(pred_areas[pi], 1) <= 0.5:
                self.fp[pred_cls[pi]] += 1

    def compute(self) -> Dict[str, object]:
        denom = self.tp + 0.5 * self.fp + 0.5 * self.fn
        present = denom > 0
        pq = np.zeros(self.num_classes)
        sq = np.zeros(self.num_classes)
        rq = np.zeros(self.num_classes)
        np.divide(self.iou_sum, denom, out=pq, where=present)
        np.divide(self.iou_sum, self.tp, out=sq,
                  where=self.tp > 0)
        np.divide(self.tp, denom, out=rq, where=present)
        n = max(int(present.sum()), 1)
        return {
            "PQ": round(float(pq[present].sum() / n) * 100, 2),
            "SQ": round(float(sq[present].sum() / n) * 100, 2),
            "RQ": round(float(rq[present].sum() / n) * 100, 2),
            "per_class": {
                "PQ": (pq * 100).round(2).tolist(),
                "SQ": (sq * 100).round(2).tolist(),
                "RQ": (rq * 100).round(2).tolist(),
                "TP": self.tp.tolist(), "FP": self.fp.tolist(),
                "FN": self.fn.tolist(),
            },
        }


def panoptic_quality(pred_pan: np.ndarray, gt_pan: np.ndarray,
                     num_classes: int,
                     evaluator: Optional[PanopticEvaluator] = None):
    """One-shot PQ over a single (batched or single) map pair."""
    ev = evaluator or PanopticEvaluator(num_classes)
    ev.process(pred_pan, gt_pan)
    return ev.compute()
