"""COCO-style instance-segmentation mask mAP (counterpart of
``core/evaluation/instance_ap.py``; numpy on the host, a copy of the JAX
package's).

It scores the (label, score, mask) triples that ``val.py --instances``
exports against ground-truth segments, by pycocotools' protocol:

* per image and class, predictions are matched in descending-score
  order; each takes the not-yet-matched gt segment of highest mask IoU
  among those with IoU >= the threshold (TP), else it is FP; unmatched gt
  are FN;
* AP is the 101-point interpolated area under the precision-recall curve;
* mAP averages AP over the IoU thresholds 0.50 : 0.05 : 0.95; AP50 and
  AP75 are single thresholds; classes with no gt segment anywhere are left
  out of the mean.

Semantic ground truth carries no instance ids, so ``val.py --instances
--score`` makes one gt segment of each class present in an image.  Masks
are reduced to IoUs in ``process``; only the per-class scores and IoU
matrices are kept.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = tuple(float(t) for t in
                       np.round(np.arange(0.50, 0.96, 0.05), 2))
_RECALL_GRID = np.linspace(0.0, 1.0, 101)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two binary masks."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


def _ap_101(scores: np.ndarray, is_tp: np.ndarray, num_gt: int) -> float:
    """101-point interpolated AP from pooled (score, tp) pairs."""
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = is_tp[order].astype(np.float64)
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1.0 - tp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    for i in range(precision.size - 2, -1, -1):       # envelope
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.searchsorted(recall, _RECALL_GRID, side="left")
    p = np.where(idx < precision.size,
                 precision[np.minimum(idx, precision.size - 1)], 0.0)
    return float(p.mean())


def _greedy_tp(scores: np.ndarray, ious: np.ndarray,
               thr: float) -> np.ndarray:
    """COCO greedy matching for ONE image+class at one threshold.

    scores (P,) already any order; ious (P, G).  Returns TP flags (P,).
    Predictions are visited in descending score; each takes the
    unmatched gt of max IoU among those >= thr."""
    P, G = ious.shape
    flags = np.zeros(P, bool)
    taken = np.zeros(G, bool)
    for p in np.argsort(-scores, kind="stable"):
        if G == 0:
            break
        avail = ~taken
        if not avail.any():
            break
        masked = np.where(avail, ious[p], -1.0)
        g = int(np.argmax(masked))
        if masked[g] >= thr:
            flags[p] = True
            taken[g] = True
    return flags


class InstanceAPEvaluator:
    """Streaming COCO-style mask AP over (prediction, gt) image pairs.

    ``process(preds, gts)`` per image with ``preds`` a sequence of
    ``(label, score, mask)`` and ``gts`` of ``(label, mask)``; then
    ``compute()`` -> dict with mAP / AP50 / AP75 and per-class AP.
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        # per class: list over images of (scores (P,), ious (P, G))
        self._images: List[List[Tuple[np.ndarray, np.ndarray]]] = [
            [] for _ in range(num_classes)]
        self._num_gt = np.zeros(num_classes, np.int64)

    def process(self, preds: Sequence[Tuple[int, float, np.ndarray]],
                gts: Sequence[Tuple[int, np.ndarray]]) -> None:
        by_gt: Dict[int, List[np.ndarray]] = {}
        for label, mask in gts:
            label = int(label)
            if 0 <= label < self.num_classes:
                by_gt.setdefault(label, []).append(np.asarray(mask, bool))
                self._num_gt[label] += 1
        by_pred: Dict[int, List[Tuple[float, np.ndarray]]] = {}
        for label, score, mask in preds:
            label = int(label)
            if 0 <= label < self.num_classes and score > 0:
                by_pred.setdefault(label, []).append(
                    (float(score), np.asarray(mask, bool)))
        for label in set(by_pred) | set(by_gt):
            plist = by_pred.get(label, [])
            glist = by_gt.get(label, [])
            scores = np.array([s for s, _ in plist], np.float64)
            ious = np.array([[mask_iou(pm, g) for g in glist]
                             for _, pm in plist], np.float64).reshape(
                len(plist), len(glist))
            if plist or glist:
                self._images[label].append((scores, ious))

    def compute(self) -> Dict[str, object]:
        per_class = np.full((self.num_classes, len(IOU_THRESHOLDS)),
                            np.nan)
        for c in range(self.num_classes):
            if self._num_gt[c] == 0:
                continue
            pooled_scores = (np.concatenate(
                [s for s, _ in self._images[c]])
                if self._images[c] else np.zeros(0))
            for ti, thr in enumerate(IOU_THRESHOLDS):
                pooled_tp = (np.concatenate(
                    [_greedy_tp(s, iou, thr)
                     for s, iou in self._images[c]])
                    if self._images[c] else np.zeros(0, bool))
                per_class[c, ti] = _ap_101(pooled_scores, pooled_tp,
                                           int(self._num_gt[c]))
        valid = ~np.isnan(per_class[:, 0])
        if valid.any():
            mean = per_class[valid].mean(axis=0)
            t50 = IOU_THRESHOLDS.index(0.5)
            t75 = IOU_THRESHOLDS.index(0.75)
            out = {"mAP": float(mean.mean()),
                   "AP50": float(mean[t50]),
                   "AP75": float(mean[t75])}
        else:
            out = {"mAP": float("nan"), "AP50": float("nan"),
                   "AP75": float("nan")}
        out["per_class_AP"] = [
            float(row.mean()) if not np.isnan(row[0]) else None
            for row in per_class]
        out["num_gt"] = self._num_gt.tolist()
        return out
