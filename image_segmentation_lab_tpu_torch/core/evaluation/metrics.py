"""SegEvaluator — confusion-matrix segmentation metrics (counterpart of
``core/evaluation/metrics.py``).

``process`` takes per-head NCHW logits already at label size and counts
intersection/prediction/label per class on the logits' device with
``ops.confusion.confusion_histograms`` (the hand-written kernel on a CUDA
tensor): the labels cross to the device once per batch, and each head's
``(3, C)`` counts come back to the host in one copy.  The running sums and
every metric are float64 on the host.

Not ported yet: the ragged path for per-image label sizes, the prediction
collages (``output_dir``) and ``--save-pred`` (``save_pred_dir``); they need
PIL and matplotlib.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...ops.confusion import confusion_histograms
from .table import AsciiTable


class SegEvaluator:

    def __init__(self,
                 epoch: int,
                 num_classes: int,
                 class_names: List[str],
                 palette: Sequence[Sequence[int]],
                 ignore_index: int = 255,
                 iou_metrics: List[str] = ("mIoU", "mDice", "mFscore"),
                 nan_to_num: Optional[int] = None,
                 beta: int = 1,
                 show_result: bool = True,
                 output_dir: Optional[str] = None,
                 format_only: bool = False,
                 prefix: Optional[str] = None,
                 align_corners: bool = False,
                 save_pred_dir: Optional[str] = None,
                 **kwargs) -> None:
        if output_dir or save_pred_dir:
            raise NotImplementedError(
                "prediction collages and --save-pred are not ported yet")
        self.epoch = epoch
        self.num_classes = num_classes
        self.class_names = list(class_names)
        self.palette = palette
        self.ignore_index = ignore_index
        self.metrics = list(iou_metrics)
        self.nan_to_num = nan_to_num
        self.beta = beta
        self.show_result = show_result
        self.format_only = format_only
        self.prefix = prefix
        self.align_corners = align_corners
        # per-head running sums: [inter, union, pred, label]
        self.results: Dict[str, List[np.ndarray]] = {}

    def _accumulate(self, head: str, counts: torch.Tensor):
        """Add one batch's ``(3, C)`` float32 counts (intersection,
        prediction, label) to the head's float64 sums."""
        inter, pred, label = counts.cpu().numpy().astype(np.float64)
        if head not in self.results:
            self.results[head] = [np.zeros(self.num_classes, np.float64)
                                  for _ in range(4)]
        sums = self.results[head]
        sums[0] += inter
        sums[1] += label + pred - inter
        sums[2] += pred
        sums[3] += label

    def process(self, batch_idx: int, pred_batch: Dict[str, Any],
                batch_infos: Dict[str, Any]) -> None:
        """``pred_batch``: per-head ``(N, C, H, W)`` logits (or ``{idx:
        logits}`` for a list of aux heads); ``batch_infos['ori_gt']``: the
        ``(N, H, W)`` labels."""
        labels = batch_infos["ori_gt"]
        if isinstance(labels, list):
            raise NotImplementedError(
                "per-image label sizes (the ragged host path) are not "
                "ported yet")
        labels = torch.as_tensor(labels).to(torch.int32)
        gt = None  # the labels on the logits' device, copied once a batch

        def count(head, logits):
            nonlocal gt
            if gt is None:
                gt = labels.to(logits.device).contiguous()
            self._accumulate(head, confusion_histograms(
                logits.contiguous(), gt, self.num_classes,
                self.ignore_index))

        for head, value in pred_batch.items():
            if isinstance(value, dict):
                for sub, v in value.items():
                    count(f"{head}_{sub}", v)
            else:
                count(head, value)

    def compute_metrics(self):
        metrics_results = {}
        for head, sums in self.results.items():
            print(f"-------------------------{head}-------------------------")
            metrics_results[head] = self.seg_metrics(sums)
        return metrics_results

    def seg_metrics(self, sums: List[np.ndarray]) -> Dict[str, Any]:
        assert len(sums) == 4
        ret_metrics = self.total_area_to_metrics(
            sums[0], sums[1], sums[2], sums[3], self.metrics,
            self.nan_to_num, self.beta)

        with np.errstate(invalid="ignore"):
            ret_metrics_summary = OrderedDict({
                k: np.round(np.nanmean(v) * 100, 2)
                for k, v in ret_metrics.items()})
        metrics = {}
        for key, val in ret_metrics_summary.items():
            metrics[key if key == "aAcc" else "m" + key] = val

        ret_metrics.pop("aAcc", None)
        ret_metrics_class = OrderedDict({
            k: np.round(np.asarray(v) * 100, 2)
            for k, v in ret_metrics.items()})
        # drop the ignored class's row when ignore_index names a real class
        # slot; a negative ignore value marks invalid pixels, not a class
        keep = [i for i in range(len(self.class_names))
                if i != self.ignore_index]
        table = AsciiTable()
        table.add_column("Class", [self.class_names[i] for i in keep])
        for key, val in ret_metrics_class.items():
            table.add_column(key, [val[i] for i in keep])
        print("\n" + table.get_string())
        metrics.update(ret_metrics_class)
        return metrics

    @staticmethod
    def total_area_to_metrics(total_area_intersect,
                              total_area_union,
                              total_area_pred_label,
                              total_area_label,
                              metrics: Union[str, List[str]] = ("mIoU",),
                              nan_to_num: Optional[int] = None,
                              beta: int = 1):
        """aAcc and per-class IoU/Acc/Dice/Fscore/Precision/Recall, float64."""

        def f_score(precision, recall, beta=1):
            return ((1 + beta ** 2) * (precision * recall)
                    / ((beta ** 2 * precision) + recall))

        if isinstance(metrics, str):
            metrics = [metrics]
        allowed = {"mIoU", "mDice", "mFscore"}
        if not set(metrics).issubset(allowed):
            raise KeyError(f"metrics {metrics} is not supported")

        with np.errstate(divide="ignore", invalid="ignore"):
            all_acc = total_area_intersect.sum() / total_area_label.sum()
            ret = OrderedDict({"aAcc": all_acc})
            for metric in metrics:
                if metric == "mIoU":
                    ret["IoU"] = total_area_intersect / total_area_union
                    ret["Acc"] = total_area_intersect / total_area_label
                elif metric == "mDice":
                    ret["Dice"] = (2 * total_area_intersect /
                                   (total_area_pred_label + total_area_label))
                    ret["Acc"] = total_area_intersect / total_area_label
                elif metric == "mFscore":
                    precision = total_area_intersect / total_area_pred_label
                    recall = total_area_intersect / total_area_label
                    ret["Fscore"] = f_score(precision, recall, beta)
                    ret["Precision"] = precision
                    ret["Recall"] = recall
        if nan_to_num is not None:
            ret = OrderedDict({
                k: np.nan_to_num(v, nan=nan_to_num) for k, v in ret.items()})
        return ret
