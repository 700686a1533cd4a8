"""SegEvaluator — confusion-matrix segmentation metrics (counterpart of
``core/evaluation/metrics.py``).

``process`` takes per-head NCHW logits and counts intersection, prediction
and label per class on the logits' device, with the hand-written kernel on
a CUDA tensor (``ops/confusion.py``), on one of two paths:

* uniform labels (an ``(N, H, W)`` array or tensor, the logits already at
  their size): ``confusion_histograms`` (K1, the fused argmax) once a head
  and batch; the labels cross to the device once a batch;
* per-image labels (a list, as Kvasir's ``return_ori_seg_gt`` gives them):
  each image's logits are resized to its label's size by the JAX package's
  host rule (``resize_logits``), the class map is their ``argmax``, and
  ``confusion_histograms_from_labels`` (K2) counts it, once an image and
  head.

Each head's counts come back to the host in one copy a batch; the running
sums and every metric are float64 on the host.  ``output_dir`` gets a
palette collage of at most 16 class maps a head for each of the first 4
batches (``pred_epoch_{e}_batch_{b}_{head}.png``); ``save_pred_dir`` one
palette-indexed PNG a image (mode ``"I"`` 16-bit gray above 255 classes),
both through the port's own PNG writer (``fileio.imwrite``).
"""

from __future__ import annotations

import os.path as osp
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...ops.confusion import (confusion_histograms,
                              confusion_histograms_from_labels)
from ..fileio import imwrite, mkdir_or_exist
from .table import AsciiTable


def bilinear_1d_weights(in_size: int, out_size: int, align_corners: bool):
    """One axis of the JAX package's bilinear rule (``utils/ops.py``
    ``_bilinear_1d_weights``): source rows ``i0``, ``i1`` and the float32
    weight of ``i1``."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        step = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * step
    else:
        src = np.maximum((dst + 0.5) * (in_size / out_size) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, (src - i0).astype(np.float32)


def resize_logits(logits: torch.Tensor, size, align_corners: bool = False):
    """``(C, H, W)`` logits resized to ``size`` on their device, as the JAX
    package's ``resize_logits_np``: rows, then columns, each a gather, two
    multiplies and one add in float32 (the JAX weights are float32).  A
    bfloat16 input is cast to float32 first: numpy promotes an
    ``ml_dtypes.bfloat16`` array times float32 weights to float32, and
    bfloat16 values are exact in float32, so the products are the same."""
    c, h_in, w_in = logits.shape
    h, w = size
    if (h_in, w_in) == (h, w):
        return logits
    x = logits.float()
    for dim, (n_in, n_out) in ((1, (h_in, h)), (2, (w_in, w))):
        i0, i1, w1 = (torch.from_numpy(a).to(x.device) for a in
                      bilinear_1d_weights(n_in, n_out, align_corners))
        w1 = w1.view(-1, 1) if dim == 1 else w1.view(1, -1)
        x = (x.index_select(dim, i0) * (1 - w1)
             + x.index_select(dim, i1) * w1)
    return x


class SegEvaluator:

    # the collage's cap on images a head (the JAX package's); process()
    # copies at most this many class maps to the host
    PLOT_MAX_IMAGES = 16

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
        self.output_dir = output_dir
        self.save_pred_dir = save_pred_dir
        for directory in (output_dir, save_pred_dir):
            if directory:
                mkdir_or_exist(directory)
        # per-head running sums: [inter, union, pred, label]
        self.results: Dict[str, List[np.ndarray]] = {}
        self._saved_count = 0

    def _accumulate(self, head: str, counts: torch.Tensor):
        """Add ``(..., 3, C)`` float32 counts (intersection, prediction,
        label; one row set an image or a batch) to the head's float64
        sums."""
        counts = counts.cpu().numpy().astype(np.float64).reshape(
            -1, 3, self.num_classes).sum(axis=0)
        inter, pred, label = counts
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
        """``pred_batch``: per-head ``(N, C, H, W)`` logits or a list of
        ``(C, h, w)`` (or ``(1, C, h, w)``) logits, one an image (``{idx:
        logits}`` for a list of aux heads); ``batch_infos['ori_gt']``: the
        ``(N, H, W)`` labels, or a list of ``(h_i, w_i)`` labels."""
        labels = batch_infos["ori_gt"]
        want_plot = bool(self.show_result and batch_idx < 4
                         and self.output_dir)
        preds_for_plot = {}
        if isinstance(labels, (list, tuple)):
            process_one, labels = self._process_ragged, list(labels)
        else:
            process_one = self._process_uniform
            labels = torch.as_tensor(labels).to(torch.int32)
        gts = {}  # the labels on the logits' device, copied once a batch
        for head, value in pred_batch.items():
            items = (value.items() if isinstance(value, dict)
                     else [(None, value)])
            for sub, v in items:
                name = head if sub is None else f"{head}_{sub}"
                process_one(name, v, labels, gts, preds_for_plot, want_plot)
        if want_plot:
            self.plot_results(batch_idx, preds_for_plot, batch_infos)
        if self.save_pred_dir:
            self._save_predictions(pred_batch, batch_infos)

    def _process_uniform(self, head, logits, labels, gts, preds_for_plot,
                         want_plot):
        if "gt" not in gts:
            gts["gt"] = labels.to(logits.device).contiguous()
        self._accumulate(head, confusion_histograms(
            logits.contiguous(), gts["gt"], self.num_classes,
            self.ignore_index))
        if want_plot:
            preds_for_plot[head] = torch.argmax(
                logits[:self.PLOT_MAX_IMAGES], dim=1).to(
                torch.int32).cpu().numpy()

    @staticmethod
    def _per_image(value, n: int):
        """``(C, h, w)`` logits of each of ``n`` images."""
        if isinstance(value, (list, tuple)):
            return [v[0] if v.dim() == 4 else v for v in value]
        return [value[i] for i in range(n)]

    def class_map(self, logit, size):
        """The class map of one image's ``(C, h, w)`` logits at ``size``
        (int32, on the logits' device)."""
        if tuple(logit.shape[1:]) != tuple(size):
            logit = resize_logits(logit, size, self.align_corners)
        return torch.argmax(logit, dim=0).to(torch.int32)

    def _process_ragged(self, head, value, labels, gts, preds_for_plot,
                        want_plot):
        counts, plot_preds = [], []
        for i, logit in enumerate(self._per_image(value, len(labels))):
            if i not in gts:
                gts[i] = torch.as_tensor(np.asarray(labels[i])).to(
                    device=logit.device, dtype=torch.int32).contiguous()
            gt = gts[i]
            pred = self.class_map(logit, gt.shape)
            counts.append(confusion_histograms_from_labels(
                pred, gt, self.num_classes, self.ignore_index))
            if want_plot and i < self.PLOT_MAX_IMAGES:
                plot_preds.append(pred.cpu().numpy())
        self._accumulate(head, torch.stack(counts))
        if want_plot:
            preds_for_plot[head] = plot_preds

    def _save_predictions(self, pred_batch, batch_infos):
        """One class map a image as a PNG named after its source image
        (the mmseg submission format): palette-indexed up to 255 classes,
        else 16-bit gray.  The first head (``decode`` where there is one);
        per-image logits are taken to their label's size, a batch of
        logits is written at its own size, as the JAX package does."""
        head = "decode" if "decode" in pred_batch else sorted(pred_batch)[0]
        value = pred_batch[head]
        if isinstance(value, dict):
            value = value[sorted(value)[0]]
        files = batch_infos.get("img_file_path")
        labels = batch_infos.get("ori_gt")
        if isinstance(value, (list, tuple)):
            preds = []
            for i, logit in enumerate(self._per_image(value, len(value))):
                size = logit.shape[1:]
                if isinstance(labels, list) and i < len(labels):
                    size = np.asarray(labels[i]).shape
                preds.append(self.class_map(logit, size).cpu().numpy())
        else:
            preds = list(torch.argmax(value, dim=1).to(
                torch.int32).cpu().numpy())
        for i, pred in enumerate(preds):
            if files and i < len(files):
                stem = osp.splitext(osp.basename(str(files[i])))[0]
            else:
                stem = f"{self._saved_count + i:06d}"
            out = osp.join(self.save_pred_dir, f"{stem}.png")
            if self.num_classes <= 255 and self.palette is not None:
                imwrite(pred.astype(np.uint8), out, palette=self.palette)
            else:
                imwrite(pred.astype(np.int64), out)
        self._saved_count += len(preds)

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

    def plot_results(self, batch_idx, preds_by_head, batch_infos,
                     max_images: int = PLOT_MAX_IMAGES,
                     canvas_width: int = 1920):
        """A palette collage of each head's class maps (at most
        ``max_images``, ``ceil(sqrt(n))`` columns over ``canvas_width``,
        nearest scaling), written as
        ``pred_epoch_{e}_batch_{b}_{head}.png``."""
        palette = np.asarray(self.palette, np.uint8)
        for head, preds in preds_by_head.items():
            preds = list(preds)[:max_images]
            if not preds:
                continue
            n = len(preds)
            cols = int(np.ceil(np.sqrt(n)))
            rows = int(np.ceil(n / cols))
            cell_w = canvas_width // cols
            tiles = []
            for r in range(rows):
                row_tiles = []
                for c in range(cols):
                    i = r * cols + c
                    if i < n:
                        pred = np.asarray(preds[i]).astype(np.int64)
                        color = palette[np.clip(pred, 0, len(palette) - 1)]
                        h, w = color.shape[:2]
                        scale = cell_w / w
                        new_h = max(int(h * scale), 1)
                        idx_r = np.clip((np.arange(new_h) / scale).astype(
                            int), 0, h - 1)
                        idx_c = np.clip((np.arange(cell_w) / scale).astype(
                            int), 0, w - 1)
                        row_tiles.append(color[idx_r][:, idx_c])
                    else:
                        row_tiles.append(np.zeros_like(row_tiles[0]))
                hmax = max(t.shape[0] for t in row_tiles)
                row_tiles = [np.pad(t, ((0, hmax - t.shape[0]), (0, 0),
                                        (0, 0))) for t in row_tiles]
                tiles.append(np.concatenate(row_tiles, axis=1))
            canvas = np.concatenate(tiles, axis=0)
            imwrite(canvas[..., ::-1], osp.join(
                self.output_dir,
                f"pred_epoch_{self.epoch}_batch_{batch_idx}_{head}.png"))
