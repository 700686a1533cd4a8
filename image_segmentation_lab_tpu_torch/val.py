"""Validation entry point of the PyTorch port (counterpart of the root
``val.py``).

    python -m image_segmentation_lab_tpu_torch.val \\
        --network-cfg configs/network/deeplabv3/deeplabv3_r50-d8.py \\
        --dataset-cfg configs/dataset/KvasirSEG.py \\
        --checkpoint runs/train/exp/weights/best.pth --amp

Builds the segmentor, loads a checkpoint of either package, runs the
dataset's val (or test) split, with its original-resolution labels, through
``make_eval_step`` (or, with ``--tta``, ``make_tta_step`` resized to the
original size and ``binarize_channels``) and the evaluator, and writes
``results.json`` (``checkpoint``, ``losses``, ``metrics``) into
``work_dir/project/exp{N}``, with the collages under ``pred_results/`` and,
with ``--save-pred``, one PNG a image under ``predictions/``.  ``--device
''`` (the default) is the CUDA card and stops when there is none;
``--device cpu`` runs on the CPU.

``--panoptic`` adds PQ/SQ/RQ and one panopticapi id2rgb PNG a image under
``panoptic/`` (written by the port's own PNG encoder): a mask-
classification head (MaskFormer, Mask2Former) through its query
competition (``EncoderDecoder.panoptic``; under ``--tta`` on the
view-averaged query probabilities, ``panoptic_tta_probs``), a dense head
as all-stuff panoptic (one segment a class).  ``--instances`` writes the
mask-classification head's per-query results as COCO-style RLE
(``instances.json``), with ``--score`` their mask AP against one
all-stuff segment per class present.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .core.builder import DATASET, build_from_cfg
from .core.dataset import DataLoader
from .core.evaluation import (InstanceAPEvaluator, PanopticEvaluator,
                              SegEvaluator, instances_to_json,
                              queries_to_panoptic, semantic_to_panoptic)
from .core.evaluation.table import AsciiTable
from .core.fileio.image_io import imwrite
from .core.fileio import (increment_path, parse_and_backup_config,
                          require_config_key, select_device)
from .core.initialize import init_weights, load_checkpoint
from .core.mixed_precision import amp_policy, float32_precision
from .models.builder import build_segmentor
from .models.decode_heads.maskformer_head import panoptic_from_probs
from .train_state import (TrainState, binarize_channels, head_threshold,
                          make_eval_step, make_tta_step)
from .utils.ops import resize
from .utils.train_utils import validate_one_epoch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a segmentor (PyTorch port)")
    parser.add_argument("--network-cfg", type=Path, required=True)
    parser.add_argument("--dataset-cfg", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--split", default="val", choices=["val", "test"])
    parser.add_argument("--work-dir", type=Path, default=Path("runs"))
    parser.add_argument("--project", default="val")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--device", default="",
                        help="'' = the CUDA card (stops when there is "
                             "none), 'cpu'")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--amp", action="store_true",
                        help="bf16 compute policy for inference")
    parser.add_argument("--tta", action="store_true",
                        help="multi-scale + horizontal-flip test-time "
                             "augmentation (averaged probabilities)")
    parser.add_argument("--tta-scales", type=float, nargs="+",
                        default=[0.75, 1.0, 1.25])
    parser.add_argument("--save-pred", action="store_true",
                        help="write one palette-indexed prediction PNG per "
                             "image under <run>/predictions/")
    parser.add_argument("--panoptic", action="store_true",
                        help="also score panoptic quality (PQ/SQ/RQ) and "
                             "write id2rgb PNGs under <run>/panoptic/: "
                             "mask-classification heads by their query "
                             "competition, dense heads as all-stuff "
                             "panoptic")
    parser.add_argument("--instances", action="store_true",
                        help="also write a mask-classification head's "
                             "per-query instances as COCO-style RLE JSON "
                             "(<run>/instances.json)")
    parser.add_argument("--score-threshold", type=float, default=0.0,
                        help="instances: zero out queries below this class "
                             "confidence")
    parser.add_argument("--score", action="store_true",
                        help="with --instances: COCO-style mask mAP "
                             "against one segment per class present")
    parser.add_argument("--object-mask-threshold", type=float, default=0.8,
                        help="panoptic: least query confidence to keep a "
                             "segment (mask-classification heads)")
    parser.add_argument("--overlap-threshold", type=float, default=0.8,
                        help="panoptic: least retained share of a query's "
                             "own mask after the per-pixel competition")
    return parser.parse_args(argv)


def device_batches(loader, pipeline, device):
    """``(images NCHW, int32 labels, infos)`` of every loader batch on
    ``device``, through ``pipeline`` where given (a generator seeded with
    the batch index, as ``validate_one_epoch`` seeds epoch 0)."""
    for batch_idx, (images, labels, infos) in enumerate(loader):
        if pipeline is not None:
            generator = torch.Generator(device=device).manual_seed(batch_idx)
            images, labels = pipeline(generator, images, labels)
        else:
            images = torch.as_tensor(images, dtype=torch.float32,
                                     device=device)
            labels = torch.as_tensor(labels, device=device)
        yield images, labels.to(torch.int32), infos


def _nearest(arr, shape):
    ys = np.arange(shape[0]) * arr.shape[0] // shape[0]
    xs = np.arange(shape[1]) * arr.shape[1] // shape[1]
    return arr[ys][:, xs]


def write_id2rgb(pan, path):
    """A panoptic id map as panopticapi's id2rgb PNG; void (< 0) is id
    0."""
    ids = np.where(pan < 0, 0, pan).astype(np.int64)
    rgb = np.stack([ids % 256, (ids >> 8) % 256, (ids >> 16) % 256],
                   axis=-1).astype(np.uint8)
    imwrite(rgb[..., ::-1], path)  # imwrite takes BGR


def make_panoptic_step(model, args):
    """``pan_step(img) -> (query_id, labels, keep)`` of a mask-
    classification head: ``EncoderDecoder.panoptic``, or under ``--tta``
    ``panoptic_from_probs`` on the query probabilities averaged over the
    scales and flips (each view mapped back by ``panoptic_tta_probs``)."""
    thresholds = dict(object_mask_threshold=args.object_mask_threshold,
                      overlap_threshold=args.overlap_threshold)
    if not args.tta:
        return lambda img: model.panoptic(img, **thresholds)

    def pan_step(img):
        H, W = img.shape[2:]
        acc_p, acc_m, n = 0.0, 0.0, 0
        for s in args.tta_scales:
            scaled = resize(img, size=(int(H * s), int(W * s)),
                            mode="bilinear", align_corners=False)
            for flip in (False, True):
                p, m = model.panoptic_tta_probs(
                    scaled.flip(3) if flip else scaled, out_size=(H, W),
                    flip=flip)
                acc_p, acc_m, n = acc_p + p, acc_m + m, n + 1
        return panoptic_from_probs(acc_p / n, acc_m / n, **thresholds)

    return pan_step


def panoptic_eval(model, dataset, loader, eval_step, args, save_dir, device):
    """PQ/SQ/RQ over the split (``--panoptic``), the id2rgb PNGs under
    ``save_dir/panoptic``."""
    ignore = (dataset.ignore_index if dataset.ignore_index is not None
              else 255)
    pan_eval = PanopticEvaluator(dataset.num_classes)
    pan_dir = save_dir / "panoptic"
    pan_dir.mkdir(parents=True, exist_ok=True)
    # mask-classification heads carry their own panoptic post-processing;
    # the rest score all-stuff panoptic
    mask_path = hasattr(model.decode_head, "panoptic_map")
    pan_step = make_panoptic_step(model, args) if mask_path else None
    n_done = 0
    for images, labels, infos in device_batches(
            loader, dataset.device_pipeline, device):
        gts = infos.get("ori_gt")
        if gts is None:
            gts = labels.cpu().numpy()
        files = infos.get("img_file_path")
        with torch.no_grad():
            if mask_path:
                qid, qlabels, keep = (t.cpu().numpy()
                                      for t in pan_step(images))
            else:
                value = eval_step(images, labels)[0]["decode"]
                if isinstance(value, dict):  # a list of aux heads
                    value = value[sorted(value)[0]]
                if not isinstance(value, (list, tuple)):
                    preds_b = value.argmax(dim=1).cpu().numpy()
        for i in range(int(images.shape[0])):
            gt = np.asarray(gts[i]).astype(np.int64)
            if mask_path:
                q = qid[i]
                if q.shape != gt.shape:
                    q = _nearest(q, gt.shape)
                pred_pan = queries_to_panoptic(q, qlabels[i], keep[i])
            else:
                if isinstance(value, (list, tuple)):
                    logit = value[i]
                    pred = (logit[0] if logit.dim() == 4 else
                            logit).argmax(dim=0).cpu().numpy()
                else:
                    pred = preds_b[i]
                if pred.shape != gt.shape:
                    pred = _nearest(pred, gt.shape)
                pred_pan = semantic_to_panoptic(pred, ignore)
            pan_eval.process(pred_pan, semantic_to_panoptic(gt, ignore))
            stem = (Path(str(files[i])).stem
                    if files is not None and i < len(files)
                    else f"{n_done:06d}")
            write_id2rgb(pred_pan, pan_dir / f"{stem}.png")
            n_done += 1

    metrics = pan_eval.compute()
    per = metrics["per_class"]
    table = AsciiTable()
    table.add_column("class", [(dataset.CLASSES[c] if dataset.CLASSES
                                and c < len(dataset.CLASSES) else str(c))
                               for c in range(dataset.num_classes)])
    for col in ("PQ", "SQ", "RQ"):
        table.add_column(col, [f"{v:.2f}" for v in per[col]])
    for col in ("TP", "FP", "FN"):
        table.add_column(col, per[col])
    print(table.get_string())
    print(f"panoptic ({'mask-cls' if mask_path else 'all-stuff'}): "
          f"PQ={metrics['PQ']:.2f} SQ={metrics['SQ']:.2f} "
          f"RQ={metrics['RQ']:.2f}  ({n_done} maps -> {pan_dir})")
    return metrics


def instance_eval(model, dataset, loader, args, save_dir, device):
    """The per-query instances as RLE JSON (``--instances``), with
    ``--score`` their COCO-style mask AP; the AP metrics or None."""
    inst_eval = (InstanceAPEvaluator(len(dataset.CLASSES)) if args.score
                 else None)
    ignore = (dataset.ignore_index if dataset.ignore_index is not None
              else 255)
    records = []
    for images, labels, infos in device_batches(
            loader, dataset.device_pipeline, device):
        files = infos.get("img_file_path")
        with torch.no_grad():
            ilabels, scores, masks = (t.cpu().numpy() for t in model.instances(
                images, score_threshold=args.score_threshold))
        gt_np = labels.cpu().numpy()
        for i in range(int(images.shape[0])):
            name = (str(files[i]) if files is not None and i < len(files)
                    else f"{len(records):06d}")
            records.append({"image": name,
                            "instances": instances_to_json(
                                ilabels[i], scores[i], masks[i])})
            if inst_eval is not None:
                # semantic labels: one all-stuff segment a class present
                gt = gt_np[i]
                gts = [(c, gt == c) for c in np.unique(gt)
                       if c != ignore and 0 <= c]
                preds = [(int(ilabels[i, q]), float(scores[i, q]),
                          masks[i, q]) for q in range(scores.shape[1])
                         if scores[i, q] > 0]
                inst_eval.process(preds, gts)
    inst_file = save_dir / "instances.json"
    with open(inst_file, "w") as f:
        json.dump(records, f)
    print(f"instances: {sum(len(r['instances']) for r in records)} over "
          f"{len(records)} images -> {inst_file}")
    if inst_eval is None:
        return None
    metrics = inst_eval.compute()
    per_cls = " ".join(f"{dataset.CLASSES[c]}={ap:.3f}"
                       for c, ap in enumerate(metrics["per_class_AP"])
                       if ap is not None)
    print(f"instance AP: mAP={metrics['mAP']:.4f} "
          f"AP50={metrics['AP50']:.4f} AP75={metrics['AP75']:.4f}  "
          f"[{per_cls}]")
    return metrics


def make_tta_eval_step(model, scales, ori_img_size):
    """``eval_step(img, gt)`` of ``--tta``: the averaged probabilities,
    resized to ``ori_img_size`` where the dataset has one, each one-channel
    head made argmax-able at its threshold; no losses."""
    tta_step = make_tta_step(model, tuple(scales))
    threshold = head_threshold(model)

    def eval_step(img, gt):
        probs = tta_step(img)
        if ori_img_size:
            probs = resize(probs, size=tuple(ori_img_size), mode="bilinear",
                           align_corners=False)
        return {"decode": binarize_channels(probs, threshold,
                                            is_probs=True)}, {}

    return eval_step


def main(argv=None) -> int:
    args = parse_args(argv)
    device = select_device(args.device)

    save_dir = increment_path(args.work_dir, args.project, args.name)
    amp_policy(bool(args.amp))
    float32_precision()

    network_cfg = require_config_key(parse_and_backup_config(
        args.network_cfg), "model", args.network_cfg)
    dataset_cfg = require_config_key(parse_and_backup_config(
        args.dataset_cfg), "dataset", args.dataset_cfg)
    split_cfg = dict(dataset_cfg[args.split])
    # evaluation needs ground truth at original resolution
    split_cfg.setdefault("return_ori_seg_gt", True)

    model = build_segmentor(network_cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    ckpt = load_checkpoint(model, args.checkpoint)
    model.to(device).eval()
    state = TrainState(model, optimizer=None)
    dataset = build_from_cfg(split_cfg, DATASET)
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=False,
                        num_workers=args.num_workers,
                        collate_fn=dataset.collate_fn)

    uniform = (dataset.ori_img_size
               if getattr(dataset, "return_ori_seg_gt", False) else None)
    if args.tta:
        eval_step = make_tta_eval_step(model, args.tta_scales,
                                       dataset.ori_img_size)
    else:
        eval_step = make_eval_step(model, rescale_size=uniform)
    evaluator = SegEvaluator(
        epoch=int(ckpt.get("metadata", {}).get("epoch", 0)),
        num_classes=dataset.num_classes,
        class_names=dataset.CLASSES,
        palette=dataset.PALETTE,
        ignore_index=(dataset.ignore_index
                      if dataset.ignore_index is not None else 255),
        output_dir=str(save_dir / "pred_results"),
        save_pred_dir=(str(save_dir / "predictions")
                       if args.save_pred else None))
    pan_metrics = inst_metrics = None
    try:
        val_vars, metrics = validate_one_epoch(
            0, eval_step, state, loader, evaluator,
            pipeline=dataset.device_pipeline)
        if args.panoptic:
            pan_metrics = panoptic_eval(model, dataset, loader, eval_step,
                                        args, save_dir, device)
        if args.instances:
            inst_metrics = instance_eval(model, dataset, loader, args,
                                         save_dir, device)
    finally:
        loader.close()

    print("val loss vars: " +
          " ".join(f"{k}={v:.4f}" for k, v in val_vars.items()))
    payload = {"checkpoint": str(args.checkpoint),
               "losses": val_vars,
               **({"panoptic": pan_metrics} if pan_metrics else {}),
               **({"instance_ap": inst_metrics} if inst_metrics else {}),
               "metrics": {h: {k: (float(v) if np.isscalar(v) or
                                   getattr(v, "ndim", 1) == 0
                                   else np.asarray(v).tolist())
                               for k, v in m.items()}
                           for h, m in metrics.items()}}
    out_file = save_dir / "results.json"
    with open(out_file, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    print(f"results written to {out_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
