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
``--device cpu`` runs on the CPU.  ``--panoptic`` and ``--instances`` need
the mask-classification heads, which are not ported, and stop the run.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .core.builder import DATASET, build_from_cfg
from .core.dataset import DataLoader
from .core.evaluation import SegEvaluator
from .core.fileio import (increment_path, parse_and_backup_config,
                          require_config_key, select_device)
from .core.initialize import init_weights, load_checkpoint
from .core.mixed_precision import amp_policy, float32_precision
from .models.builder import build_segmentor
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
    parser.add_argument("--panoptic", action="store_true")
    parser.add_argument("--instances", action="store_true")
    parser.add_argument("--score-threshold", type=float, default=0.0)
    parser.add_argument("--score", action="store_true")
    parser.add_argument("--object-mask-threshold", type=float, default=0.8)
    parser.add_argument("--overlap-threshold", type=float, default=0.8)
    return parser.parse_args(argv)


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
    for flag in ("panoptic", "instances"):
        if getattr(args, flag):
            raise SystemExit(
                f"--{flag} is not ported: it needs the mask-classification "
                f"heads, ROADMAP.md Queue 1 item 7")
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
    try:
        val_vars, metrics = validate_one_epoch(
            0, eval_step, state, loader, evaluator,
            pipeline=dataset.device_pipeline)
    finally:
        loader.close()

    print("val loss vars: " +
          " ".join(f"{k}={v:.4f}" for k, v in val_vars.items()))
    payload = {"checkpoint": str(args.checkpoint),
               "losses": val_vars,
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
