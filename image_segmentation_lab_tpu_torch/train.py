"""Training entry point of the PyTorch port (counterpart of the root
``train.py``).

    python -m image_segmentation_lab_tpu_torch.train \\
        --network-cfg configs/network/deeplabv3/deeplabv3_r50-d8.py \\
        --dataset-cfg configs/dataset/KvasirSEG.py \\
        --schedule-cfg configs/schedule/kvasir_training_schedule.py

The same flags, configs and run directory (``work_dir/project/exp{N}`` with
``weights/{last,best}.pth`` and ``config/``) as the JAX CLI, and the same
steps: seed and precision policy, model, data, optimizer and LR schedule,
``pretrained`` / ``init_cfg`` / ``--load-from`` / ``--resume-from`` /
``--auto-resume``, then per epoch ``train_one_epoch`` with the
augmentation fused into the step, validation through ``make_eval_step``
and the evaluator, the composite ``fits`` score, ``last.pth`` (with the
train state) and ``best.pth`` on a better ``fits``.  ``--device ''`` (the
default) is the CUDA card and stops when there is none; ``--device cpu``
runs on the CPU.  The parallel layouts and the orbax checkpoints are not
ported and stop the run.
"""

from __future__ import annotations

import argparse
import re
from contextlib import ExitStack
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .core.builder import DATASET, LR_SCHEDULER, build_from_cfg
from .core.dataset import DataLoader
from .core.evaluation import SegEvaluator
from .core.fileio import (increment_path, parse_and_backup_config,
                          require_config_key, select_device)
from .core.initialize import (derive_seed, dump_init_info, get_init_info,
                              init_random_seed, init_weights,
                              initialize_from_network_cfg, load_checkpoint,
                              reset_init_info, set_random_seed)
from .core.initialize.checkpoint import load_file, unpack_train_state
from .core.mixed_precision import amp_policy, float32_precision
from .models.builder import build_segmentor
from .train_state import create_train_state, make_eval_step, make_train_step
from .utils.ema import ema_weights, wrap_train_step_with_ema
from .utils.metadata import get_environment_info
from .utils.train_utils import (pth_metadata, save_model, train_one_epoch,
                                validate_one_epoch)

PARALLEL_FLAGS = ("--space-shards", "--tp-shards", "--fsdp", "--zero1",
                  "--aug-shard-local")
# the per-epoch generators' stream under the run's seed (the JAX CLI folds
# its root key with the same word)
EPOCH_STREAM = 0x7261696e


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a segmentor (PyTorch port)")
    parser.add_argument("--network-cfg", type=Path, default=Path(
        "configs/network/deeplabv3/deeplabv3_r50-d8.py"))
    parser.add_argument("--dataset-cfg", type=Path,
                        default=Path("configs/dataset/KvasirSEG.py"))
    parser.add_argument("--schedule-cfg", type=Path, default=Path(
        "configs/schedule/kvasir_training_schedule.py"))
    parser.add_argument("--work-dir", type=Path, default=Path("runs"))
    parser.add_argument("--project", default="train")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--device", default="",
                        help="'' = the CUDA card (stops when there is "
                             "none), 'cpu'")
    parser.add_argument("--load-from", type=Path, default=None,
                        help="checkpoint to load weights from (either "
                             "package's)")
    parser.add_argument("--resume-from", type=Path, default=None,
                        help="checkpoint of this package to resume from")
    parser.add_argument("--auto-resume", action="store_true",
                        help="resume from the newest last.pth of a prior "
                             "run of the same name")
    parser.add_argument("--no-validate", action="store_true")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override schedule epochs")
    parser.add_argument("--profile-dir", type=Path, default=None,
                        help="write a torch.profiler trace of the first "
                             "epoch here")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="keep an EMA of the parameters (e.g. 0.999); "
                             "validation and best.pth use it, last.pth "
                             "keeps the raw parameters and the EMA for "
                             "resume")
    parser.add_argument("--ckpt-backend", default="pickle",
                        choices=["pickle", "orbax", "orbax_async"],
                        help="checkpoint format (only pickle is ported)")
    parser.add_argument("--space-shards", type=int, default=1)
    parser.add_argument("--aug-shard-local", action="store_true")
    parser.add_argument("--tp-shards", type=int, default=1)
    parser.add_argument("--fsdp", action="store_true")
    parser.add_argument("--zero1", action="store_true")
    parser.add_argument("--local_rank", type=int, default=0)
    return parser.parse_args(argv)


def check_ported(args) -> None:
    """Stop on a flag whose feature the port does not have."""
    on = [flag for flag, value in zip(PARALLEL_FLAGS, (
        args.space_shards != 1, args.tp_shards != 1, args.fsdp, args.zero1,
        args.aug_shard_local)) if value]
    if on:
        raise SystemExit(f"{on[0]} is not ported: the port trains on one "
                         f"device; parallelism is ROADMAP.md Queue 1 item 8")
    if args.ckpt_backend != "pickle":
        raise SystemExit(f"--ckpt-backend {args.ckpt_backend} is not "
                         f"ported: the card's machine has no orbax; use "
                         f"pickle")


def find_auto_resume(args, save_dir: Path):
    """``(last.pth, best.pth)`` of the newest prior run named ``name`` or
    ``name<N>`` (never a sibling such as ``exp_ablation``), or ``(None,
    None)``."""
    base = Path(args.work_dir) / args.project
    if not base.exists():
        return None, None
    pattern = re.compile(re.escape(args.name) + r"\d*$")
    runs = sorted((p for p in base.glob(f"{args.name}*")
                   if pattern.match(p.name)),
                  key=lambda p: p.stat().st_mtime, reverse=True)
    for run in runs:
        if run != save_dir and (run / "weights" / "last.pth").exists():
            return run / "weights" / "last.pth", run / "weights" / "best.pth"
    return None, None


def main(argv=None) -> int:
    args = parse_args(argv)
    check_ported(args)

    device = select_device(args.device)

    # Step 1: run directory
    save_dir = increment_path(work_dir=args.work_dir, project=args.project,
                              name=args.name)
    weights_dir, config_dir = save_dir / "weights", save_dir / "config"
    weights_dir.mkdir(parents=True, exist_ok=True)
    config_dir.mkdir(parents=True, exist_ok=True)
    last_pth, best_pth = weights_dir / "last.pth", weights_dir / "best.pth"

    # Step 2: configs
    metadata = dict(time=datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    metadata.update(get_environment_info())
    network_cfg = require_config_key(parse_and_backup_config(
        args.network_cfg, config_dir, metadata), "model", args.network_cfg)
    dataset_cfg = require_config_key(parse_and_backup_config(
        args.dataset_cfg, config_dir, metadata), "dataset", args.dataset_cfg)
    schedule_cfg = parse_and_backup_config(args.schedule_cfg, config_dir,
                                           metadata)

    # Step 3: seed and precision policy
    seed = init_random_seed(seed=schedule_cfg.get("seed", 0),
                            device=args.device)
    metadata.update(seed=seed)
    seed = set_random_seed(seed, deterministic=(
        args.deterministic or schedule_cfg.get("deterministic", False)))
    amp_policy(bool(schedule_cfg.get("amp", False)))
    float32_precision()

    # Step 4: model (on the host until its weights are in place)
    model = build_segmentor(network_cfg)
    init_weights(model, torch.Generator().manual_seed(derive_seed(seed, 1)))
    print(model)

    # Step 5: data
    train_dataset = build_from_cfg(dataset_cfg["train"], DATASET)
    val_dataset = build_from_cfg(dataset_cfg["val"], DATASET)
    workers = schedule_cfg.get("num_workers", 4)
    train_loader = DataLoader(train_dataset,
                              batch_size=schedule_cfg.get("train_batch_size",
                                                          8),
                              shuffle=schedule_cfg.get("shuffle", True),
                              num_workers=workers,
                              collate_fn=train_dataset.collate_fn,
                              drop_last=True, seed=seed)
    val_loader = DataLoader(val_dataset,
                            batch_size=schedule_cfg.get("val_batch_size", 4),
                            shuffle=False, num_workers=workers,
                            collate_fn=val_dataset.collate_fn)
    metadata.update(CLASSES=train_dataset.CLASSES,
                    PALETTE=np.asarray(train_dataset.PALETTE).tolist())

    # Step 6: optimizer and LR schedule
    epochs = args.epochs or schedule_cfg.get("epochs", 50)
    steps_per_epoch = max(len(train_loader), 1)
    optimizer_cfg = dict(schedule_cfg.get("optimizer",
                                          dict(type="SGD", lr=0.01)))
    if "lr" not in optimizer_cfg:
        raise SystemExit(
            f"schedule config {args.schedule_cfg}: the optimizer dict must "
            f"set `lr` (the LR schedule is computed from it); got "
            f"{optimizer_cfg}")
    base_lr = optimizer_cfg["lr"]
    lr_cfg = schedule_cfg.get("lr_config")
    epoch_rule = build_from_cfg(lr_cfg, LR_SCHEDULER) if lr_cfg else None

    # Step 7: weights (pretrained, init_cfg, load or resume), train state
    pretrained = network_cfg.get("pretrained")
    if pretrained:
        if "://" in str(pretrained) or not Path(str(pretrained)).is_file():
            raise SystemExit(
                f"pretrained='{pretrained}' is not a local checkpoint file. "
                f"Remote locators can't be downloaded here — convert the "
                f"torch checkpoint with tools/convert_torch_checkpoint.py "
                f"and point `pretrained` at the result.")
        load_checkpoint(model, pretrained)
    init_cfg_view = dict(network_cfg)
    init_cfg_view.pop("pretrained", None)  # loaded above as a whole
    reset_init_info()  # this run's provenance only
    initialize_from_network_cfg(model, init_cfg_view, torch.Generator(
        ).manual_seed(derive_seed(seed, 7)))
    if get_init_info():
        with open(save_dir / "init_info.log", "w") as f:
            dump_init_info(logger=lambda line: f.write(line + "\n"))
    resume_path, prior_best_pth = args.resume_from, None
    if args.auto_resume and resume_path is None:
        resume_path, prior_best_pth = find_auto_resume(args, save_dir)
    resume_ckpt = None
    if args.load_from is not None:
        load_checkpoint(model, args.load_from)
    elif resume_path is not None and Path(resume_path).exists():
        resume_ckpt = load_checkpoint(model, resume_path)
    model.to(device)
    state = create_train_state(model, optimizer_cfg, lr_cfg,
                               steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model parameters: {n_params / 1e6:.2f}M")
    start_epoch, resume_ema = 0, None
    if resume_ckpt is not None:
        train_state = resume_ckpt.get("train_state")
        if train_state is not None:
            resume_ema = unpack_train_state(state, train_state, resume_path)
        start_epoch = int(resume_ckpt.get("metadata", {}).get(
            "epoch", -1)) + 1
        print(f"resumed from {resume_path} at epoch {start_epoch}")

    # Step 8: epoch loop
    aug_pipeline = train_dataset.device_pipeline  # fused into the step
    train_step = make_train_step(state.model, state.optimizer,
                                 state.scheduler, pipeline=aug_pipeline)
    ema_params_fn = None
    if args.ema_decay is not None:
        train_step, ema_params_fn = wrap_train_step_with_ema(
            train_step, model, args.ema_decay, ema_init=resume_ema)
        print(f"EMA enabled (decay={args.ema_decay})"
              + (" — resumed EMA state" if resume_ema is not None else ""))
    # logits at the uniform original size only where the dataset gives
    # original-resolution labels
    uniform_val = (val_dataset.ori_img_size
                   if getattr(val_dataset, "return_ori_seg_gt", False)
                   else None)
    eval_step = make_eval_step(model, rescale_size=uniform_val)
    best_fits = float("inf")
    # a resumed run keeps the prior run's best unless it beats it
    seed_best = prior_best_pth if prior_best_pth is not None else (
        Path(resume_path).parent / "best.pth" if resume_path else None)
    if seed_best is not None and Path(seed_best).is_file():
        best_fits = float(load_file(seed_best).get("metadata", {}).get(
            "fits", float("inf")))
        print(f"prior best fits={best_fits:.4f} (from {seed_best})")

    try:
        for epoch in range(start_epoch, epochs):
            generator = torch.Generator(device=device).manual_seed(
                derive_seed(seed, EPOCH_STREAM, epoch))
            with ExitStack() as stack:
                profiler = None
                if args.profile_dir is not None and epoch == start_epoch:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(
                            torch.profiler.ProfilerActivity.CUDA)
                    profiler = stack.enter_context(torch.profiler.profile(
                        activities=activities))
                state, train_vars = train_one_epoch(
                    epoch, train_step, state, train_loader,
                    generator=generator, fused_aug=aug_pipeline is not None)
            if profiler is not None:
                Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
                trace = Path(args.profile_dir) / f"epoch_{epoch}.json"
                profiler.export_chrome_trace(str(trace))
                print(f"profiler trace written to {trace}")
            lr_now = (epoch_rule.lr_at_epoch(epoch, base_lr) if epoch_rule
                      else base_lr)
            print(f"epoch {epoch}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in train_vars.items()) +
                  f" lr={float(lr_now):.6f}")

            val_vars, val_metrics = {}, {}
            fits = train_vars.get("loss", 0.0)
            ema = ema_params_fn() if ema_params_fn else None
            # validation and best.pth on the EMA parameters where it is on
            with ema_weights(model, ema):
                if not args.no_validate:
                    evaluator = SegEvaluator(
                        epoch,
                        num_classes=val_dataset.num_classes,
                        class_names=val_dataset.CLASSES,
                        palette=val_dataset.PALETTE,
                        ignore_index=(val_dataset.ignore_index
                                      if val_dataset.ignore_index is not None
                                      else 255),
                        output_dir=str(save_dir / "pred_results"))
                    val_vars, val_metrics = validate_one_epoch(
                        epoch, eval_step, state, val_loader, evaluator,
                        pipeline=val_dataset.device_pipeline)
                    print(f"epoch {epoch} val: " +
                          " ".join(f"{k}={v:.4f}"
                                   for k, v in val_vars.items()))
                    # composite model-selection score (train + val loss and
                    # 1 - mIoU of each head there is)
                    fits = train_vars.get("loss", 0.0) + val_vars.get(
                        "loss", 0.0)
                    for head in ("decode", "aux"):
                        miou = val_metrics.get(head, {}).get("mIoU")
                        if miou is not None:
                            fits += 1.0 - float(miou) / 100.0
                meta = pth_metadata(metadata, epoch, fits, train_vars,
                                    val_vars, val_metrics)
                if fits < best_fits:
                    best_fits = fits
                    save_model(state, meta, best_pth,
                               include_train_state=True,
                               backend=args.ckpt_backend)
                    print(f"epoch {epoch}: new best fits={fits:.4f} → "
                          f"{best_pth}")
            save_model(state, meta, last_pth, include_train_state=True,
                       backend=args.ckpt_backend, ema_params=ema)
    finally:
        train_loader.close()
        val_loader.close()
    print(f"done. best fits={best_fits:.4f}; checkpoints in {weights_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
