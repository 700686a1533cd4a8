"""The PyTorch port's train and val CLIs against the JAX package, on the CPU.

``configs/network/fcn/fcn_r18_synthetic.py`` on a synthetic dataset of 16
train and 8 val items at 96² (copies of the synthetic YAMLs, which resize
to 160²; the Mask2Former comparisons run at their 160²), the schedule's
``deterministic=True``, SGD with StepLR, 2 steps an epoch.  Each CLI runs
in this process through ``main(argv)`` with ``--device cpu``; the global
state it sets (determinism, seeds, the compute policy) is restored after.

- The whole slice: the train CLI (1 epoch) writes ``best.pth``; the JAX
  package's ``load_checkpoint`` (strict), ``make_eval_step`` and
  ``validate_one_epoch`` score it on the same val split, and so does the
  port's val CLI: mIoU within 0.05 points, losses within 1e-4 relative,
  and the JAX eval logits within rtol 1e-4 / atol 1e-5 of the port's.
- Resume: ``--resume-from`` the 1-epoch run's ``last.pth`` to epoch 2 gives
  the parameters of an uninterrupted 2-epoch run within 1e-6; a train
  state that optax wrote raises ``SystemExit``; ``--auto-resume`` takes
  the newest ``exp``/``exp<N>`` run, never a sibling ``exp_ablation``.
- ``val --panoptic --instances --score`` against the JAX package's val CLI
  (the root ``val.py``, run in this process) on the same checkpoint and
  split: the all-stuff PQ of the FCN run's ``best.pth`` (a dense head has
  no instances: ``--instances`` raises in both), and on a seeded tiny
  Mask2Former checkpoint the query-competition PQ tables, the instance AP
  and ``instances.json`` (labels and RLE masks exactly, scores within
  1e-5: they are rounded to 6 decimals); ``--panoptic --tta`` at scale
  0.75 (the mask probabilities resized to the image, un-flipped and
  averaged over both views before one query competition): the same PQ
  table and PNGs.  The dense head's comparison is marked slow (a second
  JAX val program, about 9 s of compiling).
- Both CLIs stop (``SystemExit``) with no GPU unless ``--device cpu``, and
  on the flags that are not ported, naming their ROADMAP item.
- ``inference_model`` on a PNG the port wrote, through the val YAML,
  equals the JAX package's class map.
"""

import argparse
import json
import os
import pickle
import random
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import DATASET as JDATASET  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_from_cfg as jbuild_from_cfg  # noqa: E402
from image_segmentation_lab_tpu.core.dataset import \
    DataLoader as JDataLoader  # noqa: E402
from image_segmentation_lab_tpu.core.evaluation import \
    SegEvaluator as JSegEvaluator  # noqa: E402
from image_segmentation_lab_tpu.core.inference import \
    infer as jinfer  # noqa: E402
from image_segmentation_lab_tpu.core.initialize import \
    checkpoint as jckpt  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.utils import \
    train_utils as jtrain_utils  # noqa: E402
from image_segmentation_lab_tpu_torch import train, val  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import (  # noqa: E402
    imwrite, load_python_config)
from image_segmentation_lab_tpu_torch.core.inference import (  # noqa: E402
    inference_model, init_model)
from image_segmentation_lab_tpu_torch.core.initialize import \
    checkpoint  # noqa: E402
from image_segmentation_lab_tpu_torch.core.mixed_precision import \
    policy  # noqa: E402

NETWORK = "configs/network/fcn/fcn_r18_synthetic.py"
TRAIN_YAML = "configs/augmentation/synthetic_train_transform.yaml"
VAL_YAML = "configs/augmentation/synthetic_val_transform.yaml"
DATASET = """
dataset = dict(
    train=dict(type='SyntheticDataset', length=16, image_size=({0}, {0}),
               pipeline='{1}'),
    val=dict(type='SyntheticDataset', length=8, image_size=({0}, {0}),
             seed=1, return_ori_seg_gt=True, pipeline='{2}'))
"""
# the FCN runs' images: the synthetic YAMLs' 160² cut to 96² in copies
# (their Resize), which the CLIs and JAX see alike
SIZE = 96
SCHEDULE = """
seed = 0
deterministic = True
epochs = 2
train_batch_size = 8
val_batch_size = 4
num_workers = 0
optimizer = dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=0.0005)
lr_config = dict(type='StepLR', step_size=1, gamma=0.5)
amp = False
"""


@pytest.fixture(scope="module")
def restore_globals():
    states = (random.getstate(), np.random.get_state(),
              torch.get_rng_state(),
              torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark, policy.get_policy())
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.set_rng_state(states[2])
    torch.use_deterministic_algorithms(states[3])
    torch.backends.cudnn.deterministic = states[4]
    torch.backends.cudnn.benchmark = states[5]
    policy.set_policy(states[6])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, restore_globals):
    """The train CLI: 2 epochs (``full``), 1 epoch (``half``), and
    ``half``'s ``last.pth`` resumed to epoch 2 (``resumed``); ``full`` and
    ``resumed``, whose ``last.pth`` only the resume test reads, skip the
    validation (``--no-validate``), which changes no weight."""
    root = tmp_path_factory.mktemp("cli")
    yamls = []
    for name in (TRAIN_YAML, VAL_YAML):
        copy = root / os.path.basename(name)
        copy.write_text(open(name).read().replace(
            "height: 160\n    width: 160",
            f"height: {SIZE}\n    width: {SIZE}", 1))
        yamls.append(copy)
    (root / "dataset.py").write_text(DATASET.format(SIZE, *yamls))
    (root / "schedule.py").write_text(SCHEDULE)
    common = ["--network-cfg", NETWORK, "--dataset-cfg",
              str(root / "dataset.py"), "--schedule-cfg",
              str(root / "schedule.py"), "--work-dir", str(root / "runs"),
              "--device", "cpu", "--ema-decay", "0.9"]
    weights = {}
    for name, extra in (("full", ["--no-validate"]), ("half", [
            "--epochs", "1", "--profile-dir", str(root / "profile")])):
        assert train.main(common + ["--name", name] + extra) == 0
        weights[name] = root / "runs" / "train" / name / "weights"
    resume = ["--resume-from", str(weights["half"] / "last.pth"),
              "--no-validate"]
    assert train.main(common + ["--name", "resumed"] + resume) == 0
    weights["resumed"] = root / "runs" / "train" / "resumed" / "weights"
    return dict(root=root, common=common, weights=weights)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_resume_continues_the_uninterrupted_run(runs):
    """The parameters, the BN statistics and the EMA (--ema-decay 0.9)."""
    full = load(runs["weights"]["full"] / "last.pth")
    resumed = load(runs["weights"]["resumed"] / "last.pth")
    assert full["metadata"]["epoch"] == resumed["metadata"]["epoch"] == 1
    assert sorted(full["state_dict"]) == sorted(resumed["state_dict"])
    for name, value in full["state_dict"].items():
        np.testing.assert_allclose(resumed["state_dict"][name], value,
                                   rtol=0, atol=1e-6, err_msg=name)
    ema, ref = (c["train_state"]["ema_params"] for c in (resumed, full))
    assert sorted(ema) == sorted(ref) and len(ref) > 20
    for name, value in ref.items():
        np.testing.assert_allclose(ema[name], value, rtol=0, atol=1e-6,
                                   err_msg=name)
    assert resumed["train_state"]["step"] == full["train_state"]["step"] == 4


def test_best_holds_the_ema_and_the_profiler_wrote_a_trace(runs):
    best = load(runs["weights"]["half"] / "best.pth")
    last = load(runs["weights"]["half"] / "last.pth")
    ema = last["train_state"]["ema_params"]
    port, jax_key = ("backbone.layer1.blocks.0.conv1.weight",
                     "backbone.layer1.blocks_0.conv1.weight")
    np.testing.assert_array_equal(best["state_dict"][jax_key],
                                  np.transpose(ema[port], (2, 3, 1, 0)))
    assert not np.array_equal(best["state_dict"][jax_key],
                              last["state_dict"][jax_key])
    assert (runs["root"] / "profile" / "epoch_0.json").stat().st_size > 0


def test_resume_from_an_optax_train_state_raises(runs, tmp_path):
    ckpt = load(runs["weights"]["half"] / "last.pth")
    params = {"w": jnp.zeros(3)}
    ckpt["train_state"] = {"step": np.asarray(2), "opt_state": jax.device_get(
        optax.sgd(0.05, momentum=0.9).init(params))}
    path = tmp_path / "optax.pth"
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)
    with pytest.raises(SystemExit, match="--load-from"):
        train.main(runs["common"] + ["--name", "optax", "--resume-from",
                                     str(path)])


def test_auto_resume_takes_the_newest_run_of_its_name(tmp_path):
    base = tmp_path / "train"
    for i, name in enumerate(("exp", "exp2", "exp_ablation", "exp3")):
        weights = base / name / "weights"
        weights.mkdir(parents=True)
        if name != "exp3":  # the run being started
            (weights / "last.pth").write_bytes(b"")
            os.utime(weights / "last.pth", (i, i))
            os.utime(base / name, (i, i))
    args = argparse.Namespace(work_dir=tmp_path, project="train", name="exp")
    last, best = train.find_auto_resume(args, base / "exp3")
    assert last == base / "exp2" / "weights" / "last.pth"
    assert best == base / "exp2" / "weights" / "best.pth"


@pytest.fixture(scope="module")
def jax_scored(runs):
    """The JAX package's validation of the 1-epoch run's ``best.pth``."""
    network = load_python_config(NETWORK)["model"]
    jm = jax_build(network)
    template = init_jax(jm, jnp.zeros((1, SIZE, SIZE, 3)),
                        jnp.zeros((1, SIZE, SIZE), jnp.int32),
                        return_loss=True, train=True)
    variables, ckpt = jckpt.load_checkpoint(
        template, runs["weights"]["half"] / "best.pth", strict=True,
        logger=None)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"], frozen_params={},
                              batch_stats=variables["batch_stats"],
                              opt_state=None)
    cfg = load_python_config(runs["root"] / "dataset.py")["dataset"]["val"]
    dataset = jbuild_from_cfg(cfg, JDATASET)
    loader = JDataLoader(dataset, batch_size=4, num_workers=0,
                         collate_fn=dataset.collate_fn)
    img, gt, _ = next(iter(loader))
    img, gt = dataset.device_pipeline(jax.random.PRNGKey(0), img, gt)
    step = compile_quickly(jtrain.make_eval_step(jm, dataset.ori_img_size),
                           state, img, gt.astype(jnp.int32))
    evaluator = JSegEvaluator(0, num_classes=2, class_names=dataset.CLASSES,
                              palette=dataset.PALETTE, show_result=False)
    losses, metrics = jtrain_utils.validate_one_epoch(
        0, step, state, loader, evaluator,
        pipeline=dataset.device_pipeline, log=False)
    return dict(jm=jm, variables=variables, ckpt=ckpt, losses=losses,
                metrics=metrics, step=step, state=state, batch=(img, gt))


def test_whole_slice_scores_as_the_jax_package(runs, jax_scored):
    ref_losses, ref_metrics = jax_scored["losses"], jax_scored["metrics"]
    assert val.main(["--network-cfg", NETWORK, "--dataset-cfg",
                     str(runs["root"] / "dataset.py"), "--checkpoint",
                     str(runs["weights"]["half"] / "best.pth"),
                     "--work-dir", str(runs["root"] / "runs"),
                     "--device", "cpu", "--batch-size", "4",
                     "--num-workers", "0", "--save-pred"]) == 0
    run = runs["root"] / "runs" / "val" / "exp"
    results = json.loads((run / "results.json").read_text())
    assert sorted(results) == ["checkpoint", "losses", "metrics"]
    assert len(list((run / "predictions").iterdir())) == 8
    meta = jax_scored["ckpt"]["metadata"]
    for head in ("decode", "aux"):
        for source in (results["metrics"][head]["mIoU"],
                       meta[f"metric.{head}.mIoU"]):
            assert abs(source - float(ref_metrics[head]["mIoU"])) <= 0.05
    for key, value in ref_losses.items():
        np.testing.assert_allclose(results["losses"][key], value, rtol=1e-4,
                                   err_msg=key)
        np.testing.assert_allclose(meta[f"val.{key}"], value, rtol=1e-4,
                                   err_msg=key)
    # --tta (averaged probabilities, no losses) on the same split
    assert val.main(["--network-cfg", NETWORK, "--dataset-cfg",
                     str(runs["root"] / "dataset.py"), "--checkpoint",
                     str(runs["weights"]["half"] / "best.pth"),
                     "--work-dir", str(runs["root"] / "runs"),
                     "--device", "cpu", "--num-workers", "0", "--tta",
                     "--tta-scales", "0.75", "1.0"]) == 0
    tta = json.loads((run.parent / "exp2" / "results.json").read_text())
    assert tta["losses"] == {}
    assert 0 <= tta["metrics"]["decode"]["mIoU"] <= 100
    # the eval logits of the same checkpoint and batch
    img, gt = jax_scored["batch"]
    ref_logits, _ = jax_scored["step"](jax_scored["state"], img, gt)
    model = init_model(NETWORK, runs["weights"]["half"] / "best.pth",
                       device="cpu")
    from image_segmentation_lab_tpu_torch.train_state import make_eval_step
    logits, _ = make_eval_step(model, (SIZE, SIZE))(
        torch.from_numpy(np.transpose(np.asarray(img), (0, 3, 1, 2)).copy()),
        torch.from_numpy(np.array(gt)))
    for head, ref in ref_logits.items():
        np.testing.assert_allclose(
            np.transpose(logits[head].numpy(), (0, 2, 3, 1)),
            np.asarray(ref), rtol=1e-4, atol=1e-5, err_msg=head)


def test_inference_model_reads_a_png_through_the_val_yaml(runs, jax_scored,
                                                          tmp_path):
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (120, 200, 3)).astype(np.uint8)
    image[30:90, 60:140] = (40, 200, 250)
    path = tmp_path / "image.png"
    imwrite(image, path)
    model = init_model(NETWORK, runs["weights"]["half"] / "best.pth",
                       device="cpu")
    val_yaml = str(runs["root"] / os.path.basename(VAL_YAML))
    pred = inference_model(model, str(path), pipeline=val_yaml)
    ref = jinfer.inference_model(jinfer.InferenceModel(
        jax_scored["jm"], jax_scored["variables"], {}), str(path), val_yaml)
    assert pred.shape == ref.shape == (120, 200)
    assert (pred == np.asarray(ref)).mean() >= 0.999
    both = inference_model(model, [str(path), str(path)], pipeline=val_yaml)
    np.testing.assert_array_equal(both[1], pred)


def test_clis_stop_without_a_gpu_and_on_unported_flags(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    val_args = ["--network-cfg", NETWORK, "--dataset-cfg", "x",
                "--checkpoint", "x", "--work-dir", str(tmp_path)]
    for main, argv in ((train.main, ["--work-dir", str(tmp_path)]),
                       (val.main, val_args)):
        for device in ([], ["--device", "cuda"]):
            with pytest.raises(SystemExit, match="--device cpu"):
                main(argv + device)
    for flag in (["--fsdp"], ["--zero1"], ["--tp-shards", "2"],
                 ["--space-shards", "2"], ["--aug-shard-local"]):
        with pytest.raises(SystemExit, match="Queue 1 item 8"):
            train.main(flag)
    with pytest.raises(SystemExit, match="orbax"):
        train.main(["--ckpt-backend", "orbax_async"])
    assert not list(tmp_path.iterdir())  # nothing written
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.save_checkpoint(torch.nn.Linear(1, 1), tmp_path / "x",
                                   backend="orbax")


def test_float32_precision_turns_tf32_off():
    """What float32 means for the CLIs and ``init_model``: TF32 off for
    cuDNN and cuBLAS, as every float32 gate was measured."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        policy.float32_precision()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


# configs/network/maskformer/mask2former_r50.py cut to a depth-18 ResNetV1c
# of stage widths 8-64, width 32, 8 queries over 2 decoder layers
TINY_MASK2FORMER = """
model = dict(
    type='EncoderDecoder',
    backbone=dict(type='ResNetV1c', depth=18, num_stages=4,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 1, 1),
                  strides=(1, 2, 2, 2), stem_channels=8, base_channels=8,
                  norm_cfg=dict(type='SyncBatchNorm', requires_grad=True)),
    decode_head=dict(type='Mask2FormerHead', in_channels=[8, 16, 32, 64],
                     in_index=(0, 1, 2, 3),
                     input_transform='multiple_select', channels=32,
                     feat_channels=32, num_queries=8, num_decoder_layers=2,
                     num_heads=4, num_scales=3, feedforward_channels=64,
                     mask_loss_type='ce', num_points=64, dropout_ratio=0.0,
                     num_classes=2, align_corners=False),
    train_cfg=dict(), test_cfg=dict(mode='whole'))
"""


JIT = jax.jit


def quick_jit(fun=None, **kwargs):
    """``jax.jit`` whose programs ``compile_quickly`` builds, one per
    argument structure and shapes."""
    if fun is None:
        return lambda f: quick_jit(f, **kwargs)
    jitted, compiled = JIT(fun, **kwargs), {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(a), str(np.result_type(a)))
                           for a in leaves))
        if key not in compiled:
            compiled[key] = compile_quickly(jitted, *args)
        return compiled[key](*args)

    return call


def run_both_val_clis(monkeypatch, network, dataset, checkpoint, work, flags,
                      variables=None):
    """The port's val CLI and the JAX package's on the same arguments: each
    run's directory.  The JAX CLI's programs are compiled as
    ``compile_quickly`` compiles them; its init (whose values the
    checkpoint replaces) is jitted, or with ``variables`` returns those
    (the checkpoint's own: no program to trace for the train forward)."""
    import val as jax_val  # the root val.py
    monkeypatch.setattr(jax, "jit", quick_jit)
    monkeypatch.setattr(
        "image_segmentation_lab_tpu.utils.jit_init.jit_init_off_cpu",
        quick_jit if variables is None else lambda f: lambda *a: variables)
    argv = ["--network-cfg", str(network), "--dataset-cfg", str(dataset),
            "--checkpoint", str(checkpoint), "--device", "cpu",
            "--batch-size", "4", "--num-workers", "0", *flags]
    assert val.main(argv + ["--work-dir", str(work / "port")]) == 0
    monkeypatch.setattr(sys, "argv", ["val.py", *argv, "--work-dir",
                                      str(work / "jax")])
    # the JAX CLI would point JAX's compile cache at a directory of /tmp
    monkeypatch.setattr("image_segmentation_lab_tpu.utils.compile_cache."
                        "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert jax_val.main() == 0
    return [work / side / "val" / "exp" for side in ("port", "jax")]


def assert_same_pngs(port, ref):
    """The same 8 id2rgb PNG names in both directories, pixel for pixel."""
    import cv2
    pngs = sorted(p.name for p in port.iterdir())
    assert len(pngs) == 8 and pngs == sorted(p.name for p in ref.iterdir())
    for name in pngs:
        np.testing.assert_array_equal(cv2.imread(str(port / name)),
                                      cv2.imread(str(ref / name)),
                                      err_msg=name)


@pytest.mark.slow
def test_dense_head_panoptic_matches_the_jax_cli(runs, monkeypatch,
                                                  tmp_path):
    """All-stuff panoptic of the FCN run's ``best.pth``: the same PQ table
    and the same id2rgb PNGs; ``--instances`` needs a mask-classification
    head in both packages."""
    port, ref = run_both_val_clis(
        monkeypatch, NETWORK, runs["root"] / "dataset.py",
        runs["weights"]["half"] / "best.pth", tmp_path, ["--panoptic"])
    got, want = (json.loads((run / "results.json").read_text())
                 for run in (port, ref))
    assert got["panoptic"] == want["panoptic"]
    assert got["panoptic"]["per_class"]["TP"] != [0, 0]
    assert_same_pngs(port / "panoptic", ref / "panoptic")
    with pytest.raises(AttributeError, match="dense decode head"):
        val.main(["--network-cfg", NETWORK, "--dataset-cfg",
                  str(runs["root"] / "dataset.py"), "--checkpoint",
                  str(runs["weights"]["half"] / "best.pth"), "--device",
                  "cpu", "--num-workers", "0", "--instances", "--work-dir",
                  str(tmp_path / "dense_instances")])


@pytest.fixture(scope="module")
def tiny_mask2former(tmp_path_factory):
    """``TINY_MASK2FORMER``: its config file, the JAX module, seeded
    JAX-side variables and the port's model bridged from them."""
    path = tmp_path_factory.mktemp("mask2former") / "tiny_mask2former.py"
    path.write_text(TINY_MASK2FORMER)
    network = load_python_config(path)["model"]
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, 160, 160, 3)),
                         jnp.zeros((1, 160, 160), jnp.int32),
                         method="forward_train", train=False)
    from image_segmentation_lab_tpu_torch.models.builder import \
        build_segmentor
    model = bridge(build_segmentor(network), variables)
    return path, jm, variables, model


@pytest.fixture(scope="module")
def mask2former_checkpoint(runs, tiny_mask2former):
    """A tiny Mask2Former checkpoint of seeded JAX-side weights, written by
    the port (JAX layout)."""
    path, _, variables, model = tiny_mask2former
    checkpoint.save_checkpoint(model, runs["root"] / "mask2former.pth",
                               metadata={"epoch": 0})
    dataset = runs["root"] / "mask2former_dataset.py"
    dataset.write_text(DATASET.format(160, TRAIN_YAML, VAL_YAML))
    return path, runs["root"] / "mask2former.pth", variables, dataset


def test_mask2former_panoptic_and_instances_match_the_jax_cli(
        runs, mask2former_checkpoint, monkeypatch, tmp_path):
    network, ckpt, variables, dataset = mask2former_checkpoint
    port, ref = run_both_val_clis(
        monkeypatch, network, dataset, ckpt, tmp_path,
        ["--panoptic", "--instances", "--score",
         "--object-mask-threshold", "0.0", "--overlap-threshold", "0.0"],
        variables)
    got, want = (json.loads((run / "results.json").read_text())
                 for run in (port, ref))
    assert got["panoptic"] == want["panoptic"]
    per_class = got["panoptic"]["per_class"]
    assert sum(per_class["TP"]) + sum(per_class["FP"]) > 0  # segments kept
    assert got["instance_ap"] == pytest.approx(want["instance_ap"],
                                               rel=1e-6, nan_ok=True)
    records, ref_records = (json.loads((run / "instances.json").read_text())
                            for run in (port, ref))
    assert [r["image"] for r in records] == [r["image"] for r in ref_records]
    assert sum(len(r["instances"]) for r in records) > 0
    for rec, ref_rec in zip(records, ref_records):
        assert len(rec["instances"]) == len(ref_rec["instances"])
        for a, b in zip(rec["instances"], ref_rec["instances"]):
            assert a["label"] == b["label"]
            assert a["segmentation"] == b["segmentation"]
            assert abs(a["score"] - b["score"]) <= 1e-5


def test_mask2former_panoptic_tta_matches_the_jax_cli(
        runs, mask2former_checkpoint, monkeypatch, tmp_path):
    """The view-averaged query competition: one scale (0.75, so the mask
    probabilities are resized back to the image) and both flips."""
    network, ckpt, variables, dataset = mask2former_checkpoint
    port, ref = run_both_val_clis(
        monkeypatch, network, dataset, ckpt, tmp_path,
        ["--panoptic", "--tta", "--tta-scales", "0.75",
         "--object-mask-threshold", "0.0", "--overlap-threshold", "0.0"],
        variables)
    got, want = (json.loads((run / "results.json").read_text())
                 for run in (port, ref))
    assert got["panoptic"] == want["panoptic"]
    per_class = got["panoptic"]["per_class"]
    assert sum(per_class["TP"]) + sum(per_class["FP"]) > 0
    assert_same_pngs(port / "panoptic", ref / "panoptic")


# Two queries whose score-weighted mask probabilities lie this many float32
# ulps apart (of the larger) are a tie: either package may pick either.
# The packages' mask probabilities agree to about 1e-5 (some 300 ulps at
# 0.26); the tie below is 0-3 ulps wide in JAX and 1 in the port
TIE_ULPS = 8


def test_mask2former_panoptic_tta_ties_within_ulps(tiny_mask2former):
    """``--panoptic --tta`` at scale 0.75 and both flips on the 96² val
    split (the val YAML resizes to 160², the 0.75 view is 120²), image 7,
    module by module: the port's ``panoptic_tta_probs`` and
    ``panoptic_from_probs`` on the JAX pipeline's image against the JAX
    package's, composed as the JAX val CLI composes them and compiled as
    the CLI tests compile it (its flip outside the program).  At pixel
    (48, 112) queries 4 and 6 tie: their score-weighted mask probabilities
    lie within ``TIE_ULPS`` float32 ulps in both packages (the mask
    probabilities agree to about 1e-5, so the winner is either's), and the
    packages may pick different winners there.  Every other pixel has the
    same winner, and the labels and kept queries are equal."""
    from image_segmentation_lab_tpu.models.decode_heads.maskformer_head \
        import panoptic_from_probs as jax_panoptic_from_probs
    from image_segmentation_lab_tpu.utils.ops import resize as jax_resize
    from image_segmentation_lab_tpu_torch.models.decode_heads.\
        maskformer_head import panoptic_from_probs
    from image_segmentation_lab_tpu_torch.utils.ops import resize
    _, jm, variables, model = tiny_mask2former
    dataset = jbuild_from_cfg(dict(
        type='SyntheticDataset', length=8, image_size=(96, 96), seed=1,
        return_ori_seg_gt=True, pipeline=VAL_YAML), JDATASET)
    img, gt, _ = dataset.collate_fn([dataset[7]])
    img, _ = dataset.device_pipeline(jax.random.PRNGKey(1), img, gt)
    thresholds = dict(object_mask_threshold=0.0, overlap_threshold=0.0)

    # the view's probabilities, flipped back where the view was flipped
    # (one program for both views, which have one shape)
    view = quick_jit(lambda v, x: jm.apply(v, x, out_size=(160, 160),
                                           method="panoptic_tta_probs"))
    scaled = quick_jit(lambda x: jax_resize(
        x, size=(120, 120), mode="bilinear", align_corners=False))(img)
    (p0, m0), (p1, m1) = view(variables, scaled), view(
        variables, scaled[:, :, ::-1, :])
    jp, jmask = np.asarray((p0 + p1) / 2), np.asarray(
        (m0 + m1[:, :, :, ::-1]) / 2)
    jq, jl, jk = (np.asarray(a) for a in jax_panoptic_from_probs(
        jp, jmask, **thresholds))
    x = torch.from_numpy(np.transpose(np.asarray(img), (0, 3, 1, 2)).copy())
    with torch.no_grad():
        scaled = resize(x, size=(120, 120), mode="bilinear",
                        align_corners=False)
        views = [model.panoptic_tta_probs(scaled.flip(3) if flip else scaled,
                                          out_size=(160, 160), flip=flip)
                 for flip in (False, True)]
        pp, pmask = ((views[0][i] + views[1][i]) / 2 for i in (0, 1))
        pq, pl, pk = (t.numpy() for t in panoptic_from_probs(pp, pmask,
                                                             **thresholds))
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pk, jk)

    def weighted(probs, mask, b, y, x):
        return np.float32(mask[b, :, y, x]) * probs[b, :, :-1].max(-1)

    def within(w, q0, q1):
        return abs(w[q0] - w[q1]) <= TIE_ULPS * np.spacing(max(w[q0], w[q1]))

    pp, pmask = pp.numpy(), pmask.numpy()
    for w in (weighted(jp, jmask, 0, 48, 112),
              weighted(pp, pmask, 0, 48, 112)):
        assert np.argsort(w)[-2:].tolist() in ([4, 6], [6, 4])
        assert within(w, 4, 6)
    for b, y, x in zip(*np.nonzero(pq != jq)):
        q0, q1 = jq[b, y, x], pq[b, y, x]
        assert within(weighted(jp, jmask, b, y, x), q0, q1), (y, x)
        assert within(weighted(pp, pmask, b, y, x), q0, q1), (y, x)
    assert (pq != jq).sum() <= 1
