"""The port's datasets, loader and fused train step against the JAX
package, on the CPU.

- ``SyntheticDataset`` items bit for bit, with the pipeline's Resize at the
  item's size (no resize) and at another (cv2 in both packages);
- ``CustomDataset`` subclasses on JPEG and PNG files (a palette PNG among
  them) that the test writes with cv2 and Pillow: the same items and
  infos; the ``DATASET`` registry builds ``configs/dataset/
  synthetic_640.py``;
- the ``DataLoader``: the JAX loader's batches in the JAX loader's order,
  with and without ``drop_last``, on one worker and none, and ``close``;
- one fused train step of the tiny flagship (``tiny_flagship_train_cfg``,
  head dropout off, so neither package draws) with the pinned Kvasir
  pipeline, against the JAX step built with the same pipeline: losses at
  1e-5, parameters and BN statistics at rtol 1e-4 / atol 1e-5;
- ``validate_one_epoch`` with the val pipeline: the same metrics.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax, tiny_flagship_train_cfg)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import DATASET as JDATASET  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_from_cfg as jbuild_from_cfg  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.core.dataset import \
    DataLoader as JDataLoader  # noqa: E402
from image_segmentation_lab_tpu.core.evaluation import \
    SegEvaluator as JSegEvaluator  # noqa: E402
from image_segmentation_lab_tpu.data.pipeline import \
    Pipeline as JPipeline  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.utils import \
    train_utils as jtrain_utils  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.core.builder import (  # noqa: E402
    DATASET, build_from_cfg)
from image_segmentation_lab_tpu_torch.core.dataset import (  # noqa: E402
    DataLoader, SyntheticDataset)
from image_segmentation_lab_tpu_torch.core.evaluation import \
    SegEvaluator  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.data import albu_yaml  # noqa: E402
from image_segmentation_lab_tpu_torch.data.pipeline import \
    Pipeline  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.utils import train_utils  # noqa: E402

SCHEDULE = load_python_config("configs/schedule/kvasir_training_schedule.py")
VAL_YAML = "configs/augmentation/synthetic_val_transform.yaml"
PINNED_YAML = "tests/data/kvasir_train_transform_pinned.yaml"
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
SIZE = 32


def resized_spec(path, size):
    """The YAML at ``path`` with its leading Resize at ``size``."""
    spec = albu_yaml.load(path)
    spec["transform"]["transforms"][0].update(height=size, width=size)
    return spec


def assert_items_equal(item, ref):
    (img, mask, infos), (rimg, rmask, rinfos) = item, ref
    assert img.dtype == rimg.dtype and mask.dtype == rmask.dtype
    np.testing.assert_array_equal(img, rimg)
    np.testing.assert_array_equal(mask, rmask)
    assert sorted(infos) == sorted(rinfos)
    for key, value in rinfos.items():
        np.testing.assert_array_equal(infos[key], value, err_msg=key)


# ---------------------------------------------------------------- datasets

@pytest.mark.parametrize("size", [24, 40])
def test_synthetic_items_equal_jax(size):
    spec = resized_spec(VAL_YAML, size)
    kw = dict(length=3, image_size=(24, 24), num_classes=3, seed=4,
              return_ori_seg_gt=True)
    ds = SyntheticDataset(pipeline=Pipeline.from_dict(spec), **kw)
    ref = jbuild_from_cfg(dict(type="SyntheticDataset",
                               pipeline=JPipeline.from_dict(spec), **kw),
                          JDATASET)
    assert len(ds) == len(ref) and ds.CLASSES == ref.CLASSES
    assert ds.PALETTE == ref.PALETTE and ds.input_size_hw == (size, size)
    for idx in range(len(ds)):
        assert_items_equal(ds[idx], ref[idx])


def test_dataset_registry_builds_synthetic_640():
    cfg = load_python_config("configs/dataset/synthetic_640.py")["dataset"]
    jcfg = load_python_config("configs/dataset/synthetic_640.py")["dataset"]
    for split in ("train", "val", "test"):
        ds = build_from_cfg(cfg[split], DATASET)
        ref = jbuild_from_cfg(jcfg[split], JDATASET)
        assert type(ds).__name__ == "SyntheticDataset" and len(ds) == len(ref)
        assert ds.input_size_hw == ref.input_size_hw == (640, 640)
        assert_items_equal(ds[1], ref[1])
    assert "KvasirSegDataset" in DATASET._storage
    assert "CityscapesDataset" in DATASET._storage


def write_files(tmp_path, name, image, mask, mask_suffix):
    img_dir, ann_dir = tmp_path / "img", tmp_path / "ann"
    img_dir.mkdir(exist_ok=True)
    ann_dir.mkdir(exist_ok=True)
    cv2.imwrite(str(img_dir / f"{name}.jpg"), image)
    if isinstance(mask, Image.Image):
        mask.save(ann_dir / f"{name}{mask_suffix}")
    else:
        cv2.imwrite(str(ann_dir / f"{name}{mask_suffix}"), mask)
    return str(img_dir), str(ann_dir)


def palette_png(index):
    im = Image.fromarray(index, mode="P")
    palette = np.zeros((256, 3), np.uint8)
    palette[15] = [192, 128, 128]
    palette[255] = [224, 224, 192]
    im.putpalette(palette.flatten().tolist())
    return im


def dataset_cases(tmp_path):
    """``{name: (cfg, n_items)}`` over files the test writes: Kvasir JPEG
    masks binarised at 250, a VOC palette PNG, ADE's reduce_zero_label and
    a class subset remapped through label_map."""
    rng = np.random.RandomState(0)

    def image(h, w):
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)

    cases = {}
    kv = tmp_path / "kvasir"
    kv.mkdir()
    for i, (h, w) in enumerate([(30, 40), (36, 28)]):
        mask = np.where(rng.rand(h, w) > 0.5, 255, 0).astype(np.uint8)
        dirs = write_files(kv, f"k{i}", image(h, w), mask, ".jpg")
    cases["kvasir"] = (dict(type="KvasirSegDataset", img_dir=dirs[0],
                            ann_dir=dirs[1], seg_map_suffix=".jpg",
                            return_ori_seg_gt=True,
                            pipeline=resized_spec(VAL_YAML, 32)), 2)
    voc = tmp_path / "voc"
    voc.mkdir()
    index = np.zeros((24, 24), np.uint8)
    index[:10] = 15
    index[:, :3] = 255
    dirs = write_files(voc, "v0", image(24, 24), palette_png(index), ".png")
    cases["voc_palette"] = (dict(type="PascalVOCDataset", img_dir=dirs[0],
                                 ann_dir=dirs[1],
                                 pipeline=resized_spec(VAL_YAML, 24)), 1)
    ade = tmp_path / "ade"
    ade.mkdir()
    ann = np.full((20, 20), 3, np.uint8)
    ann[:5] = 0
    dirs = write_files(ade, "a0", image(20, 20), ann, ".png")
    cases["ade_reduce_zero"] = (dict(type="ADE20KDataset", img_dir=dirs[0],
                                     ann_dir=dirs[1], ori_img_size=(20, 20),
                                     pipeline=resized_spec(VAL_YAML, 16)), 1)
    sub = tmp_path / "subset"
    sub.mkdir()
    ann = np.array([[0, 1], [2, 1]], np.uint8).repeat(8, 0).repeat(8, 1)
    dirs = write_files(sub, "s0", image(16, 16), ann, ".png")
    cases["subset_label_map"] = (dict(
        type="STAREDataset", img_dir=dirs[0], ann_dir=dirs[1],
        img_suffix=".jpg", seg_map_suffix=".png", classes=["vessel"],
        pipeline=resized_spec(VAL_YAML, 16)), 1)
    return cases


def test_file_datasets_equal_jax(tmp_path):
    for name, (cfg, n) in dataset_cases(tmp_path).items():
        ds = build_from_cfg(cfg, DATASET)
        jcfg = dict(cfg, pipeline=JPipeline.from_dict(cfg["pipeline"]))
        ref = jbuild_from_cfg(jcfg, JDATASET)
        assert len(ds) == len(ref) == n, name
        assert ds.label_map == ref.label_map, name
        assert list(ds.CLASSES) == list(ref.CLASSES), name
        for idx in range(n):
            assert_items_equal(ds[idx], ref[idx])
        batch = ds.collate_fn([ds[i] for i in range(n)])
        jbatch = ref.collate_fn([ref[i] for i in range(n)])
        np.testing.assert_array_equal(batch[0], jbatch[0])
        np.testing.assert_array_equal(batch[1], jbatch[1])
        assert batch[2]["ori_img_size_hw"] == jbatch[2]["ori_img_size_hw"]


def test_palette_mask_loads_as_indices(tmp_path):
    cfg, _ = dataset_cases(tmp_path)["voc_palette"]
    _, mask, _ = build_from_cfg(cfg, DATASET)[0]
    assert set(np.unique(mask).astype(int)) == {0, 15, 255}


def test_collate_mixed_shapes_raises():
    ds = SyntheticDataset(pipeline=resized_spec(VAL_YAML, 16), length=2,
                          image_size=(16, 16))
    a, m, i = ds[1]
    with pytest.raises(ValueError, match="mixed image sizes"):
        ds.collate_fn([ds[0], (a[:-4], m[:-4], i)])


# ------------------------------------------------------------------ loader

def synthetic_pair(length=7):
    spec = resized_spec(VAL_YAML, 16)
    kw = dict(length=length, image_size=(16, 16), seed=3)
    return (SyntheticDataset(pipeline=Pipeline.from_dict(spec), **kw),
            jbuild_from_cfg(dict(type="SyntheticDataset",
                                 pipeline=JPipeline.from_dict(spec), **kw),
                            JDATASET))


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_equal_jax(workers, drop_last):
    ds, ref = synthetic_pair()
    kw = dict(batch_size=3, shuffle=True, num_workers=workers, seed=2,
              drop_last=drop_last)
    loader = DataLoader(ds, collate_fn=ds.collate_fn, **kw)
    jloader = JDataLoader(ref, collate_fn=ref.collate_fn, **kw)
    try:
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            batches, refs = list(loader), list(jloader)
            assert len(batches) == len(refs) == len(loader) == (
                2 if drop_last else 3)
            for (img, mask, infos), (rimg, rmask, rinfos) in zip(batches,
                                                                 refs):
                np.testing.assert_array_equal(img, rimg)
                np.testing.assert_array_equal(mask, rmask)
                assert infos["img_file_path"] == rinfos["img_file_path"]
    finally:
        loader.close()
        jloader.close()
    assert loader._pool is None and loader._prefetcher is None


def test_loader_order_without_shuffle_and_close():
    ds, _ = synthetic_pair(length=5)
    loader = DataLoader(ds, batch_size=2, num_workers=2,
                        collate_fn=ds.collate_fn)
    names = [n for _, _, infos in loader for n in infos["img_file_path"]]
    assert names == [f"synthetic_{i:05d}.jpg" for i in range(5)]
    loader.close()
    assert list(DataLoader(ds, batch_size=5, num_workers=0))[0][0].shape == (
        5, 16, 16, 3)


# ------------------------------------------------- fused step, validation

def jax_model(network):
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, SIZE, SIZE, 3)),
                         jnp.zeros((1, SIZE, SIZE), jnp.int32),
                         method="forward_train", train=False)
    return jm, variables


def jax_state(variables, tx=None):
    params = variables["params"]
    return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             frozen_params={},
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(params) if tx else None)


def raw_batch(seed, n=2):
    """A loader's batch: uint8 images (n, SIZE, SIZE, 3), float masks."""
    ds = SyntheticDataset(pipeline=resized_spec(VAL_YAML, SIZE), length=n,
                          image_size=(SIZE, SIZE), seed=seed)
    return ds.collate_fn([ds[i] for i in range(n)])[:2]


def test_fused_train_step_matches_jax():
    network = tiny_flagship_train_cfg()
    jm, variables = jax_model(network)
    spec = resized_spec(PINNED_YAML, SIZE)
    tx = jbuild_optimizer(SCHEDULE["optimizer"])
    imgs, masks = raw_batch(seed=11)
    jstate = jax_state(variables, tx)
    jstep = compile_quickly(
        jtrain.make_train_step(jm, tx, donate=False,
                               pipeline=JPipeline.from_dict(spec)),
        jstate, imgs, masks.astype(np.int32), jax.random.PRNGKey(0))
    jstate, jlog = jstep(jstate, imgs, masks.astype(np.int32),
                         jax.random.PRNGKey(0))

    model = bridge(build_segmentor(network), variables)
    state = train_state.create_train_state(model, SCHEDULE["optimizer"])
    step = train_state.make_train_step(state.model, state.optimizer,
                                       pipeline=Pipeline.from_dict(spec))
    log = step(torch.from_numpy(imgs), torch.from_numpy(masks),
               torch.Generator().manual_seed(0))
    assert sorted(log) == sorted(jlog)
    for key, ref in jlog.items():
        tol = dict(rtol=1e-6, atol=0) if "acc" in key else LOSS_TOL
        np.testing.assert_allclose(log[key].numpy(), np.asarray(ref),
                                   err_msg=key, **tol)
    ref_model = bridge(build_segmentor(network), jstate.variables())
    ref_state = ref_model.state_dict()
    for key, value in state.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(),
                                       ref_state[key].numpy(), err_msg=key,
                                       **STATE_TOL)


def test_validate_one_epoch_with_the_val_pipeline_matches_jax():
    network = tiny_flagship_train_cfg()
    jm, variables = jax_model(network)
    spec = resized_spec("configs/augmentation/kvasir_val_transform.yaml",
                        SIZE)
    batches = [raw_batch(seed=s) for s in (12, 13)]
    shape = (2, SIZE, SIZE, 3)
    jstep = compile_quickly(jtrain.make_eval_step(jm), jax_state(variables),
                            np.zeros(shape, np.float32),
                            np.zeros(shape[:3], np.int32))
    kw = dict(epoch=0, num_classes=2, class_names=["background", "object"],
              palette=[[0, 0, 0], [0, 63, 255]], show_result=False)
    ref_vars, ref_metrics = jtrain_utils.validate_one_epoch(
        0, jstep, jax_state(variables), [(i, m, {}) for i, m in batches],
        JSegEvaluator(**kw), pipeline=JPipeline.from_dict(spec), log=False)
    model = bridge(build_segmentor(network), variables)
    port_vars, metrics = train_utils.validate_one_epoch(
        0, train_state.make_eval_step(model),
        train_state.TrainState(model, optimizer=None),
        [(i, m, {}) for i, m in batches], SegEvaluator(**kw),
        pipeline=Pipeline.from_dict(spec))
    assert sorted(port_vars) == sorted(ref_vars)
    for key, value in ref_vars.items():
        np.testing.assert_allclose(port_vars[key], value, err_msg=key,
                                   **LOSS_TOL)
    assert sorted(metrics) == sorted(ref_metrics) == ["aux", "decode"]
    for head, values in ref_metrics.items():
        for key, value in values.items():
            np.testing.assert_array_equal(metrics[head][key], value,
                                          err_msg=f"{head}.{key}")
