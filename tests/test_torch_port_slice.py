"""The whole serving slice against the JAX package: the flagship structure
(ResNetV1c-d8 + ASPP + FCN aux) at depth 18 with narrow widths, on 64²
images.

Logits: rtol 1e-3 and atol 3e-3 with identical hard predictions except at
genuine ties (the tolerance the full-depth flagship parity test uses; the
error grows through ~20 reordered float32 conv sums).  Metrics: equal to
1e-6.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (assert_argmax_parity, bridge,  # noqa: E402
                                init_jax, jax_apply, tiny_flagship_cfg,
                                to_nchw, to_nhwc)

from image_segmentation_lab_tpu.core.dataset.synthetic import \
    SyntheticDataset  # noqa: E402
from image_segmentation_lab_tpu.core.evaluation import \
    SegEvaluator as JSegEvaluator  # noqa: E402
from image_segmentation_lab_tpu.core.initialize.checkpoint import \
    save_checkpoint  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu_torch.core.dataset.synthetic import \
    make_synthetic_item  # noqa: E402
from image_segmentation_lab_tpu_torch.core.evaluation import \
    SegEvaluator  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.inference import (  # noqa: E402
    inference_model, init_model)
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402

SLIDE = dict(mode="slide", crop_size=(48, 48), stride=(32, 32))  # 2x2 grid
FLAGSHIP_CONFIG = "configs/network/deeplabv3/deeplabv3_r50-d8.py"


@pytest.fixture(scope="module")
def slice_pair():
    cfg = tiny_flagship_cfg(SLIDE)
    jm = jax_build(cfg)
    variables = init_jax(jm, jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64), jnp.int32),
                         method="forward_train", train=False)
    pm = bridge(build_segmentor(cfg), variables)
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    return jm, variables, pm, x


def test_whole_inference(slice_pair):
    jm, variables, pm, x = slice_pair
    ref = jax_apply(jm, variables, x, method="whole_inference", rescale=False)
    with torch.no_grad():
        out = pm.whole_inference(to_nchw(x), rescale=False)
    assert_argmax_parity(ref, to_nhwc(out))


@pytest.fixture(scope="module")
def slide_logits(slice_pair):
    jm, variables, pm, x = slice_pair
    ref = jax_apply(jm, variables, x, method="slide_inference", rescale=False)
    with torch.no_grad():
        out = pm.slide_inference(to_nchw(x), rescale=False)
    return ref, out


def test_slide_inference(slide_logits):
    ref, out = slide_logits
    assert_argmax_parity(ref, to_nhwc(out))


def test_predict(slice_pair):
    jm, variables, pm, x = slice_pair
    ref = jax_apply(jm, variables, x, method="predict", rescale=False)
    with torch.no_grad():
        out = pm.predict(to_nchw(x), rescale=False)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_predict_binary_head():
    """A one-channel head: sigmoid, then the configured threshold."""
    cfg = tiny_flagship_cfg()
    cfg["decode_head"].update(out_channels=1, threshold=0.5)
    del cfg["auxiliary_head"]
    jm = jax_build(cfg)
    x = np.random.RandomState(8).randn(2, 64, 64, 3).astype(np.float32)
    variables = init_jax(jm, jnp.zeros((1, 64, 64, 3)),
                         method="encode_decode")
    pm = bridge(build_segmentor(cfg), variables)
    ref = jax_apply(jm, variables, x, method="predict", rescale=False)
    with torch.no_grad():
        out = pm.predict(to_nchw(x), rescale=False)
    assert 0 < ref.mean() < 1  # both sides of the threshold occur
    np.testing.assert_array_equal(out.numpy(), ref)


def test_evaluator_metrics(slide_logits):
    """Two heads, ``decode`` and a dict of aux heads, over three batches
    that accumulate: the port's metrics equal the JAX SegEvaluator's."""
    ref, out = slide_logits
    gt = np.random.RandomState(3).randint(0, 2, ref.shape[:3])
    gt[:, :5] = 255
    aux = np.random.RandomState(4).randn(*ref.shape).astype(np.float32)
    kw = dict(epoch=0, num_classes=2, class_names=["bg", "fg"],
              palette=[[0, 0, 0], [255, 255, 255]], show_result=False)
    jev, pev = JSegEvaluator(**kw), SegEvaluator(**kw)
    for i, b in enumerate((slice(0, 1), slice(1, 2), slice(0, 2))):
        jev.process(i, {"decode": ref[b], "aux": {0: aux[b]}},
                    {"ori_gt": gt[b]})
        pev.process(i, {"decode": out[b], "aux": {0: to_nchw(aux[b])}},
                    {"ori_gt": gt[b]})
    jm, pm = jev.compute_metrics(), pev.compute_metrics()
    assert set(jm) == set(pm) == {"decode", "aux_0"}
    for head in jm:
        assert set(jm[head]) == set(pm[head]) and "mIoU" in pm[head]
        for key in jm[head]:
            np.testing.assert_allclose(pm[head][key], jm[head][key], rtol=0,
                                       atol=1e-6, err_msg=f"{head} {key}")


def test_init_model_loads_a_jax_checkpoint(tmp_path):
    """``init_model`` on the flagship config, cut to depth 18 and narrow
    widths by overriding its dict, loads a checkpoint the JAX package's
    ``save_checkpoint`` wrote; ``inference_model`` then predicts what the
    JAX model predicts."""
    network = load_python_config(FLAGSHIP_CONFIG)["model"]
    network["backbone"].update(depth=18, stem_channels=8, base_channels=8)
    network["decode_head"].update(in_channels=64, channels=16)
    network["auxiliary_head"].update(in_channels=32, channels=8)
    config = tmp_path / "deeplabv3_r18_narrow.py"
    config.write_text(f"model = {network!r}\n")

    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64), jnp.int32),
                         method="forward_train", train=False)
    checkpoint = tmp_path / "weights.pth"
    save_checkpoint(variables, checkpoint,
                    metadata={"CLASSES": ["bg", "fg"],
                              "PALETTE": [[0, 0, 0], [0, 63, 255]]})

    model = init_model(config, checkpoint=checkpoint, device="cpu")
    assert model.classes == ["bg", "fg"] and not model.training
    x = np.random.RandomState(9).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax_apply(jm, variables, x, method="predict", rescale=False)
    np.testing.assert_array_equal(inference_model(model, x), ref)
    np.testing.assert_array_equal(inference_model(model, x[0]), ref[0])


def test_synthetic_images_match_the_jax_dataset():
    ds = SyntheticDataset(
        pipeline="configs/augmentation/synthetic_train_transform.yaml",
        image_size=(40, 48), seed=3)
    for idx in (0, 5):
        image, mask = make_synthetic_item(idx, (40, 48), seed=3)
        ref_image, ref_mask = ds._make_item(idx)
        np.testing.assert_array_equal(image, ref_image)
        np.testing.assert_array_equal(mask, ref_mask)
