"""The port's losses and accuracy against the JAX package, on the CPU.

The same numpy inputs go to both: NCHW logits to the port, their NHWC
transpose to the JAX package, labels with ignored (255) pixels.  Losses
agree to rtol 1e-5 / atol 1e-6 (float32 sums taken in another order);
accuracy counts are exact, so it agrees to float32 rounding.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from image_segmentation_lab_tpu.models import losses as jlosses  # noqa: E402
from image_segmentation_lab_tpu_torch.core.registry_hub import LOSS  # noqa: E402,E501
from image_segmentation_lab_tpu_torch.models import build_loss  # noqa: E402
from image_segmentation_lab_tpu_torch.models import losses  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
IGNORE = 255


def logits(n=2, c=2, h=9, w=11, seed=0):
    return np.random.RandomState(seed).randn(n, c, h, w).astype(np.float32)


def labels(n=2, h=9, w=11, classes=2, seed=1):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, classes, (n, h, w)).astype(np.int64)
    gt[rng.rand(n, h, w) < 0.2] = IGNORE
    return gt


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


# name: (loss kwargs, channels, number of classes in the labels)
CE_CASES = {
    "sigmoid_onehot_2class": (dict(use_sigmoid=True), 2, 2),
    "sigmoid_onehot_class_weight": (
        dict(use_sigmoid=True, class_weight=[0.3, 1.7]), 2, 2),
    "sigmoid_onehot_avg_non_ignore": (
        dict(use_sigmoid=True, avg_non_ignore=True, loss_weight=0.4), 2, 2),
    "sigmoid_one_channel": (dict(use_sigmoid=True), 1, 2),
    "sigmoid_one_channel_avg_non_ignore": (
        dict(use_sigmoid=True, avg_non_ignore=True), 1, 2),
    "softmax": (dict(), 3, 3),
    "softmax_class_weight": (dict(class_weight=[0.5, 1.0, 2.0]), 3, 3),
    "softmax_avg_non_ignore": (dict(avg_non_ignore=True), 3, 3),
    "softmax_sum": (dict(reduction="sum"), 3, 3),
}


@pytest.mark.parametrize("name", sorted(CE_CASES))
def test_cross_entropy_matches_jax(name):
    kwargs, channels, classes = CE_CASES[name]
    pred, gt = logits(c=channels), labels(classes=classes)
    ref = jlosses.CrossEntropyLoss(**kwargs)(nhwc(pred), jnp.asarray(gt),
                                             ignore_index=IGNORE)
    out = losses.CrossEntropyLoss(**kwargs)(torch.from_numpy(pred),
                                            torch.from_numpy(gt),
                                            ignore_index=IGNORE)
    assert out.dtype == torch.float32 and out.dim() == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_sigmoid_onehot_keeps_out_of_range_labels_as_zero_rows():
    """A label past the channel count that is not ignored is a valid pixel
    with an all-zero target, as ``jax.nn.one_hot`` gives it."""
    pred, gt = logits(c=2), labels(classes=4)
    kwargs = dict(use_sigmoid=True, reduction="none")
    ref = jlosses.CrossEntropyLoss(**kwargs)(nhwc(pred), jnp.asarray(gt),
                                             ignore_index=IGNORE)
    out = losses.CrossEntropyLoss(**kwargs)(torch.from_numpy(pred),
                                            torch.from_numpy(gt),
                                            ignore_index=IGNORE)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_mask_cross_entropy_matches_jax():
    pred = logits(n=3, c=4)
    target = (np.random.RandomState(2).rand(3, 9, 11) > 0.5).astype(
        np.float32)
    label = np.array([2, 0, 3])
    kwargs = dict(use_mask=True, class_weight=np.linspace(0.5, 1.5, 11))
    ref = jlosses.CrossEntropyLoss(**kwargs)(
        nhwc(pred), jnp.asarray(target), jnp.asarray(label),
        ignore_index=None)
    out = losses.CrossEntropyLoss(**kwargs)(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(label), ignore_index=None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_class_weight_from_a_file(tmp_path):
    path = tmp_path / "weights.npy"
    np.save(path, np.array([0.25, 4.0], np.float32))
    pred, gt = logits(c=2), labels()
    ref = jlosses.CrossEntropyLoss(class_weight=[0.25, 4.0])(
        nhwc(pred), jnp.asarray(gt), ignore_index=IGNORE)
    out = build_loss(dict(type="CrossEntropyLoss", class_weight=str(path)))(
        torch.from_numpy(pred), torch.from_numpy(gt), ignore_index=IGNORE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert LOSS.get("CrossEntropyLoss") is losses.CrossEntropyLoss
    assert losses.CrossEntropyLoss(loss_name="loss_x").loss_name == "loss_x"


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_weight_reduce_loss(reduction):
    rng = np.random.RandomState(3)
    loss, weight = rng.rand(4, 5).astype(np.float32), rng.rand(4, 5)
    weight = weight.astype(np.float32)
    for avg_factor in (None, 7.0):
        if avg_factor is not None and reduction == "sum":
            with pytest.raises(ValueError):
                losses.weight_reduce_loss(torch.from_numpy(loss), None,
                                          reduction, avg_factor)
            continue
        ref = jlosses.weight_reduce_loss(jnp.asarray(loss),
                                         jnp.asarray(weight), reduction,
                                         avg_factor)
        out = losses.weight_reduce_loss(torch.from_numpy(loss),
                                        torch.from_numpy(weight), reduction,
                                        avg_factor)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# name: (pred maker, accuracy kwargs)
ACC_CASES = {
    # integer scores: many ties, which the stable sort breaks by class index
    "ties": (lambda: np.random.RandomState(4).randint(
        0, 2, (2, 4, 9, 11)).astype(np.float32), dict(ignore_index=IGNORE)),
    "ties_top2": (lambda: np.random.RandomState(5).randint(
        0, 3, (2, 4, 9, 11)).astype(np.float32),
        dict(topk=(1, 2), ignore_index=IGNORE)),
    "thresh": (lambda: logits(c=4), dict(thresh=0.5, ignore_index=IGNORE)),
    "no_ignore_index": (lambda: logits(c=4), dict()),
}


@pytest.mark.parametrize("name", sorted(ACC_CASES))
def test_accuracy_matches_jax(name):
    make, kwargs = ACC_CASES[name]
    pred = make()
    gt = labels(classes=4, seed=6)
    if "ignore_index" not in kwargs:
        gt = np.where(gt == IGNORE, 0, gt)
    ref = jlosses.accuracy(nhwc(pred), jnp.asarray(gt), **kwargs)
    out = losses.accuracy(torch.from_numpy(pred), torch.from_numpy(gt),
                          **kwargs)
    refs = ref if isinstance(ref, list) else [ref]
    outs = out if isinstance(out, list) else [out]
    assert len(refs) == len(outs)
    for a, b in zip(outs, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_accuracy_of_an_empty_batch_is_zero():
    out = losses.accuracy(torch.zeros(0, 2, 3, 3),
                          torch.zeros(0, 3, 3, dtype=torch.long))
    assert float(out) == 0.0
