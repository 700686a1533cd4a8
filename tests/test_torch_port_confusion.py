"""The port's confusion histograms against the JAX package's, exactly.

On the CPU the port's wrappers compute the plain version (``torch.argmax``
+ ``torch.bincount``); the JAX side runs its jnp path, its Pallas logits
kernel in interpret mode (``force='interpret'``) and its Pallas labels
kernel in interpret mode (``force='interpret_hist'``).  Counts are integers,
so every comparison is exact equality.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from image_segmentation_lab_tpu.ops.pallas.confusion import (  # noqa: E402
    _hist_pallas, confusion_histograms as jax_histograms)
from image_segmentation_lab_tpu_torch.ops import (  # noqa: E402
    confusion, nvcc_build)

# jitted: one compile per case instead of one per eager op and shape
jax_histograms = jax.jit(jax_histograms, static_argnums=(2, 3, 4))
_hist_pallas = jax.jit(_hist_pallas, static_argnums=(2, 3, 4))

# name: (gt shape (N, H, W), logit channels, num_classes, ignore_index)
CASES = {
    "c2_ignore255": ((2, 37, 29), 2, 2, 255),
    "c19_ignore255": ((2, 23, 41), 19, 19, 255),
    "c3_ignore_neg1": ((1, 33, 17), 3, 3, -1),
    "labels_out_of_range": ((2, 19, 31), 4, 4, 255),
    "all_ignored": ((1, 8, 8), 4, 4, 255),
    "ties": ((2, 21, 21), 5, 5, 255),
    "pixels_not_tile_multiple": ((1, 7, 11), 2, 2, 255),
    "channels_gt_classes": ((2, 17, 13), 6, 4, 255),
}


def make_case(name):
    shape, channels, num_classes, ignore = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    if name == "ties":  # few distinct values: many exact ties
        logits = rng.randint(0, 3, shape + (channels,)).astype(np.float32)
    else:
        logits = rng.randn(*shape, channels).astype(np.float32)
    gt = rng.randint(0, num_classes, shape)
    gt[rng.rand(*shape) < 0.15] = ignore
    if name == "labels_out_of_range":
        gt[rng.rand(*shape) < 0.1] = -1
        gt[rng.rand(*shape) < 0.1] = num_classes + 3
    if name == "all_ignored":
        gt[:] = ignore
    return logits, gt.astype(np.int32), num_classes, ignore


@pytest.mark.parametrize("force", ["jnp", "interpret", "interpret_hist"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_entries_match_jax(name, force):
    """Both port entries (logits, and labels fed the argmax) against one
    JAX path."""
    logits, gt, num_classes, ignore = make_case(name)
    ref = [np.asarray(r) for r in jax_histograms(
        jnp.asarray(logits), jnp.asarray(gt), num_classes, ignore, force)]
    logits_t = torch.from_numpy(
        np.ascontiguousarray(logits.transpose(0, 3, 1, 2)))
    gt_t = torch.from_numpy(gt)
    from_logits = confusion.confusion_histograms(logits_t, gt_t, num_classes,
                                                 ignore)
    from_labels = confusion.confusion_histograms_from_labels(
        torch.argmax(logits_t, dim=1).to(torch.int32), gt_t, num_classes,
        ignore)
    for out in (from_logits, from_labels):
        for a, b, what in zip(out, ref, ("inter", "pred", "label")):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


def test_labels_entry_skips_predictions_out_of_range():
    """Predictions below 0 or at/above num_classes count nowhere, as in the
    Pallas labels kernel (interpret mode) fed the same class maps."""
    _, gt, num_classes, ignore = make_case("labels_out_of_range")
    pred = np.random.RandomState(5).randint(
        -2, num_classes + 2, gt.shape).astype(np.int32)
    ref = _hist_pallas(jnp.asarray(pred.reshape(-1)),
                       jnp.asarray(gt.reshape(-1)), num_classes, ignore,
                       True)
    out = confusion.confusion_histograms_from_labels(
        torch.from_numpy(pred), torch.from_numpy(gt), num_classes, ignore)
    for a, b in zip(out, np.asarray(ref)):
        np.testing.assert_array_equal(a.numpy(), b)


BAD_INPUTS = {
    "gt_int64": lambda l, g: (l, g.long()),
    "logits_float64": lambda l, g: (l.double(), g),
    "gt_shape": lambda l, g: (l, g[:, :-1]),
    "too_few_channels": lambda l, g: (l[:, :1], g),
    "meta_device": lambda l, g: (l.to("meta"), g.to("meta")),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    logits = torch.zeros(1, 2, 4, 4)
    gt = torch.zeros(1, 4, 4, dtype=torch.int32)
    logits, gt = BAD_INPUTS[bad](logits, gt)
    with pytest.raises((TypeError, ValueError)):
        confusion.confusion_histograms(logits, gt, 2, 255)


def test_no_fallback_around_the_kernel(monkeypatch, tmp_path):
    """The wrapper module has no try/except that could fall back to the
    plain version, and a missing compiler raises instead of computing."""
    for module in (confusion, nvcc_build):
        tree = ast.parse(inspect.getsource(module))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    monkeypatch.setattr(confusion, "_lib", None)
    monkeypatch.setattr(nvcc_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        confusion.build_library()
