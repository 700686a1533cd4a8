"""The port's panoptic, instance-export and instance-AP evaluators against
the JAX package's, on the same maps (numpy on both sides: exactly).

Seeded panoptic maps with void pixels, several instances of a class,
predictions that straddle void and near-0.5 overlaps; semantic maps with
``ignore_index`` and negative labels; query maps with -1 voids; masks with
a first pixel set, empty masks and zero scores; instance predictions of
several classes, one class with no gt anywhere, duplicate detections.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
from image_segmentation_lab_tpu.core import evaluation as jev  # noqa: E402

from image_segmentation_lab_tpu_torch.core import evaluation as ev  # noqa: E402,E501


def panoptic_pair(seed, shape=(3, 24, 30), classes=3):
    """(pred, gt) panoptic maps: blocks of classes with a few instances
    each and void, the prediction a shifted, partly relabelled copy."""
    rng = np.random.RandomState(seed)
    n, h, w = shape
    gt = np.full(shape, -1, np.int64)
    pred = np.full(shape, -1, np.int64)
    for i in range(n):
        for _ in range(6):
            c, inst = rng.randint(classes), rng.randint(1, 4)
            y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
            dy, dx = rng.randint(3, 12), rng.randint(3, 12)
            gt[i, y:y + dy, x:x + dx] = c * ev.INSTANCE_OFFSET + inst
            sy, sx = y + rng.randint(-2, 3), x + rng.randint(-2, 3)
            pc = c if rng.rand() < 0.8 else rng.randint(classes)
            pred[i, max(sy, 0):sy + dy, max(sx, 0):sx + dx] = \
                pc * ev.INSTANCE_OFFSET + inst
        gt[i, rng.rand(h, w) < 0.05] = -1
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_evaluator_matches_jax(seed):
    pred, gt = panoptic_pair(seed)
    ours, ref = ev.PanopticEvaluator(3), jev.PanopticEvaluator(3)
    for p, g in zip(pred, gt):
        ours.process(p, g)
        ref.process(p, g)
    ours.process(pred, gt)  # a batch too
    ref.process(pred, gt)
    assert ours.compute() == ref.compute()
    assert ev.panoptic_quality(pred, gt, 3) == jev.panoptic_quality(pred, gt,
                                                                    3)


def test_panoptic_encodings_match_jax():
    rng = np.random.RandomState(3)
    semantic = rng.randint(-1, 4, (2, 9, 11))
    semantic[rng.rand(2, 9, 11) < 0.2] = 255
    np.testing.assert_array_equal(ev.semantic_to_panoptic(semantic, 255),
                                  jev.semantic_to_panoptic(semantic, 255))
    query_id = rng.randint(-1, 6, (9, 11))
    labels = rng.randint(0, 3, 6)
    keep = rng.rand(6) < 0.5
    np.testing.assert_array_equal(
        ev.queries_to_panoptic(query_id, labels, keep),
        jev.queries_to_panoptic(query_id, labels, keep))


def test_instance_export_matches_jax():
    rng = np.random.RandomState(4)
    masks = rng.rand(5, 7, 9) < 0.4
    masks[1, 0, 0] = True   # a run that starts with the mask
    masks[3] = False        # an empty mask
    labels = rng.randint(0, 3, 5)
    scores = np.array([0.9, 0.0, 0.35, 0.8, 0.6], np.float32)
    for m in masks:
        rle = ev.mask_to_rle(m)
        assert rle == jev.mask_to_rle(m)
        np.testing.assert_array_equal(ev.rle_to_mask(rle), m)
    assert ev.instances_to_json(labels, scores, masks) == \
        jev.instances_to_json(labels, scores, masks)


def test_instance_ap_evaluator_matches_jax():
    rng = np.random.RandomState(5)
    ours, ref = ev.InstanceAPEvaluator(4), jev.InstanceAPEvaluator(4)
    for _ in range(6):
        gt = rng.randint(0, 3, (12, 14))  # class 3 never has a gt
        gts = [(c, gt == c) for c in np.unique(gt)]
        preds = []
        for _ in range(5):
            c = rng.randint(0, 4)
            m = (gt == c) if rng.rand() < 0.6 else rng.rand(12, 14) < 0.3
            m = m & (rng.rand(12, 14) < 0.9)
            preds.append((c, float(rng.rand()), m))
        preds.append(preds[0])  # a duplicate detection
        ours.process(preds, gts)
        ref.process(preds, gts)
    got, want = ours.compute(), ref.compute()
    assert got == want
    assert got["per_class_AP"][3] is None and got["num_gt"][3] == 0
    assert ev.mask_iou(gts[0][1], preds[0][2]) == jev.mask_iou(gts[0][1],
                                                               preds[0][2])
    assert ev.IOU_THRESHOLDS == jev.IOU_THRESHOLDS
