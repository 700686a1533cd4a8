"""The evaluator's per-image (ragged) path, its collages and prediction
files, and the port's PNG writer, against the JAX package, on the CPU.

- ``resize_logits`` gives the JAX ``resize_logits_np``'s bits (float32
  weights, rows then columns), from float32 and from bfloat16 logits.
- ``SegEvaluator.process`` on four images whose labels differ in size (a
  list, as Kvasir's ``return_ori_seg_gt`` gives them), logits as one batch
  and as a list, float32 and bfloat16, ``ignore_index`` -1 and 255, a
  decode and a list of aux heads: the running counts equal the JAX
  evaluator's exactly, and so do mIoU, mDice and mFscore.
- The collage canvas equals JAX's ``plot_results`` canvas bit for bit (the
  JAX module's ``imwrite`` captured with ``monkeypatch``), on the uniform
  and the ragged path; the port writes it as PNG.
- ``--save-pred`` files decode with Pillow to the JAX files' pixels and
  palette (palette images, and 16-bit gray without a palette).
- ``imwrite``: RGB from BGR, palette and 16-bit gray (clipped as Pillow
  clips mode ``"I"``) decode with Pillow to the input.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from PIL import Image  # noqa: E402

from image_segmentation_lab_tpu.core.evaluation import \
    metrics as jmetrics  # noqa: E402
from image_segmentation_lab_tpu_torch.core.evaluation import \
    metrics  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import imwrite  # noqa: E402
from image_segmentation_lab_tpu_torch.ops import confusion  # noqa: E402

CLASSES = ["background", "polyp", "other"]
PALETTE = [[0, 0, 0], [0, 63, 255], [200, 10, 30]]
# Kvasir-like label sizes, shrunk 10x; the logits are at 40 x 48
LABEL_SIZES = [(53, 62), (40, 48), (107, 135), (61, 50)]
LOGIT_SIZE = (40, 48)


def ragged_batch(seed, ignore_index, dtype=np.float32):
    """``(N, H, W, C)`` logits and a list of labels of other sizes, with
    ignored and out-of-range pixels."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(len(LABEL_SIZES), *LOGIT_SIZE, 3).astype(np.float32)
    # ties between classes: argmax takes the first in both packages
    logits[:, :4, :4, 1] = logits[:, :4, :4, 0]
    if dtype != np.float32:
        logits = logits.astype(dtype)
    labels = []
    for h, w in LABEL_SIZES:
        gt = rng.randint(0, 3, (h, w)).astype(np.float32)
        gt[rng.rand(h, w) < 0.1] = ignore_index
        gt[0, :3] = 5  # out of range: not counted
        labels.append(gt)
    return logits, labels


def kw(ignore_index, **more):
    return dict(epoch=3, num_classes=3, class_names=CLASSES,
                palette=PALETTE, ignore_index=ignore_index, **more)


def to_port(logits_nhwc):
    """NHWC numpy (float32 or ml_dtypes bf16) -> NCHW torch."""
    arr = np.transpose(logits_nhwc, (0, 3, 1, 2))
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(
            arr.astype(np.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_logits_matches_jax_bits(dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    logits, labels = ragged_batch(0, 255, np_dtype)
    port = to_port(logits)
    for i, gt in enumerate(labels):
        if gt.shape == LOGIT_SIZE:
            continue
        for align_corners in (False, True):
            ref = jmetrics.resize_logits_np(logits[i], gt.shape,
                                            align_corners)
            out = metrics.resize_logits(port[i], gt.shape, align_corners)
            assert ref.dtype == np.float32 and out.dtype == torch.float32
            np.testing.assert_array_equal(
                np.transpose(out.numpy(), (1, 2, 0)), ref)


def assert_same_results(port, ref):
    assert sorted(port.results) == sorted(ref.results)
    for head, sums in ref.results.items():
        for k in range(4):
            np.testing.assert_array_equal(port.results[head][k], sums[k],
                                          err_msg=f"{head}[{k}]")
    port_metrics, ref_metrics = port.compute_metrics(), ref.compute_metrics()
    for head, values in ref_metrics.items():
        for key in ("mIoU", "mDice", "mFscore", "aAcc", "IoU", "Fscore"):
            np.testing.assert_array_equal(port_metrics[head][key],
                                          values[key], err_msg=key)


@pytest.mark.parametrize("as_list", [False, True], ids=["batch", "list"])
@pytest.mark.parametrize("ignore_index", [-1, 255])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_counts_match_jax(dtype, ignore_index, as_list):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    ref = jmetrics.SegEvaluator(**kw(ignore_index, show_result=False))
    port = metrics.SegEvaluator(**kw(ignore_index, show_result=False))
    before = dict(confusion.launches)
    for batch_idx, seed in enumerate((1, 2)):
        logits, labels = ragged_batch(seed, ignore_index, np_dtype)
        aux = logits[..., ::-1].copy()
        if as_list:
            jvalue = [jnp.asarray(logits[i][None]) for i in range(4)]
            pvalue = list(to_port(logits)[:, None])
        else:
            jvalue, pvalue = jnp.asarray(logits), to_port(logits)
        ref.process(batch_idx, {"decode": jvalue, "aux": {0: jnp.asarray(
            aux)}}, {"ori_gt": labels})
        port.process(batch_idx, {"decode": pvalue, "aux": {0: to_port(aux)}},
                     {"ori_gt": labels})
    assert confusion.launches == before  # the CPU runs the plain version
    assert sorted(port.results) == ["aux_0", "decode"]
    assert_same_results(port, ref)


def test_ragged_path_counts_each_image_through_the_labels_entry(monkeypatch):
    """One call of K2's wrapper per image and head; the uniform path one
    call of K1's per head."""
    calls = {"logits": 0, "labels": 0}
    for entry, name in (("logits", "confusion_histograms"),
                        ("labels", "confusion_histograms_from_labels")):
        wrapped = getattr(metrics, name)

        def counted(*args, _entry=entry, _fn=wrapped, **kwargs):
            calls[_entry] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(metrics, name, counted)
    evaluator = metrics.SegEvaluator(**kw(255, show_result=False))
    logits, labels = ragged_batch(3, 255)
    evaluator.process(0, {"decode": to_port(logits)}, {"ori_gt": labels})
    assert calls == {"logits": 0, "labels": 4}
    evaluator.process(1, {"decode": to_port(logits)[:, :, :40, :48]},
                      {"ori_gt": np.zeros((4, 40, 48), np.float32)})
    assert calls == {"logits": 1, "labels": 4}


def capture_jax_canvases(monkeypatch):
    captured = {}

    def fake_imwrite(img, path, *args, **kwargs):
        captured[path.rsplit("/", 1)[1]] = np.array(img)
        return True
    monkeypatch.setattr(jmetrics, "imwrite", fake_imwrite)
    return captured


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_collage_matches_jax_canvas(tmp_path, monkeypatch, ragged):
    captured = capture_jax_canvases(monkeypatch)
    ref = jmetrics.SegEvaluator(**kw(255, output_dir=str(tmp_path / "j")))
    port = metrics.SegEvaluator(**kw(255, output_dir=str(tmp_path / "p")))
    logits, labels = ragged_batch(4, 255)
    if not ragged:
        labels = np.stack([l[:40, :48] for l in labels[1:2] * 4])
    for batch_idx in (0, 4):  # collages for the first 4 batches only
        ref.process(batch_idx, {"decode": jnp.asarray(logits)},
                    {"ori_gt": labels})
        port.process(batch_idx, {"decode": to_port(logits)},
                     {"ori_gt": labels})
    assert sorted(captured) == ["pred_epoch_3_batch_0_decode.jpg"]
    written = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert written == ["pred_epoch_3_batch_0_decode.png"]
    canvas = np.array(Image.open(tmp_path / "p" / written[0]))
    bgr = captured["pred_epoch_3_batch_0_decode.jpg"]
    assert canvas.shape == bgr.shape and canvas.shape[1] == 1920
    np.testing.assert_array_equal(canvas[..., ::-1], bgr)


@pytest.mark.parametrize("palette", [True, False], ids=["P", "I"])
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_saved_predictions_match_jax_pngs(tmp_path, palette, ragged):
    def evaluator_kw(directory):
        return dict(epoch=0, num_classes=3, class_names=CLASSES,
                    palette=PALETTE if palette else None,
                    show_result=False, save_pred_dir=directory)

    logits, labels = ragged_batch(5, 255)
    if ragged:  # per-image logits: each taken to its label's size
        jvalue = [jnp.asarray(logits[i][None]) for i in range(4)]
        pvalue = list(to_port(logits)[:, None])
    else:
        labels = np.stack([l[:40, :48] for l in labels[1:2] * 4])
        jvalue, pvalue = jnp.asarray(logits), to_port(logits)
    infos = {"ori_gt": labels,
             "img_file_path": [f"dir/img_{i}.jpg" for i in range(4)]}
    jmetrics.SegEvaluator(**evaluator_kw(str(tmp_path / "j"))).process(
        0, {"decode": jvalue}, infos)
    metrics.SegEvaluator(**evaluator_kw(str(tmp_path / "p"))).process(
        0, {"decode": pvalue}, infos)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == [f"img_{i}.png" for i in range(4)]
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == names
    for name in names:
        with Image.open(tmp_path / "j" / name) as ref, \
                Image.open(tmp_path / "p" / name) as out:
            assert out.mode == ref.mode == ("P" if palette else "I;16")
            assert out.size == ref.size
            np.testing.assert_array_equal(np.array(out), np.array(ref))
            assert out.getpalette() == ref.getpalette()


def test_imwrite_png_decodes_with_pillow(tmp_path):
    rng = np.random.RandomState(0)
    bgr = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    imwrite(bgr, tmp_path / "rgb.png")
    with Image.open(tmp_path / "rgb.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.array(im), bgr[..., ::-1])
    gray = rng.randint(-5, 70000, (9, 11)).astype(np.int64)
    imwrite(gray, tmp_path / "sub" / "gray.png")
    with Image.open(tmp_path / "sub" / "gray.png") as im:
        np.testing.assert_array_equal(np.array(im), np.clip(gray, 0, 65535))
    with pytest.raises(ValueError, match="PNG only"):
        imwrite(bgr, tmp_path / "x.jpg")
