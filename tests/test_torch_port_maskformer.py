"""The mask-classification slice (MaskFormer, Mask2Former) against the JAX
package, on the CPU.

Single modules (``GroupNorm``, the FPN ``PixelDecoder`` with its levels,
``CrossAttention`` with a blocked map that blocks one row fully, the DETR
layer and the Mask2Former layer with and without a blocked map) at widths
8-32 on maps of at most 16², in one compiled JAX program, and
``point_sample`` (bilinear and nearest, points inside and outside the map)
forward and ``jax.vjp``: rtol 1e-4 / atol 1e-5.  ``_attn_blocked``: the
same map.  The auction on seeded ``(T, Q)`` costs with invalid rows and
ties: the JAX assignment, and a cost within ``T · eps`` of scipy's
``linear_sum_assignment``.  ``panoptic_from_probs`` and
``instance_results``' post-processing: the integer outputs exactly.

The tiny slice (the configs cut to a depth-18 ResNetV1c of stage widths
8-64, width 32, 8 queries, 2 decoder layers, 128² images): whole inference
at the slice tolerance rtol 1e-3 / atol 3e-3; one SGD step (the kvasir
optimizer) on the dense path (``num_points=0``) and on the point path
(``num_points=64``, the JAX draws recomputed from its key path and
injected): the loss dict at 1e-5, every parameter after the update at rtol
1e-4 / atol 1e-5, and every gradient at rtol 1e-4 / atol 1e-5 of its
tensor's largest value (elementwise, the gradients of these tiny train-mode
ResNets sit beyond that bound even between the JAX package's own optimised
and unoptimised compiles).  The default run holds the tiny Mask2Former's
whole inference and point-sampled step (its config's train path); the
slow mark adds MaskFormer's whole inference and both its steps,
Mask2Former's dense step and the bf16 checks (about 40 s of JAX compiles).
The kvasir SGD's divergence at full head width (slow): the port's and the
JAX package's losses step for step from the same weights.
The bridge maps the three full-width configs strictly, both ways, on shapes
alone (``jax.eval_shape`` against a port model on the ``meta`` device);
MaskFormer-R50 and Mask2Former-Swin-T are marked slow (3-5 s of tracing
each), their modules are Mask2Former-R50's and UPerNet-Swin-T's.
"""

import contextlib
import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as flax_nn  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402
from torch_port_helpers import (assert_argmax_parity, bridge,  # noqa: E402
                                compile_quickly, init_jax, to_nchw, to_nhwc)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.core.initialize.checkpoint import (  # noqa: E402,E501
    load_state_dict, state_dict_from_variables)
from image_segmentation_lab_tpu.core.mixed_precision import \
    policy as jpolicy  # noqa: E402
from image_segmentation_lab_tpu.models.basic import \
    normalization as jnorm  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import (  # noqa: E402
    mask2former_head as jm2f, maskformer_head as jmf)
from image_segmentation_lab_tpu.ops.matching import \
    auction_assignment as jauction  # noqa: E402
from image_segmentation_lab_tpu.ops.point_sample import \
    calculate_uncertainty as jcalculate_uncertainty  # noqa: E402
from image_segmentation_lab_tpu.ops.point_sample import \
    point_sample as jpoint_sample  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_name, jax_state_dict, layout_maps, mapped_state_dict)
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.initialize import \
    init_weights  # noqa: E402
from image_segmentation_lab_tpu_torch.core.mixed_precision import \
    policy_scope  # noqa: E402
from image_segmentation_lab_tpu_torch.core.registry_hub import \
    DECODEHEAD  # noqa: E402
from image_segmentation_lab_tpu_torch.models.basic import \
    GroupNorm  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import (  # noqa: E402,E501
    mask2former_head as m2f, maskformer_head as mf)
from image_segmentation_lab_tpu_torch.ops.matching import \
    auction_assignment  # noqa: E402
from image_segmentation_lab_tpu_torch.ops.point_sample import (  # noqa: E402
    calculate_uncertainty, point_sample)

TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_SHARE, ARGMAX_AGREE, GRAD_SHARE = 2.0 ** -4, 0.98, 0.25
SCHEDULE = load_python_config("configs/schedule/kvasir_training_schedule.py")
IGNORE = 255


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------- modules
def blocked_map(n, lq, lk, seed=3):
    """A seeded (n, lq, lk) blocked map; query 1 of image 0 blocks every
    key (the fallback to full attention)."""
    b = np.random.RandomState(seed).rand(n, lq, lk) < 0.6
    b[0, 1] = True
    return b


GN_ARGS = dict(num_groups=4, num_channels=16)
PIXEL = ([8, 16, 24, 32], 16, 24)
LAYER = (16, 2, 32)
# name: (JAX module, port module, inputs: NHWC maps, or token arrays)
MODULES = {
    "gn": (lambda: jnorm.GroupNorm(**GN_ARGS),
           lambda: GroupNorm(**GN_ARGS), rand(2, 6, 7, 16)),
    "pixel_decoder": (
        lambda: jmf.PixelDecoder(*PIXEL, norm_cfg=dict(type="GN",
                                                       num_groups=8)),
        lambda: mf.PixelDecoder(*PIXEL, norm_cfg=dict(type="GN",
                                                      num_groups=8)),
        [rand(2, 16, 16, 8, seed=1), rand(2, 8, 8, 16, seed=2),
         rand(2, 4, 4, 24, seed=3), rand(2, 3, 3, 32, seed=4)]),
    "cross_attn": (lambda: jmf.CrossAttention(16, 2),
                   lambda: mf.CrossAttention(16, 2),
                   (rand(2, 5, 16, seed=1), rand(2, 12, 16, seed=2),
                    rand(2, 12, 16, seed=3), blocked_map(2, 5, 12))),
    "detr_layer": (lambda: jmf.DETRDecoderLayer(*LAYER),
                   lambda: mf.DETRDecoderLayer(*LAYER),
                   (rand(2, 5, 16, seed=1), rand(2, 12, 16, seed=2),
                    rand(1, 5, 16, seed=3), rand(1, 12, 16, seed=4))),
    "m2f_layer": (lambda: jm2f.Mask2FormerDecoderLayer(*LAYER),
                  lambda: m2f.Mask2FormerDecoderLayer(*LAYER),
                  (rand(2, 5, 16, seed=1), rand(2, 12, 16, seed=2),
                   rand(1, 5, 16, seed=3), rand(1, 12, 16, seed=4),
                   blocked_map(2, 5, 12))),
    "m2f_layer_open": (lambda: jm2f.Mask2FormerDecoderLayer(*LAYER),
                       lambda: m2f.Mask2FormerDecoderLayer(*LAYER),
                       (rand(2, 5, 16, seed=1), rand(2, 12, 16, seed=2),
                        rand(1, 5, 16, seed=3), rand(1, 12, 16, seed=4),
                        None)),
}


class Bundle(flax_nn.Module):
    """Every JAX module of ``MODULES`` as a submodule of its name: one
    variable tree and one compiled program for all of them."""

    @flax_nn.compact
    def __call__(self, inputs):
        out = {}
        for name, x in inputs.items():
            module = MODULES[name][0]().clone(parent=self, name=name)
            if name == "pixel_decoder":
                out[name] = module(x, return_multi_scale=True)
            elif name == "cross_attn":
                out[name] = module(*x[:3], blocked=x[3])
            elif isinstance(x, tuple):
                out[name] = module(*x)
            else:
                out[name] = module(x)
        return out


def jax_inputs(name):
    x = MODULES[name][2]
    if isinstance(x, tuple):
        return tuple(None if a is None else jnp.asarray(a) for a in x)
    return x


@pytest.fixture(scope="module")
def references():
    """The JAX outputs of every module, and the variables."""
    inputs = {name: jax_inputs(name) for name in MODULES}
    bundle = Bundle()
    variables = init_jax(bundle, inputs)
    fn = compile_quickly(jax.jit(bundle.apply), variables, inputs)
    return variables, jax.device_get(fn(variables, inputs))


def port_inputs(name):
    x = MODULES[name][2]
    if isinstance(x, list):
        return [to_nchw(t) for t in x]
    if isinstance(x, tuple):
        return [None if a is None else torch.from_numpy(a) for a in x]
    return to_nchw(x)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, references):
    variables, outputs = references
    port = MODULES[name][1]()
    bridge(port, {col: tree[name] for col, tree in variables.items()
                  if name in tree})
    x = port_inputs(name)
    with torch.no_grad():
        if name == "pixel_decoder":
            mask_feature, levels = port(x, return_multi_scale=True)
            outs = [to_nhwc(mask_feature)] + [to_nhwc(t) for t in levels]
            ref = outputs[name]
            refs = [ref[0], *ref[1]]
            assert [o.shape[1:3] for o in outs] == [
                (16, 16), (3, 3), (4, 4), (8, 8), (16, 16)]
        elif isinstance(x, list):
            outs, refs = [port(*x).numpy()], [outputs[name]]
        else:
            outs, refs = [to_nhwc(port(x))], [outputs[name]]
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_attn_blocked_matches_jax():
    """The blocked map from the mask embeddings and the level-resized mask
    features, at threshold 0.5."""
    emb, feat = rand(2, 6, 8, seed=1), rand(2, 5, 7, 8, seed=2)
    ref = jm2f.Mask2FormerHead._attn_blocked(
        types.SimpleNamespace(mask_attn_threshold=0.5), jnp.asarray(emb),
        jnp.asarray(feat))
    head = m2f.Mask2FormerHead(in_channels=[8, 8, 8, 8], channels=8,
                               in_index=(0, 1, 2, 3),
                               input_transform="multiple_select",
                               num_classes=2, num_queries=6,
                               num_decoder_layers=1, num_heads=2,
                               feedforward_channels=16, dropout_ratio=0.0)
    got = head._attn_blocked(torch.from_numpy(emb), to_nchw(feat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode,align_corners", [("bilinear", False),
                                                ("bilinear", True),
                                                ("nearest", False)])
def test_point_sample_and_its_gradient_match_jax(mode, align_corners):
    """Points over [-0.1, 1.1]² (some corners off the map), 3 channels; the
    gradient with respect to the map by ``jax.vjp``."""
    feat = rand(2, 9, 11, 3, seed=4)
    pts = np.random.RandomState(5).uniform(-0.1, 1.1, (2, 40, 2)).astype(
        np.float32)
    cot = rand(2, 40, 3, seed=6)
    fn = functools.partial(jpoint_sample, align_corners=align_corners,
                           mode=mode)

    def forward_and_vjp(f, p, c):
        out, vjp = jax.vjp(lambda f: fn(f, p), f)
        return out, vjp(c)[0]

    out, ref_grad = compile_quickly(jax.jit(forward_and_vjp), feat, pts,
                                    cot)(feat, pts, cot)
    x = to_nchw(feat).requires_grad_(True)
    with torch.enable_grad():
        got = point_sample(x, torch.from_numpy(pts),
                           align_corners=align_corners, mode=mode)
        (got * torch.from_numpy(cot).transpose(1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().transpose(1, 2).numpy(),
                               np.asarray(out), **TOL)
    np.testing.assert_allclose(to_nhwc(x.grad), np.asarray(ref_grad), **TOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_calculate_uncertainty_matches_jax(channels):
    logits = rand(2, 5, 7, channels, seed=8)
    ref = jcalculate_uncertainty(jnp.asarray(logits))
    got = calculate_uncertainty(to_nchw(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_auction_matches_jax_and_scipy():
    """Batched over 6 seeded (T, Q) problems with invalid rows: the JAX
    assignment row for row, and on the valid rows a total cost within T ·
    eps of the optimum."""
    rng = np.random.RandomState(0)
    B, T, Q, eps = 6, 5, 12, 1e-4
    cost = rng.rand(B, T, Q).astype(np.float32)
    cost[3] = np.round(cost[3] * 4) / 4  # ties: first column, first row
    valid = rng.rand(B, T) < 0.75
    valid[0] = True
    col, owner = auction_assignment(torch.from_numpy(cost),
                                    torch.from_numpy(valid), eps=eps)
    # each problem's own JAX loop: a batched while_loop holds a finished
    # problem's state
    ref_col, ref_owner = jax.jit(jax.vmap(functools.partial(
        jauction, eps=eps)))(cost, valid)
    for b in range(B):
        np.testing.assert_array_equal(col[b].numpy(), np.asarray(ref_col[b]))
        np.testing.assert_array_equal(owner[b].numpy(),
                                      np.asarray(ref_owner[b]))
        rows = np.nonzero(valid[b])[0]
        r, c = linear_sum_assignment(cost[b][rows])
        got = cost[b][rows, col[b].numpy()[rows]].sum()
        assert got <= cost[b][rows][r, c].sum() + T * eps
        assert len(set(col[b].numpy()[rows])) == len(rows)


def test_panoptic_from_probs_matches_jax():
    """Query competition on seeded probabilities, thresholds that keep and
    drop queries: the integer outputs exactly."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 6, 4).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask_probs = rng.rand(2, 6, 9, 10).astype(np.float32)
    jitted = jax.jit(jmf.panoptic_from_probs)  # thresholds traced: 1 compile
    for omt, ot in ((0.3, 0.5), (0.5, 0.2), (0.9, 0.8)):
        ref = jitted(probs, mask_probs, omt, ot)
        got = mf.panoptic_from_probs(torch.from_numpy(probs),
                                     torch.from_numpy(mask_probs), omt, ot)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("score_threshold", [0.0, 0.4])
def test_instance_results_match_jax(score_threshold):
    """Labels, gated scores and binary masks from the same query logits."""
    rng = np.random.RandomState(7)
    cls = rng.randn(2, 6, 4).astype(np.float32) * 2
    masks = rng.randn(2, 6, 9, 10).astype(np.float32) * 3
    jself = types.SimpleNamespace(
        num_classes=3, _forward_all=lambda inputs, train: (
            [jnp.asarray(cls)], [jnp.asarray(masks)]))
    ref = jmf.MaskFormerHead.instance_results(jself, None, score_threshold)
    pself = types.SimpleNamespace(num_classes=3, query_probs=lambda inputs: (
        torch.softmax(torch.from_numpy(cls), -1),
        torch.sigmoid(torch.from_numpy(masks))))
    got = mf.MaskFormerHead.instance_results(pself, None, score_threshold)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ------------------------------------------------------------- the slice
SIZE = 128
NUM_POINTS = 64


def tiny_cfg(head, num_points=0, num_decoder_layers=2):
    """``configs/network/maskformer/{head}``'s arrangement cut to a
    depth-18 ResNetV1c of stage widths 8-64, width 32 and 8 queries over 2
    decoder layers (Mask2Former: 3 predictions, masked attention at two
    levels)."""
    network = load_python_config(f"configs/network/maskformer/{head}.py")[
        "model"]
    network["backbone"].update(depth=18, stem_channels=8, base_channels=8)
    network["decode_head"].update(
        in_channels=[8, 16, 32, 64], channels=32, feat_channels=32,
        num_queries=8, num_decoder_layers=num_decoder_layers, num_heads=4,
        feedforward_channels=64)
    if "num_points" in network["decode_head"]:
        network["decode_head"]["num_points"] = num_points
    elif num_points:
        network["decode_head"].update(num_points=num_points)
    return network


CASES = {  # name: network
    "mask2former": tiny_cfg("mask2former_r50"),
    "maskformer": tiny_cfg("maskformer_r50"),
    "mask2former_points": tiny_cfg("mask2former_r50", NUM_POINTS),
    "maskformer_points": tiny_cfg("maskformer_r50", NUM_POINTS),
}


def batch(seed, n=2, size=SIZE):
    """Seeded images and labels of blobs of class 1 (every image holds
    both classes) with 10 % ignored pixels."""
    rng = np.random.RandomState(seed)
    img = rng.randn(n, size, size, 3).astype(np.float32)
    yy, xx = np.mgrid[:size, :size]
    gt = np.zeros((n, size, size), np.int32)
    for i in range(n):
        cy, cx = rng.randint(size // 4, 3 * size // 4, 2)
        r = rng.randint(size // 8, size // 4)
        gt[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    gt[rng.rand(n, size, size) < 0.1] = IGNORE
    return img, gt


def capturing(tx):
    """``tx`` whose state also holds the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def jax_points(base_key, num_predictions, n, num_classes, num_points):
    """The JAX head's point draws, recomputed from its key path: per
    prediction ``fold_in(base_key, li)`` split per image, each image's key
    split into ``k_os, k_rand``; stacked as the port's ``_point_draws``
    returns them, ``(L, N, K, n, 2)``."""
    n_os = int(num_points * 3.0)
    n_rand = num_points - int(num_points * 0.75)

    @jax.jit  # one program instead of an eager compile per operation
    def draws(base_key):
        os_pts, rand_pts = [], []
        for li in range(num_predictions):
            keys = jax.random.split(jax.random.fold_in(base_key, li), n)
            per_image = [jax.random.split(k, 2) for k in keys]
            os_pts.append(jnp.stack([
                jax.random.uniform(k[0], (num_classes, n_os, 2))
                for k in per_image]))
            rand_pts.append(jnp.stack([
                jax.random.uniform(k[1], (num_classes, n_rand, 2))
                for k in per_image]))
        return jnp.stack(os_pts), jnp.stack(rand_pts)

    return tuple(torch.from_numpy(np.array(a)) for a in draws(base_key))


# batches on which no ReLU input or blocked-map logit sits within float32
# rounding of its kink: a flipped branch moves the gradients upstream of
# it by up to 3 % of their largest value while the loss stays within 1e-6
# (the flagship's card agreement replays branches for the same reason).
# Batch 10 puts a pixel-decoder ReLU input at 4e-8 of its scale: the
# tiny MaskFormer's pixel-decoder gradients then sit 0.4 % of their largest
# value from JAX's, while the port's float32 and float64 steps agree to
# 1.3e-5; batch 11 does the same to a blocked-map logit of Mask2Former
STEP_SEED = {"mask2former": 9, "maskformer": 12,
             "mask2former_points": 9, "maskformer_points": 12}


# The JAX package's focal cost and loss under jit lose the 1e-12 guard of
# log(1 - p + 1e-12) (XLA folds it away): at mask logits of 17 and above
# they return inf, and the auction then leaves a valid target unmatched.
# MaskFormer (focal) cases halve the mask embedding's last layer, which
# keeps their logits below 10, where the jitted focal terms are exact.
FOCAL_MASK_EMBED_SCALE = 0.5


class TinyCases(dict):
    """Per case the JAX module and variables, made when first asked for
    (the point cases share their dense case's weights)."""

    def __missing__(self, name):
        jm = jax_build(CASES[name])
        base = name.replace("_points", "")
        if base != name:
            self[name] = (jm, self[base][1])
            return self[name]
        variables = jax.tree_util.tree_map(np.asarray, init_jax(
            jm, jnp.zeros((1, SIZE, SIZE, 3)),
            jnp.zeros((1, SIZE, SIZE), jnp.int32), method="forward_train",
            train=False))
        if base == "maskformer":
            embed = variables["params"]["decode_head"]["mask_embed2"]
            embed["weight"] = embed["weight"] * FOCAL_MASK_EMBED_SCALE
        self[name] = (jm, variables)
        return self[name]


@pytest.fixture(scope="module")
def tiny():
    return TinyCases()


def head_key(jm, variables, rng):
    """The key the JAX head's first ``make_rng('dropout')`` returns in a
    train step given ``rng``."""
    return jm.apply(variables, rngs={"dropout": rng},
                    method=lambda m: m.decode_head_module.make_rng(
                        "dropout"))


BF16_SEED = 4


def bf16_loss(jm, variables, img, gt):
    """Train-mode ``forward_train`` under the bf16 policy: the loss and the
    decode logits as a function of the parameters."""
    def loss_fn(params):
        with jpolicy.policy_scope("bf16"):
            (logits, losses), _ = jm.apply(
                {**variables, "params": params}, img, gt,
                method="forward_train", train=True,
                mutable=["batch_stats"])
            return jtrain.parse_losses(losses)[0], logits["decode"]
    return loss_fn


def pyramid(seed=6):
    """A seeded float32 backbone pyramid of the tiny ResNetV1c at SIZE²
    (NHWC)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(2, SIZE // s, SIZE // s, c).astype(np.float32)
            for s, c in ((4, 8), (8, 16), (16, 32), (32, 64))]


def port_head_step(head, feats, gt, record=None):
    """The head's ``forward_train`` on the pyramid ``feats`` and its
    backward under the bf16 policy (autocast, as ``EncoderDecoder`` enters
    it): the loss and the head's gradients under their JAX names; with
    ``record`` a list, the blocked maps in call order are appended."""
    head.zero_grad(set_to_none=True)
    original = m2f.Mask2FormerHead._attn_blocked

    def recorded(self, emb, feat):
        out = original(self, emb, feat)
        if record is not None:
            record.append(out.numpy())
        return out

    with mock.patch.object(m2f.Mask2FormerHead, "_attn_blocked", recorded), \
            torch.enable_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        _, losses = head.forward_train([to_nchw(f) for f in feats],
                                       torch.from_numpy(gt).long())
        loss, _ = train_state.parse_losses(losses)
        loss.backward()
    return float(loss.detach()), port_grads(head)


# the JAX references in two compiled programs: the main path's (the tiny
# Mask2Former's whole inference and its point-sampled step, as its config
# trains), and the rest (MaskFormer's whole inference and its dense and
# point steps, Mask2Former's dense step, the bf16 checks), which the slow
# mark keeps out of the default run for their compile time (about 40 s)
CORE = ("mask2former_points",)
EXTRA = ("mask2former", "maskformer", "maskformer_points", "bf16")


def jax_program(tiny, names):
    """``names``' JAX references in one compiled program: whole inference
    of both tiny models with the core steps; one SGD step of each case
    (the log, the variables after it, the gradients)."""
    tx = capturing(jbuild_optimizer(SCHEDULE["optimizer"]))
    x = rand(2, SIZE, SIZE, 3, seed=3)

    whole = ("mask2former",) if names == CORE else ("maskformer",)

    def run(all_vars):
        out = {}
        for name in whole:
            jm, _ = tiny[name]
            out[f"{name}_whole"] = jm.apply(all_vars[name], x,
                                            method="whole_inference",
                                            rescale=False)
        for name in names:
            if name == "bf16":
                continue
            jm, _ = tiny[name]
            variables = all_vars[name]
            params = variables["params"]
            state = jtrain.TrainState(
                step=jnp.zeros((), jnp.int32), params=params,
                frozen_params={}, batch_stats=variables["batch_stats"],
                opt_state=tx.init(params))
            img, gt = batch(STEP_SEED[name])
            state, log = jtrain.make_train_step(jm, tx, donate=False)(
                state, img, gt, jax.random.PRNGKey(STEP_SEED[name]))
            out[name] = (log, state.variables(), state.opt_state[1])
        if "bf16" in names:
            jm, variables = tiny["mask2former"]
            img, gt = batch(BF16_SEED)
            out["bf16"] = bf16_loss(jm, variables, img, gt)(
                all_vars["mask2former"]["params"])
            # the head alone on one float32 pyramid, on the port's blocked
            # maps: a bf16 mask logit within rounding of 0 blocks a key in
            # one package and not in the other
            maps = iter(port_bf16_blocked_maps(tiny))

            def head_loss(params):
                with jpolicy.policy_scope("bf16"):
                    (_, losses), _ = jm.apply(
                        {**variables, "params": params}, pyramid(),
                        gt, method=lambda m, f, g:
                        m.decode_head_module.forward_train(f, g, train=True),
                        mutable=["batch_stats"])
                    return jtrain.parse_losses(losses)[0]

            with mock.patch.object(jm2f.Mask2FormerHead, "_attn_blocked",
                                   lambda self, emb, feat: jnp.asarray(
                                       next(maps))):
                out["bf16_head"] = jax.value_and_grad(head_loss)(
                    all_vars["mask2former"]["params"])
        return out

    needed = {*whole, *names} - {"bf16"}
    if "bf16" in names:
        needed.add("mask2former")
    all_vars = {name: tiny[name][1] for name in sorted(needed)}
    return jax.device_get(compile_quickly(jax.jit(run), all_vars)(all_vars))


def port_bf16_blocked_maps(tiny):
    """The blocked maps of the port head's bf16 step on ``pyramid()``, in
    call order."""
    maps = []
    model = bridge(build_segmentor(CASES["mask2former"]),
                   tiny["mask2former"][1]).train()
    port_head_step(model.decode_head, pyramid(), batch(BF16_SEED)[1],
                   record=maps)
    return maps


@pytest.fixture(scope="module")
def jax_runs(tiny):
    return jax_program(tiny, CORE)


@pytest.fixture(scope="module")
def jax_extra_runs(tiny):
    return jax_program(tiny, EXTRA)


def references_of(name, request):
    fixture = "jax_runs" if name in CORE else "jax_extra_runs"
    return request.getfixturevalue(fixture)


@pytest.mark.parametrize("name", [
    "mask2former", pytest.param("maskformer", marks=pytest.mark.slow)])
def test_tiny_whole_inference_matches_jax(name, tiny, request):
    jm, variables = tiny[name]
    ref = references_of("mask2former_points" if name == "mask2former"
                        else name, request)[f"{name}_whole"]
    pm = bridge(build_segmentor(CASES[name]), variables)
    with torch.no_grad():
        out = pm.whole_inference(to_nchw(rand(2, SIZE, SIZE, 3, seed=3)),
                                 rescale=False)
    assert out.shape == (2, 2, SIZE, SIZE)
    assert_argmax_parity(np.asarray(ref), to_nhwc(out))


def port_grads(model):
    """The port's gradients under their JAX names, in JAX layouts."""
    layout = layout_maps(model, to_jax=True)
    return {jax_name(name): layout.get(name, np.asarray)(p.grad.numpy())
            for name, p in model.named_parameters()}


def assert_grads_close(grads, ref, key):
    """rtol 1e-4 / atol 1e-5 of the tensor's largest gradient: elementwise,
    these tiny models' float32 gradients sit below the bound even between
    the JAX package's own optimised and unoptimised compiles (5 backbone
    tensors at 128²)."""
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(grads, ref, rtol=0,
                               atol=TOL["rtol"] * scale + TOL["atol"],
                               err_msg=key)


@pytest.mark.parametrize("name", [
    *CORE, *(pytest.param(name, marks=pytest.mark.slow) for name in EXTRA
             if name != "bf16")])
def test_tiny_sgd_step_matches_jax(name, tiny, request):
    """One step from the same weights; on the point path with the JAX
    draws injected (the matching is the JAX auction's, so the same pairs
    are sampled at the same points)."""
    jm, variables = tiny[name]
    jlog, jvars, jgrads = references_of(name, request)[name]
    img, gt = batch(STEP_SEED[name])
    model = bridge(build_segmentor(CASES[name]), variables)
    state = train_state.create_train_state(model, SCHEDULE["optimizer"])
    step = train_state.make_train_step(state.model, state.optimizer)
    head = model.decode_head
    draws = contextlib.nullcontext()
    if head.num_points:
        num_predictions = head.num_decoder_layers + (
            1 if isinstance(head, m2f.Mask2FormerHead) else 0)
        points = jax_points(head_key(jm, variables, jax.random.PRNGKey(
            STEP_SEED[name])), num_predictions, 2, 2, NUM_POINTS)
        draws = mock.patch.object(type(head), "_point_draws",
                                  lambda self, shape, device: points)
    with draws:
        log = step(to_nchw(img), torch.from_numpy(gt).long(),
                   torch.Generator().manual_seed(0))
    assert sorted(log) == sorted(jlog)
    for key, ref in jlog.items():
        np.testing.assert_allclose(float(log[key]), float(ref), err_msg=key,
                                   **LOSS_TOL)
    grads = port_grads(model)
    jgrads = state_dict_from_variables({"params": jgrads})
    assert sorted(grads) == sorted(jgrads)
    for key, ref in jgrads.items():
        assert_grads_close(grads[key], ref, key)
    ref_state = state_dict_from_variables(jvars)
    got = jax_state_dict(model)
    assert sorted(got) == sorted(ref_state)
    for key, ref in ref_state.items():
        np.testing.assert_allclose(got[key], ref, err_msg=key, **TOL)


def test_point_path_draws_only_under_a_generator(tiny):
    """The point path samples inside the train step (its generator); the
    eval step (no generator) takes the dense losses, as the JAX head does
    without a dropout rng."""
    model = bridge(build_segmentor(CASES["mask2former_points"]),
                   tiny["mask2former_points"][1])
    img, gt = batch(1)
    calls = []
    original = m2f.Mask2FormerHead._point_draws

    def counted(self, shape, device):
        calls.append(tuple(shape))
        return original(self, shape, device)

    with mock.patch.object(m2f.Mask2FormerHead, "_point_draws", counted):
        train_state.make_eval_step(model)(to_nchw(img),
                                          torch.from_numpy(gt).long())
        assert calls == []
        state = train_state.create_train_state(model, SCHEDULE["optimizer"])
        log = train_state.make_train_step(state.model, state.optimizer)(
            to_nchw(img), torch.from_numpy(gt).long(),
            torch.Generator().manual_seed(0))
    assert calls == [(3, 2, 2)] and np.isfinite(float(log["loss"]))


# gradients that are 0 in exact arithmetic (softmax ignores a shift of a
# row's scores, which is all a key bias adds): bf16 rounding residue in
# either package, held to one bf16 rounding step of the largest gradient
EXACT_ZERO = ("k_proj.bias",)


@pytest.mark.slow
def test_tiny_mask2former_bf16_forward_and_step_match_jax(tiny,
                                                          jax_extra_runs):
    """The bf16 policy, from the same weights, at the amp gates of
    ``PERF.md`` §2.  The whole model's train-mode ``forward_train``: the
    logits within 2**-4 of their largest value or twice the port's
    float32 logits' distance from JAX's bf16 ones (as the flagship's test
    holds its ResNet: bf16 rounding in a train-mode ResNet moves the
    pyramid by about 5 % of its scale in either package, and the decoder
    carries it), the same hard prediction at 98 % of the pixels, the loss
    at rtol 1e-2.  The gradients on one float32 pyramid fed to the head
    alone (the whole model's bf16 gradients are that ResNet noise, as the
    flagship's test finds): each within 0.25 relative norm of JAX's."""
    jm, variables = tiny["mask2former"]
    img, gt = batch(BF16_SEED)
    jloss, ref = jax_extra_runs["bf16"]
    ref = np.asarray(ref, np.float32)
    model = bridge(build_segmentor(CASES["mask2former"]), variables).train()
    outs = {}
    for policy in ("bf16", "fp32"):
        with torch.no_grad(), policy_scope(policy):
            logits, losses = model.forward_train(
                to_nchw(img), torch.from_numpy(gt).long())
        outs[policy] = (to_nhwc(logits["decode"].float()),
                        float(train_state.parse_losses(losses)[0]))
    (out, loss), (out32, _) = outs["bf16"], outs["fp32"]
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= max(
        LOGIT_SHARE * scale, 2 * np.abs(out32 - ref).max())
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= ARGMAX_AGREE
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-2)

    jloss, jgrads = jax_extra_runs["bf16_head"]
    jgrads = state_dict_from_variables({"params": jgrads})
    jgrads = {k: v for k, v in jgrads.items() if k.startswith("decode_head")}
    head = bridge(build_segmentor(CASES["mask2former"]), variables).train()
    loss, grads = port_head_step(head.decode_head, pyramid(), gt)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-2)
    grads = {f"decode_head.{k}": v for k, v in grads.items()}
    assert sorted(grads) == sorted(jgrads)
    largest = max(np.abs(g).max() for g in jgrads.values())
    for key, r in jgrads.items():
        if key.endswith(EXACT_ZERO):
            assert np.abs(grads[key]).max() <= 2.0 ** -8 * largest, key
            continue
        dist = np.linalg.norm(grads[key] - r) / np.linalg.norm(r)
        assert dist <= GRAD_SHARE, (key, dist)


def test_init_has_the_jax_head_distributions():
    """The head's linears, mask-feature conv and query tables truncated
    normal (std 0.02) with zero biases, GroupNorm unit/zero."""
    model = build_segmentor(tiny_cfg("mask2former_r50"))
    init_weights(model, torch.Generator().manual_seed(0))
    head = model.decode_head
    for t in (head.query_embed, head.query_feat, head.level_embed,
              head.layer0.cross_attn.q_proj.weight, head.cls_embed.weight,
              head.pixel_decoder.mask_feature.weight):
        assert 0.015 < float(t.std()) < 0.025 and float(t.abs().max()) < 0.1
    assert not head.cls_embed.bias.any() and not head.layer1.ffn_fc2.bias.any()
    gn = head.pixel_decoder.lateral0.gn
    assert bool((gn.weight == 1).all()) and not gn.bias.any()
    assert DECODEHEAD.get("Mask2FormerHead") is m2f.Mask2FormerHead
    assert DECODEHEAD.get("MaskFormerHead") is mf.MaskFormerHead


# ------------------------------------------------------------- the bridge
FULL_SIZE = ["maskformer/mask2former_r50", "maskformer/maskformer_r50",
             "maskformer/mask2former_swin-t"]


@pytest.mark.parametrize("config", [
    FULL_SIZE[0], *(pytest.param(c, marks=pytest.mark.slow)
                    for c in FULL_SIZE[1:])])
def test_bridge_maps_the_full_size_configs_strictly(config):
    """Every JAX leaf of the full-width config maps to a port tensor of the
    mapped shape and no port tensor is left over, both ways, on shapes
    alone."""
    network = load_python_config(f"configs/network/{config}.py")["model"]
    shapes = jax.eval_shape(lambda: jax_build(network).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        method=lambda m, x: m.decode_head_module(m.extract_feat(x))))
    leaves = state_dict_from_variables(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes))
    with torch.device("meta"):
        model = build_segmentor(network)
    mapped = mapped_state_dict(model, leaves)
    assert len(mapped) == len(leaves)
    assert sum(a.size for a in mapped.values()) > 20_000_000
    to_jax = layout_maps(model, to_jax=True)
    for name, arr in mapped.items():  # and back to the JAX layout
        back = to_jax.get(name, lambda a: a)(arr)
        assert back.shape == leaves[jax_name(name)].shape, name


# ------------------------------------------------ the kvasir SGD's divergence
def mid_width_cfg():
    """``mask2former_r50.py`` with its ResNetV1c-50 at half width (stem and
    base 32: stage widths 128-1024) and the head at full width (256
    channels, 100 queries, 9 layers, FFN 2048, 12544 points)."""
    network = load_python_config(
        "configs/network/maskformer/mask2former_r50.py")["model"]
    network["backbone"].update(stem_channels=32, base_channels=32)
    network["decode_head"].update(in_channels=[128, 256, 512, 1024])
    return network


SGD_STEPS = 4


@pytest.mark.slow
def test_kvasir_sgd_diverges_as_in_the_jax_package():
    """Mask2Former-R50's full-width head under the kvasir schedule's SGD
    (lr 0.01, momentum 0.9) from the port's default init, the same weights
    in both packages, on one batch of 2 x 128² images with the JAX point
    draws injected: the losses agree step for step at rtol 1e-3 while both
    grow more than 10⁴-fold in SGD_STEPS steps (about 86, 138, 1811, 3.8e6;
    nan two steps later).  The divergence is the model's under this
    optimizer, not the port's (about 40 s of JAX compiling)."""
    network = mid_width_cfg()
    model = build_segmentor(network)
    init_weights(model, torch.Generator().manual_seed(0))
    jm = jax_build(network)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, SIZE, SIZE), jnp.int32),
        method="forward_train", train=False))
    variables = jax.tree_util.tree_map(np.asarray, load_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
        jax_state_dict(model), strict=True, logger=None)[0])
    img, gt = batch(STEP_SEED["mask2former_points"])
    tx = jbuild_optimizer(SCHEDULE["optimizer"])
    jstate = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        frozen_params={}, batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    jstep = compile_quickly(jax.jit(jtrain.make_train_step(
        jm, tx, donate=False)), jstate, img, gt, jax.random.PRNGKey(0))
    state = train_state.create_train_state(model, SCHEDULE["optimizer"])
    step = train_state.make_train_step(state.model, state.optimizer)
    head = model.decode_head
    losses, ref = [], []
    for i in range(SGD_STEPS):
        key = jax.random.PRNGKey(i)
        jstate, jlog = jstep(jstate, img, gt, key)
        ref.append(float(jlog["loss"]))
        points = jax_points(head_key(jm, variables, key),
                            head.num_decoder_layers + 1, 2, 2,
                            head.num_points)
        with mock.patch.object(type(head), "_point_draws",
                               lambda self, shape, device: points):
            log = step(to_nchw(img), torch.from_numpy(gt).long(),
                       torch.Generator().manual_seed(0))
        losses.append(float(log["loss"]))
    print(f"kvasir SGD losses: JAX {ref}, port {losses}")
    np.testing.assert_allclose(losses, ref, rtol=1e-3)
    assert ref[-1] > 1e4 * ref[0] and losses[-1] > 1e4 * losses[0]
