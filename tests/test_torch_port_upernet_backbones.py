"""UPerNet's backbone family (Swin, ConvNeXt, BEiT, MAE), the
Feature2Pyramid neck, ``ConvTranspose2d``, ``max_pool2d`` and the bicubic
resize against the JAX package, on the CPU.

Single modules at widths 8-32: rtol 1e-4 / atol 1e-5 (float32 sums in
other orders).  Swin blocks of window 4 on a map that pads (6 x 7), one
that shifts (8 x 8), one that does both (10 x 9) and one below one window
(3 x 3, no shift), ``PatchMerging`` on odd sizes and a two-stage Swin on
36² (9² and 5² maps: padded and shifted); a ConvNeXt block and a
two-stage ConvNeXt; BEiT's attention, a block and two-layer BEiT and MAE
at a grid other than the pretraining one (3 x 3), so that the bias
tables and MAE's position table are resampled bicubically; the neck with
all four rescales; a transposed conv of kernel 3, stride 2, padding 1 and
output padding 1.

One tiny UPerNet on each backbone (the network configs cut to widths of
8-64 and one or two blocks a stage, without drop path and head dropout;
the steps of BEiT's and MAE's run in ``test_torch_port_paramwise.py``,
under their layer-decay schedule, from the helpers here): one float32
step of ``make_train_step`` under the backbone's schedule (Swin and
ConvNeXt: the SegFormer schedule's AdamW), its train-mode logits at the
slice tolerance rtol 1e-3 / atol 3e-3 with the same hard predictions but
at genuine ties, the loss (1e-5), every gradient and every parameter
after the update (rtol 1e-4 / atol 1e-5).  ``check_tiny_bf16_step``
holds a step under the bf16 policy to the amp gates of ``PERF.md`` §2
(BEiT's, with the neck): logits within 2**-4 of the largest |logit| and
98 % equal argmax, the loss at rtol 1e-2 and each gradient within 0.25
relative norm of JAX's bf16 gradient; a gradient that is 0 in exact
arithmetic (a stage output's LayerNorm bias reaching the loss only
through a 1 x 1 conv into a train-mode BatchNorm, which takes out
per-channel constants: the float32 gradient is below 1e-6 of the
largest) is rounding residue in both packages and is held to one bf16
rounding step of the largest gradient instead.  The tiny Swin UPerNet,
eight channels wide, is not held under bf16: there several gradients sit
0.1-0.5 of their norm from the float32 gradient in both packages, beyond
what the gate can tell apart.

The bridge maps the five full-width configs strictly on shapes alone; the
init has the JAX distributions; ``frozen_stages`` and ``with_cp`` raise.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as flax_nn  # noqa: E402
from torch_port_helpers import (assert_argmax_parity, bridge,  # noqa: E402
                                compile_quickly, init_jax, to_nchw, to_nhwc)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import LR_SCHEDULER as JLR  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_from_cfg as jbuild_from_cfg  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.core.initialize.checkpoint import \
    state_dict_from_variables  # noqa: E402
from image_segmentation_lab_tpu.core.mixed_precision import \
    policy as jpolicy  # noqa: E402
from image_segmentation_lab_tpu.models.backbones import (  # noqa: E402
    beit as jbeit, convnext as jconvnext, mae as jmae, swin as jswin)
from image_segmentation_lab_tpu.models.basic import \
    convolution as jconv  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.models.necks import \
    featurepyramid as jneck  # noqa: E402
from image_segmentation_lab_tpu.ops.pooling import \
    max_pool2d as jmax_pool2d  # noqa: E402
from image_segmentation_lab_tpu.utils.ops import \
    resize_bicubic as jresize_bicubic  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_name, jax_state_dict, layout_maps, mapped_state_dict)
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.initialize import \
    init_weights  # noqa: E402
from image_segmentation_lab_tpu_torch.core.mixed_precision import \
    policy_scope  # noqa: E402
from image_segmentation_lab_tpu_torch.core.registry_hub import (  # noqa: E402,E501
    BACKBONE, CONVOLUTION, NECK)
from image_segmentation_lab_tpu_torch.models.backbones import (  # noqa: E402,E501
    beit, convnext, mae, swin)
from image_segmentation_lab_tpu_torch.models.basic import \
    ConvTranspose2d  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.models.necks import \
    Feature2Pyramid  # noqa: E402
from image_segmentation_lab_tpu_torch.ops.pooling import \
    max_pool2d  # noqa: E402
from image_segmentation_lab_tpu_torch.utils.ops import resize  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_SHARE, ARGMAX_AGREE, GRAD_SHARE = 2.0 ** -4, 0.98, 0.25
BN = dict(type="SyncBN", requires_grad=True)
IGNORE = 255


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------- functions
@pytest.mark.parametrize("size,out,align", [((3, 3), (5, 5), False),
                                            ((27, 27), (79, 79), False),
                                            ((14, 14), (40, 32), False),
                                            ((9, 7), (4, 3), False),
                                            ((5, 6), (9, 11), True)])
def test_resize_bicubic_matches_jax(size, out, align):
    """Up (BEiT's 27² table field to 79² at 640²; MAE's 14² position
    table to 40 x 32) and down, in float32 and bf16 (rounded once)."""
    x = rand(2, 3, *size)
    nhwc = np.transpose(x, (0, 2, 3, 1))
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, TOL),
                               (torch.bfloat16, jnp.bfloat16,
                                dict(rtol=2 ** -7, atol=2 ** -7))):
        ref = jresize_bicubic(jnp.asarray(nhwc, jdtype), out,
                              align_corners=align)
        got = resize(torch.from_numpy(x).to(dtype), out, mode="bicubic",
                     align_corners=align, warning=False)
        assert got.dtype == dtype
        np.testing.assert_allclose(to_nhwc(got.float()),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **tol)


def test_resize_bicubic_backward_is_the_transposed_product():
    """The gradient of the two products is ``F.interpolate``'s bicubic
    gradient (its CPU backward, the same weights)."""
    x = torch.randn(2, 3, 6, 7, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 3, 11, 13, dtype=torch.float64)
    with torch.enable_grad():
        (got,) = torch.autograd.grad((resize(x, (11, 13), mode="bicubic",
                                             align_corners=False)
                                      * g).sum(), x)
        (ref,) = torch.autograd.grad((torch.nn.functional.interpolate(
            x, (11, 13), mode="bicubic", align_corners=False) * g).sum(), x)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,s,p,ceil", [(2, 2, 0, False), (4, 4, 0, False),
                                        (3, 2, 1, True), (3, 2, 1, False),
                                        (2, 2, 0, True)])
def test_max_pool2d_matches_jax(k, s, p, ceil):
    x = rand(2, 9, 11, 3)
    ref = jmax_pool2d(jnp.asarray(x), k, s, p, ceil_mode=ceil)
    got = max_pool2d(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))), k, s,
                     p, ceil_mode=ceil)
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(ref))


# ------------------------------------------------------------- modules
SWIN = dict(depths=(2, 2), embed_dims=8, num_heads=(1, 2), window_size=4,
            out_indices=(0, 1))
CONVNEXT = dict(depths=(1, 2), dims=(8, 16), out_indices=(0, 1))
VIT = dict(embed_dims=16, num_layers=2, num_heads=2, patch_size=8,
           pretrain_img_size=24, out_indices=(0, 1))
NECK_ARGS = dict(embed_dim=8, rescales=(4, 2, 1, 0.5), norm_cfg=BN)
DECONV = (8, 6, 3)
DECONV_KW = dict(stride=2, padding=1, output_padding=1)


def swin_block(shift):
    return (lambda: jswin.SwinBlock(16, 2, window_size=4, shift=shift),
            lambda: swin.SwinBlock(16, 2, window_size=4, shift=shift))


# name: (JAX module, port module, input shape (NHWC; a list is the neck's
# maps), the port's input layout: "map" (NCHW), "nhwc" (Swin's
# channels-last maps) or "tokens")
MODULES = {
    "deconv": (lambda: jconv.ConvTranspose2d(*DECONV, **DECONV_KW),
               lambda: ConvTranspose2d(*DECONV, **DECONV_KW),
               (2, 5, 6, 8), "map"),
    "neck": (lambda: jneck.Feature2Pyramid(**NECK_ARGS),
             lambda: Feature2Pyramid(**NECK_ARGS),
             [(2, 6, 6, 8)] * 4, "map"),
    "swin_block_pad": (*swin_block(0), (2, 6, 7, 16), "nhwc"),
    "swin_block_shift": (*swin_block(2), (2, 8, 8, 16), "nhwc"),
    "swin_block_shift_pad": (*swin_block(2), (2, 10, 9, 16), "nhwc"),
    "swin_block_small": (*swin_block(2), (2, 3, 3, 16), "nhwc"),
    "patch_merging": (lambda: jswin.PatchMerging(8),
                      lambda: swin.PatchMerging(8), (2, 5, 7, 8), "nhwc"),
    "swin": (lambda: jswin.SwinTransformer(**SWIN),
             lambda: swin.SwinTransformer(**SWIN), (2, 36, 36, 3), "map"),
    "convnext_block": (lambda: jconvnext.ConvNeXtBlock(16),
                       lambda: convnext.ConvNeXtBlock(16), (2, 9, 9, 16),
                       "map"),
    "convnext": (lambda: jconvnext.ConvNeXt(**CONVNEXT),
                 lambda: convnext.ConvNeXt(**CONVNEXT), (2, 32, 32, 3),
                 "map"),
    "beit_attn": (lambda: jbeit.BEiTAttention(16, 2, 3),
                  lambda: beit.BEiTAttention(16, 2, 3), (2, 17, 16),
                  "tokens"),
    "beit_block": (lambda: jbeit.BEiTBlock(16, 2, 3),
                   lambda: beit.BEiTBlock(16, 2, 3), (2, 26, 16), "tokens"),
    "beit": (lambda: jbeit.BEiT(**VIT), lambda: beit.BEiT(**VIT),
             (2, 40, 40, 3), "map"),
    "mae": (lambda: jmae.MAE(**VIT), lambda: mae.MAE(**VIT),
            (2, 40, 40, 3), "map"),
}


def module_inputs(name):
    shapes = MODULES[name][2]
    if isinstance(shapes, list):
        return [rand(*s, seed=i) for i, s in enumerate(shapes)]
    return rand(*shapes)


class Bundle(flax_nn.Module):
    """Every JAX module of ``MODULES`` as a submodule of its name: one
    variable tree and one compiled program for all of them."""

    @flax_nn.compact
    def __call__(self, inputs):
        return {name: MODULES[name][0]().clone(parent=self, name=name)(x)
                for name, x in inputs.items()}


@pytest.fixture(scope="module")
def references():
    inputs = {name: module_inputs(name) for name in MODULES}
    bundle = Bundle()
    variables = init_jax(bundle, inputs)
    fn = compile_quickly(jax.jit(bundle.apply), variables, inputs)
    return variables, jax.device_get(fn(variables, inputs))


def port_input(x, layout):
    if isinstance(x, list):
        return [to_nchw(t) for t in x]
    return to_nchw(x) if layout == "map" else torch.from_numpy(x)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, references):
    variables, outputs = references
    layout = MODULES[name][3]
    port = bridge(MODULES[name][1](), {col: tree[name] for col, tree in
                                       variables.items() if name in tree})
    with torch.no_grad():
        outs = port(port_input(module_inputs(name), layout))
    refs = outputs[name]
    if isinstance(outs, torch.Tensor):
        outs, refs = [outs], [refs]
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        out = to_nhwc(out) if layout == "map" else out.numpy()
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    if name == "swin":
        assert [o.shape for o in outs] == [(2, 8, 9, 9), (2, 16, 5, 5)]


@pytest.mark.parametrize("cls", [swin.SwinTransformer, convnext.ConvNeXt,
                                 beit.BEiT, mae.MAE])
def test_unported_backbone_features_raise(cls):
    kw = {swin.SwinTransformer: SWIN, convnext.ConvNeXt: CONVNEXT,
          beit.BEiT: VIT, mae.MAE: VIT}[cls]
    for extra in (dict(frozen_stages=1), dict(with_cp=True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            cls(**kw, **extra)


def test_registries():
    for name, cls in (("SwinTransformer", swin.SwinTransformer),
                      ("Swin", swin.SwinTransformer),
                      ("ConvNeXt", convnext.ConvNeXt), ("BEiT", beit.BEiT),
                      ("MAE", mae.MAE)):
        assert BACKBONE.get(name) is cls
    assert NECK.get("Feature2Pyramid") is Feature2Pyramid
    assert CONVOLUTION.get("deconv") is CONVOLUTION.get(
        "ConvTranspose2d") is ConvTranspose2d


# ------------------------------------------------------------- init
# name: (JAX module, port module, input NHWC)
INITS = {
    "swin": (lambda: jswin.SwinTransformer(depths=(1,), embed_dims=32,
                                           num_heads=(2,), out_indices=(0,)),
             lambda: swin.SwinTransformer(depths=(1,), embed_dims=32,
                                          num_heads=(2,), out_indices=(0,)),
             (1, 28, 28, 3)),
    "convnext": (lambda: jconvnext.ConvNeXt(depths=(1,), dims=(32,),
                                            out_indices=(0,)),
                 lambda: convnext.ConvNeXt(depths=(1,), dims=(32,),
                                           out_indices=(0,)),
                 (1, 16, 16, 3)),
    "mae": (lambda: jmae.MAE(embed_dims=64, num_layers=3, num_heads=2,
                             pretrain_img_size=64, out_indices=(2,)),
            lambda: mae.MAE(embed_dims=64, num_layers=3, num_heads=2,
                            pretrain_img_size=64, out_indices=(2,)),
            (1, 64, 64, 3)),
    "beit": (lambda: jbeit.BEiT(embed_dims=64, num_layers=1, num_heads=2,
                                pretrain_img_size=64, out_indices=(0,)),
             lambda: beit.BEiT(embed_dims=64, num_layers=1, num_heads=2,
                               pretrain_img_size=64, out_indices=(0,)),
             (1, 64, 64, 3)),
    "neck": (lambda: jneck.Feature2Pyramid(embed_dim=64),
             lambda: Feature2Pyramid(embed_dim=64), [(1, 4, 4, 64)] * 4),
}


class InitBundle(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, inputs):
        return {name: INITS[name][0]().clone(parent=self, name=name)(x)
                for name, x in inputs.items()}


def test_init_has_the_jax_distributions():
    """Truncated normal (std 0.02) linears, patch embeddings, Swin's bias
    tables and MAE's position table (MAE's ``attn.proj`` and ``fc2`` of
    block i divided by sqrt(2(i+1))), ConvNeXt's convs, the neck's
    transposed convs uniform in +-1/sqrt(fan_in); zeros (biases, BEiT's
    tables, q/v biases, class tokens) and constants (layer scales, norms)
    exactly; each other tensor's std within 3 standard errors of the JAX
    module's own init."""
    inputs = {name: (np.zeros(s, np.float32) if not isinstance(s, list)
                     else [np.zeros(t, np.float32) for t in s])
              for name, (_, _, s) in INITS.items()}
    bundle = InitBundle()
    args = (jax.random.PRNGKey(0), inputs)
    ref_all = compile_quickly(jax.jit(bundle.init), *args)(*args)
    for name, (_, make, _) in INITS.items():
        pm = make()
        init_weights(pm, torch.Generator().manual_seed(0))
        got = jax_state_dict(pm)
        ref = state_dict_from_variables(
            {col: tree[name] for col, tree in ref_all.items()
             if name in tree})
        assert sorted(got) == sorted(ref), name
        for key, a in got.items():
            b = np.asarray(ref[key])
            if b.std() == 0:
                np.testing.assert_array_equal(a, b, err_msg=key)
                continue
            assert abs(a.std() - b.std()) <= 3 * np.sqrt(
                2 / a.size) * b.std(), (name, key, a.std(), b.std())
    # MAE block 2's rescaled projections: std 0.02 / sqrt(6)
    pm = INITS["mae"][1]()
    init_weights(pm, torch.Generator().manual_seed(0))
    got = jax_state_dict(pm)
    assert abs(got["block2.fc2.weight"].std() - 0.02 / np.sqrt(6)) < 0.001


# ------------------------------------------------------------- tiny UPerNets
SWIN_SCHEDULE = load_python_config("configs/schedule/segformer_schedule.py")
BEIT_SCHEDULE = load_python_config(
    "configs/schedule/beit_finetune_schedule.py")
# name: (network config, backbone overrides, neck width or None, head
# inputs, aux input, image size, schedule, whether the bf16 step is held)
TINY = {
    "swin": ("upernet/upernet_swin-t",
             dict(embed_dims=8, depths=(2, 1, 1, 1), num_heads=(1, 2, 2, 4),
                  window_size=4),
             None, [8, 16, 32, 64], 32, 72, SWIN_SCHEDULE, False),
    "convnext": ("upernet/upernet_convnext-t",
                 dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32)),
                 None, [8, 16, 24, 32], 24, 64, SWIN_SCHEDULE, False),
    "beit": ("beit/upernet_beit-b",
             dict(embed_dims=16, num_layers=4, num_heads=2, patch_size=8,
                  pretrain_img_size=24, out_indices=(0, 1, 2, 3)),
             16, [16] * 4, 16, 64, BEIT_SCHEDULE, True),
    "mae": ("mae/upernet_mae-b",
            dict(embed_dims=16, num_layers=4, num_heads=2, patch_size=8,
                 pretrain_img_size=24, out_indices=(0, 1, 2, 3)),
            16, [16] * 4, 16, 64, BEIT_SCHEDULE, False),
}


def tiny_network(name):
    """The config cut to size: Swin's 72² image gives 18², 9², 5² and 3²
    maps (window 4: the first padded and shifted, the last below one
    window); BEiT's and MAE's 8 x 8 grid resamples their 3 x 3 tables."""
    config, backbone, neck, heads, aux = TINY[name][:5]
    network = load_python_config(f"configs/network/{config}.py")["model"]
    network["backbone"].update(backbone, drop_path_rate=0.0)
    if neck:
        network["neck"]["embed_dim"] = neck
    network["decode_head"].update(in_channels=heads, channels=8,
                                  dropout_ratio=0.0)
    network["auxiliary_head"].update(in_channels=aux, channels=8,
                                     dropout_ratio=0.0)
    return network


def batch(n=2, size=64, seed=9):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, size, size, 3).astype(np.float32)
    gt = rng.randint(0, 2, (n, size, size)).astype(np.int32)
    gt[rng.rand(n, size, size) < 0.1] = IGNORE
    return img, gt


def train_loss(jm, variables, img, gt, policy):
    """Train-mode ``forward_train`` under ``policy``: the loss and the
    decode logits as a function of the parameters."""
    def loss_fn(params):
        with jpolicy.policy_scope(policy):
            (logits, losses), _ = jm.apply(
                {**variables, "params": params}, img, gt,
                method="forward_train", train=True,
                rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return jtrain.parse_losses(losses)[0], logits["decode"]
    return loss_fn


@functools.lru_cache(maxsize=None)
def tiny_case(name):
    """The JAX side of a tiny UPerNet's step: the train-mode loss, decode
    logits and gradients in float32, the parameters after one update of
    the schedule's optimizer (its LR schedule at one step an epoch) from
    them, and, where held, the same loss, logits and gradients under the
    bf16 policy; one compiled program each (one for every model would
    compile in more than twice the time).  The JAX step's BatchNorm
    statistics are held in the earlier slices' tests and the optimizer's
    later steps in ``test_torch_port_paramwise.py``."""
    size, schedule, bf16 = TINY[name][5:8]
    network = tiny_network(name)
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, size, size, 3)),
                         jnp.zeros((1, size, size), jnp.int32),
                         method="forward_train", train=False)
    lr = jbuild_from_cfg(schedule["lr_config"], JLR).schedule(
        schedule["optimizer"]["lr"], 1)
    tx = jbuild_optimizer({**schedule["optimizer"], "lr": lr})
    img, gt = batch(size=size)
    params = variables["params"]

    def step(params):
        out = jax.value_and_grad(train_loss(jm, variables, img, gt, "fp32"),
                                 has_aux=True)(params)
        updates, _ = tx.update(out[1], tx.init(params), params)
        return out, optax.apply_updates(params, updates)

    (f32, grads), new = compile_quickly(jax.jit(step), params)(params)
    case = dict(network=network, variables=variables, loss=float(f32[0]),
                logits=np.asarray(f32[1]),
                grads=state_dict_from_variables({"params": grads}),
                params=state_dict_from_variables({"params": new}))
    if bf16:
        fn = jax.value_and_grad(train_loss(jm, variables, img, gt, "bf16"),
                                has_aux=True)
        case["bf16"] = compile_quickly(jax.jit(fn), params)(params)
    return case


def port_grads(model):
    """The port's gradients under their JAX names, in JAX layouts."""
    layout = layout_maps(model, to_jax=True)
    return {jax_name(name): layout.get(name, np.asarray)(p.grad.numpy())
            for name, p in model.named_parameters()}


def check_tiny_step(name):
    """One float32 ``make_train_step`` from the JAX weights: the train-mode
    decode logits at the slice tolerance (the same hard predictions but at
    genuine ties), the loss, every gradient and every parameter after the
    update; BEiT's and MAE's schedule makes its layer-decay groups."""
    case = tiny_case(name)
    size, schedule = TINY[name][5:7]
    img, gt = batch(size=size)
    model = bridge(build_segmentor(case["network"]), case["variables"])
    state = train_state.create_train_state(
        model, schedule["optimizer"], schedule["lr_config"])
    step = train_state.make_train_step(state.model, state.optimizer,
                                       state.scheduler)
    seen = []
    forward_train = model.forward_train

    def recorded(*args, **kwargs):
        logits, losses = forward_train(*args, **kwargs)
        seen.append(logits["decode"].detach())
        return logits, losses

    model.forward_train = recorded
    log = step(to_nchw(img), torch.from_numpy(gt).long(),
               torch.Generator().manual_seed(0))
    assert seen[0].shape == (2, 2, size, size)
    assert_argmax_parity(case["logits"], to_nhwc(seen[0]))
    np.testing.assert_allclose(float(log["loss"]), case["loss"], rtol=1e-5)
    grads = port_grads(model)
    assert sorted(grads) == sorted(case["grads"])
    for key, ref in case["grads"].items():
        np.testing.assert_allclose(grads[key], ref, err_msg=key, **TOL)
    got = {k: v for k, v in jax_state_dict(model).items()
           if k in case["params"]}
    assert sorted(got) == sorted(case["params"])
    for key, ref in case["params"].items():
        np.testing.assert_allclose(got[key], ref, err_msg=key, **TOL)
    if "paramwise_cfg" in schedule["optimizer"]:
        assert len(state.optimizer.param_groups) > 4


def check_tiny_bf16_step(name):
    """Train-mode ``forward_train`` and its gradients under the bf16
    policy, from the same weights (no optimizer)."""
    case, size = tiny_case(name), TINY[name][5]
    img, gt = batch(size=size)
    (jloss, ref), jgrads = case["bf16"]
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    jgrads = state_dict_from_variables({"params": jgrads})
    model = bridge(build_segmentor(case["network"]),
                   case["variables"]).train()
    with torch.enable_grad(), policy_scope("bf16"):
        logits, losses = model.forward_train(to_nchw(img),
                                             torch.from_numpy(gt).long())
        loss, _ = train_state.parse_losses(losses)
        loss.backward()
    assert logits["decode"].dtype == torch.bfloat16
    out = to_nhwc(logits["decode"].detach().float())
    assert np.abs(out - ref).max() <= LOGIT_SHARE * np.abs(ref).max()
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= ARGMAX_AGREE
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)
    grads = port_grads(model)
    assert sorted(grads) == sorted(jgrads)
    largest32 = max(np.abs(g).max() for g in case["grads"].values())
    largest = max(np.abs(g).max() for g in jgrads.values())
    for key, ref in jgrads.items():
        if np.abs(case["grads"][key]).max() < 1e-6 * largest32:
            assert np.abs(grads[key]).max() <= 2.0 ** -8 * largest, key
            continue
        dist = np.linalg.norm(grads[key] - ref) / np.linalg.norm(ref)
        assert dist <= GRAD_SHARE, (key, dist)


@pytest.mark.parametrize("name", ["convnext", "swin"])
def test_tiny_upernet_train_step_matches_jax(name):
    """Swin's and ConvNeXt's; BEiT's and MAE's, under the layer-decay
    schedule, are in ``test_torch_port_paramwise.py``."""
    check_tiny_step(name)


# ------------------------------------------------------------- the bridge
FULL_SIZE = ["upernet/upernet_swin-t", "upernet/upernet_swin-t-w8",
             "upernet/upernet_convnext-t", "beit/upernet_beit-b",
             "mae/upernet_mae-b"]


@pytest.mark.parametrize("config", FULL_SIZE)
def test_bridge_maps_the_full_size_configs_strictly(config):
    """Every JAX leaf of the full-width config maps to a port tensor of
    the mapped shape and no port tensor is left over, on shapes alone: the
    JAX variables from ``jax.eval_shape`` as zero-stride arrays, the port
    model on the ``meta`` device."""
    network = load_python_config(f"configs/network/{config}.py")["model"]

    def heads(segmentor, img):
        feats = segmentor.extract_feat(img)
        return (segmentor.decode_head_module(feats),
                segmentor.aux_head_modules(feats))

    shapes = jax.eval_shape(lambda: jax_build(network).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), method=heads))
    leaves = state_dict_from_variables(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes))
    with torch.device("meta"):
        model = build_segmentor(network)
    mapped = mapped_state_dict(model, leaves)
    assert len(mapped) == len(leaves)
    assert sum(a.size for a in mapped.values()) > 50_000_000
