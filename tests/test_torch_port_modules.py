"""Port modules against their JAX counterparts, in eval mode at float32.

Weights are seeded numpy values loaded into the JAX module and carried to
the port by the bridge; inputs are seeded numpy arrays (NHWC for JAX, NCHW
for the port).  Tolerance: rtol 1e-4 and atol 1e-4, a few float32 ulps of
the activations after reordered convolution sums.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax, jax_apply, to_nchw, to_nhwc)

from image_segmentation_lab_tpu.models.backbones import resnet as jresnet  # noqa: E402,E501
from image_segmentation_lab_tpu.models.common.conv_module import \
    ConvModule as JConvModule  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import \
    aspp_head as jaspp, fcn_head as jfcn  # noqa: E402
from image_segmentation_lab_tpu.ops import pooling as jpool  # noqa: E402
from image_segmentation_lab_tpu.utils.ops import resize as jresize  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import \
    load_jax_state_dict  # noqa: E402
from image_segmentation_lab_tpu_torch.models.backbones import resnet  # noqa: E402,E501
from image_segmentation_lab_tpu_torch.models.common.conv_module import \
    ConvModule  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import (  # noqa: E402,E501
    aspp_head, fcn_head)
from image_segmentation_lab_tpu_torch.ops import resize_backward  # noqa: E402,E501
from image_segmentation_lab_tpu_torch.utils.ops import resize  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BN = dict(type="SyncBatchNorm", requires_grad=True)


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def check_module(jax_module, port_module, *jax_args):
    """Same weights, same input: the port's NCHW output equals JAX's."""
    variables = init_jax(jax_module, *jax_args)
    bridge(port_module, variables)
    ref = jax_apply(jax_module, variables, *jax_args)
    with torch.no_grad():
        out = port_module(*[[to_nchw(a) for a in x] if isinstance(x, tuple)
                            else to_nchw(x) for x in jax_args])
    np.testing.assert_allclose(to_nhwc(out), ref, **TOL)


CONV_MODULES = {
    "dilated_bn_relu": dict(in_channels=5, out_channels=7, kernel_size=3,
                            padding=2, dilation=2, norm_cfg=BN),
    "strided_bias_no_norm": dict(in_channels=5, out_channels=4,
                                 kernel_size=3, stride=2, padding=1,
                                 act_cfg=None),
}


@pytest.mark.parametrize("name", sorted(CONV_MODULES))
def test_conv_module(name):
    kw = CONV_MODULES[name]
    check_module(JConvModule(**kw), ConvModule(**kw), rand(2, 9, 11, 5))


@pytest.mark.parametrize("stride,dilation,style",
                         [(2, 1, "pytorch"), (1, 2, "pytorch"),
                          (2, 1, "caffe")])
def test_bottleneck(stride, dilation, style):
    """The R50 block, with its downsample branch, on its own."""
    kw = dict(inplanes=12, planes=4, stride=stride, dilation=dilation,
              style=style, norm_cfg=BN)
    check_module(jresnet.Bottleneck(**kw), resnet.Bottleneck(**kw),
                 rand(2, 10, 9, 12))


def test_resnet_v1c_d8():
    kw = dict(depth=18, stem_channels=8, base_channels=8,
              dilations=(1, 1, 2, 4), strides=(1, 2, 1, 1),
              contract_dilation=True, norm_cfg=BN)
    jm, pm = jresnet.ResNetV1c(**kw), resnet.ResNetV1c(**kw)
    x = rand(1, 37, 43, 3)
    variables = init_jax(jm, x)
    bridge(pm, variables)
    refs = compile_quickly(jax.jit(lambda v, x: jm.apply(v, x)),
                           variables, x)(variables, x)
    with torch.no_grad():
        outs = pm(to_nchw(x))
    assert len(outs) == len(refs) == 4
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **TOL)


def test_norm_eval_keeps_running_stats():
    pm = resnet.ResNetV1c(depth=18, stem_channels=8, base_channels=8,
                          norm_eval=True).train()
    assert all(not m.training for m in pm.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


HEADS = {
    "aspp": (jaspp.ASPPHead, aspp_head.ASPPHead,
             dict(in_channels=12, channels=8, dilations=(1, 2, 3))),
    "fcn_concat": (jfcn.FCNHead, fcn_head.FCNHead,
                   dict(in_channels=12, channels=8, num_convs=2,
                        concat_input=True)),
    "fcn_aux": (jfcn.FCNHead, fcn_head.FCNHead,
                dict(in_channels=12, channels=8, num_convs=1,
                     concat_input=False)),
    "fcn_resize_concat": (jfcn.FCNHead, fcn_head.FCNHead,
                          dict(in_channels=[4, 12], in_index=[0, 1],
                               input_transform="resize_concat", channels=8,
                               num_convs=1)),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_decode_head(name):
    jcls, pcls, kw = HEADS[name]
    kw = dict(dict(in_index=1), **kw, num_classes=3, norm_cfg=BN,
              dropout_ratio=0.1)
    feats = (rand(2, 5, 6, 4, seed=2), rand(2, 9, 11, 12, seed=3))
    check_module(jcls(**kw), pcls(**kw), feats)


@pytest.mark.parametrize("op", ["max_pool_3_2_1", "adaptive_avg_pool_1",
                                "resize_up", "resize_down",
                                "resize_up_align_corners"])
def test_pooling_and_resize(op):
    """The port calls torch's pooling and interpolation where the JAX
    package builds its own; both must agree (interpolation to a few ulps:
    the two lerps round in another order)."""
    x = rand(2, 13, 10, 3)
    jx, px = jnp.asarray(x), to_nchw(x)
    ref, out = {
        "max_pool_3_2_1": lambda: (jpool.max_pool2d(jx, 3, 2, 1),
                                   F.max_pool2d(px, 3, 2, 1)),
        "adaptive_avg_pool_1": lambda: (jpool.adaptive_avg_pool2d(jx, 1),
                                        F.adaptive_avg_pool2d(px, 1)),
        "resize_up": lambda: (jresize(jx, (29, 17)), resize(px, (29, 17))),
        "resize_down": lambda: (jresize(jx, (5, 7)), resize(px, (5, 7))),
        "resize_up_align_corners": lambda: (
            jresize(jx, (25, 19), align_corners=True),
            resize(px, (25, 19), align_corners=True)),
    }[op]()
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **TOL)


# (N, C, H, W), output size, align_corners[, the user's scale factor]: up
# 2x and 4x (SETR's steps), a ragged up, down, align_corners up and down,
# and a 1-pixel input (the ASPP image pool's resize)
RESIZES = {
    "up_2x": ((2, 3, 6, 5), (12, 10), False),
    "up_4x": ((1, 2, 5, 4), (20, 16), False),
    "up_ragged": ((2, 3, 13, 10), (29, 17), False),
    "down": ((2, 3, 13, 10), (5, 7), False),
    "up_align_corners": ((2, 3, 13, 10), (25, 19), True),
    "down_align_corners": ((1, 2, 17, 9), (8, 4), True),
    "one_pixel": ((2, 3, 1, 1), (9, 7), False),
    # wide tables (more than 8 taps an axis), as DeepLabV3's image pool (a
    # 1 x 1 input), PSPNet's PPM (6 x 6 to the 80² map) and the 8x logits
    # (16 taps an axis) take them
    "pool_1_to_16": ((2, 3, 1, 1), (16, 16), False),
    "pool_6_to_80": ((1, 2, 6, 6), (80, 80), False),
    "up_8x": ((1, 2, 4, 5), (32, 40), False),
    # MultiLevelNeck's 0.5 level on an odd grid, read at the user's step 2
    # (25 -> 12); a plane 4x taller in one axis, 2.5x wider in the other
    "down_half_odd": ((2, 3, 25, 25), (12, 12), False, 0.5),
    "non_square": ((1, 2, 3, 16), (12, 40), False),
}
# against jax.vjp of the JAX resize: one case of each kind (up, down,
# align_corners, a 1-pixel input, wide tables, the user's scale; the scale
# in float32 only), all in one program
JAX_RESIZES = [(name, dtype) for name in ("up_2x", "down", "up_align_corners",
                                          "one_pixel", "pool_1_to_16",
                                          "up_8x")
               for dtype in ("float32", "bfloat16")] + [("down_half_odd",
                                                         "float32")]
# resize_backward_plain against F.interpolate's own CPU backward: the same
# float32 weights and products, summed in another order
RESIZE_ULPS = 8


def resize_grad(x, gy, size, align_corners, fn=resize, scale=None):
    leaf = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out = (fn(leaf, size, align_corners=align_corners) if scale is None
               else fn(leaf, scale_factor=scale,
                       align_corners=align_corners))
        return out, torch.autograd.grad(out, leaf, gy.to(x.dtype))[0]


def resize_inputs(name, seed=11):
    (n, c, h, w), size, align_corners, *scale = RESIZES[name]
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(n, c, h, w).astype(np.float32)),
            torch.from_numpy(rng.randn(n, c, *size).astype(np.float32)),
            size, align_corners, scale[0] if scale else None)


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_bf16_resize_gradient_is_the_float32_gradient_rounded_once(name):
    """Forward and backward in bf16 are the float32 ones rounded once, bit
    for bit (as the JAX resize computes them), and a second call gives the
    same bits; the backward is the port's own."""
    x, gy, size, ac, scale = resize_inputs(name)
    xb, gb = x.bfloat16(), gy.bfloat16()
    out, grad = resize_grad(xb, gb, size, ac, scale=scale)
    out32, grad32 = resize_grad(xb.float(), gb.float(), size, ac, scale=scale)
    assert type(out.grad_fn).__name__ == "BilinearResizeBackward"
    assert grad.dtype == torch.bfloat16
    assert torch.equal(out, out32.bfloat16())
    assert torch.equal(grad, grad32.bfloat16())
    assert torch.equal(grad, resize_grad(xb, gb, size, ac, scale=scale)[1])


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_resize_backward_plain_is_the_interpolate_backward(name):
    """Within a few float32 ulps of max |g| of ``F.interpolate``'s CPU
    backward, on the CPU through the wrapper, which runs the plain version
    (the W pass, then the H pass) and launches nothing."""
    x, gy, size, ac, scale = resize_inputs(name)
    _, ref = resize_grad(
        x, gy, size, ac, scale=scale,
        fn=lambda t, s=None, align_corners=False, scale_factor=None:
        F.interpolate(t, size=s, scale_factor=scale_factor, mode="bilinear",
                      align_corners=align_corners))
    scales = (scale, scale) if scale else None
    launched = dict(resize_backward.launches)
    got = resize_backward.resize_backward(gy, x.shape[2:], ac, scales)
    assert resize_backward.launches == launched
    assert torch.equal(got, resize_backward.resize_backward_plain(
        gy, x.shape[2:], ac, scales))
    tol = RESIZE_ULPS * torch.finfo(torch.float32).eps * float(
        ref.abs().max())
    assert float((got - ref).abs().max()) <= tol


@pytest.fixture(scope="module")
def jax_resize_grads():
    """``jax.vjp`` of the JAX resize (NHWC) at every JAX_RESIZES case, in
    float32, as NCHW torch tensors: one program, compiled quickly."""
    def grad(name, dtype):
        x, gy, size, ac, scale = resize_inputs(name, seed=12)
        jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
        jx, jg = (jnp.asarray(to_nhwc(t), jdtype) for t in (x, gy))
        _, vjp = jax.vjp(lambda u: jresize(
            u, None if scale else size, scale_factor=scale,
            align_corners=ac, warning=False), jx)
        return vjp(jg)[0].astype(jnp.float32)

    fn = jax.jit(lambda: [grad(name, dtype) for name, dtype in JAX_RESIZES])
    return {case: to_nchw(np.asarray(ref)) for case, ref in
            zip(JAX_RESIZES, compile_quickly(fn)())}


@pytest.mark.parametrize("name,dtype", JAX_RESIZES,
                         ids=[f"{n}-{d}" for n, d in JAX_RESIZES])
def test_resize_gradient_matches_jax_vjp(name, dtype, jax_resize_grads):
    """The port's resize gradient against ``jax.vjp`` of the JAX resize
    (NHWC): in float32 within a few float32 ulps of max |g| (the JAX
    weights are rounded from float64, the port's computed in float32 as
    ``F.interpolate`` computes them); in bf16 each is the float32 gradient
    rounded once, so they differ by at most one bf16 step where the two
    float32 gradients straddle a rounding boundary."""
    x, gy, size, ac, scale = resize_inputs(name, seed=12)
    ref = jax_resize_grads[name, dtype]
    tdtype = getattr(torch, dtype)
    _, got = resize_grad(x.to(tdtype), gy.to(tdtype), size, ac, scale=scale)
    assert got.dtype == tdtype
    top = float(ref.abs().max())
    ulps = RESIZE_ULPS * torch.finfo(torch.float32).eps * top
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    assert bool(((got.float() - ref).abs() <= ulps + rtol * ref.abs()).all())


@pytest.mark.parametrize("fault", ["unused_jax_leaf", "unfilled_port_tensor",
                                   "shape_mismatch"])
def test_bridge_is_strict(fault):
    from image_segmentation_lab_tpu.core.initialize.checkpoint import \
        state_dict_from_variables
    kw = CONV_MODULES["dilated_bn_relu"]
    sd = state_dict_from_variables(init_jax(JConvModule(**kw),
                                            rand(1, 9, 11, 5)))
    if fault == "unused_jax_leaf":
        sd["extra.weight"] = np.zeros(3, np.float32)
    elif fault == "unfilled_port_tensor":
        del sd["bn.running_var"]
    else:
        sd["bn.weight"] = np.zeros(8, np.float32)
    with pytest.raises(KeyError, match={
            "unused_jax_leaf": "extra.weight",
            "unfilled_port_tensor": "bn.running_var",
            "shape_mismatch": "bn.weight"}[fault]):
        load_jax_state_dict(ConvModule(**kw), sd)


def test_registries_are_the_ports_own():
    """Both packages register ``ResNetV1c`` without colliding."""
    from image_segmentation_lab_tpu.core.registry_hub import \
        BACKBONE as JBACKBONE
    from image_segmentation_lab_tpu_torch.core.registry_hub import BACKBONE
    assert JBACKBONE.get("ResNetV1c") is jresnet.ResNetV1c
    assert BACKBONE.get("ResNetV1c") is resnet.ResNetV1c
