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
from torch_port_helpers import (bridge, init_jax, jax_apply,  # noqa: E402
                                to_nchw, to_nhwc)

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
    refs = jax.jit(lambda v, x: jm.apply(v, x))(variables, x)
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
