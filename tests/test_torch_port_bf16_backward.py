"""The flagship's bf16 backward, held where rounding noise has not
compounded: one ResNetV1c ``Bottleneck`` (dilated, with its downsample)
and the ``ASPPHead`` alone, each fed the same float32 input and upstream
gradient in both packages, in train mode (BatchNorm on batch statistics)
under the bf16 policy.

Every parameter gradient and the input gradient of the port (autocast to
bfloat16) must sit within ``GRAD_SHARE`` relative (Frobenius) distance of
the JAX package's bf16 gradient, the bound ``PERF.md`` §2 holds the other
bf16 gradients to.  Measured on the CPU, the largest distance is 0.112
(the Bottleneck's ``bn2.bias``; its other tensors 0.03-0.09) and 0.053
(the ASPPHead's 1 x 1 branch's BN bias; most tensors below 0.01): bf16's
rounding of single layers, not the 0.88 median of the depth-18
flagship's backbone (``torch_port_bf16_gradient_noise.py``), where the
rounding compounds through the layers.  A wrong backward fails the bound
with room: the Bottleneck's 3 x 3 weight gradient transposed sits 1.37 of
its norm from JAX's, the ASPP's second dilated branch's gradient 1.25
from the first's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax, to_nchw, to_nhwc)

from image_segmentation_lab_tpu.core.initialize.checkpoint import \
    state_dict_from_variables  # noqa: E402
from image_segmentation_lab_tpu.core.mixed_precision import \
    policy as jpolicy  # noqa: E402
from image_segmentation_lab_tpu.models.backbones import \
    resnet as jresnet  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import \
    aspp_head as jaspp  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_name, layout_maps)
from image_segmentation_lab_tpu_torch.core.mixed_precision import (  # noqa: E402,E501
    compute_autocast, policy_scope)
from image_segmentation_lab_tpu_torch.models.backbones import \
    resnet  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import \
    ASPPHead  # noqa: E402

GRAD_SHARE = 0.25
BN = dict(type="SyncBN", requires_grad=True)
ASPP = dict(in_channels=16, channels=8, dilations=(1, 2, 3), num_classes=3,
            norm_cfg=BN, dropout_ratio=0.0, align_corners=False)
# name: (JAX module, port module, input NHWC, whether the input is a head's
# list of maps)
CASES = {
    "bottleneck": (
        lambda: jresnet.Bottleneck(16, 8, dilation=2, norm_cfg=BN),
        lambda: resnet.Bottleneck(16, 8, dilation=2, norm_cfg=BN),
        (2, 10, 10, 16), False),
    "aspp_head": (lambda: jaspp.ASPPHead(**ASPP), lambda: ASPPHead(**ASPP),
                  (2, 9, 9, 16), True),
}


def rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_bf16_grads(name):
    """JAX's bf16 output and gradients (parameters, input) for the
    upstream gradient ``rand(output shape, seed=3)``."""
    make, _, shape, listed = CASES[name]
    module, x = make(), rand(*shape, seed=1)
    variables = init_jax(module, [x] if listed else x, train=True)

    def fn(params, x):
        with jpolicy.policy_scope("bf16"):
            out, _ = module.apply({**variables, "params": params},
                                  [x] if listed else x, train=True,
                                  mutable=["batch_stats"])
        return out.astype(jnp.float32)

    out_shape = jax.eval_shape(fn, variables["params"], x).shape
    g = rand(*out_shape, seed=3)

    def vjp(params, x):
        out, back = jax.vjp(fn, params, x)
        return out, back(g)

    out, (gparams, gx) = compile_quickly(jax.jit(vjp), variables["params"],
                                         x)(variables["params"], x)
    grads = state_dict_from_variables({"params": gparams})
    return variables, x, g, np.asarray(out), grads, np.asarray(gx)


def port_bf16_grads(name, variables, x, g):
    _, make, _, listed = CASES[name]
    model = bridge(make(), variables).train()
    xt = to_nchw(x).requires_grad_(True)
    with torch.enable_grad(), policy_scope("bf16"), compute_autocast("cpu"):
        out = model([xt] if listed else xt)
        (out.float() * to_nchw(g)).sum().backward()
    layout = layout_maps(model, to_jax=True)
    grads = {jax_name(k): layout.get(k, np.asarray)(p.grad.numpy())
             for k, p in model.named_parameters()}
    return to_nhwc(out.detach().float()), grads, to_nhwc(xt.grad)


def distance(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name = request.param
    variables, x, g, ref_out, ref_grads, ref_gx = jax_bf16_grads(name)
    out, grads, gx = port_bf16_grads(name, variables, x, g)
    return dict(name=name, out=out, ref_out=ref_out, grads=grads,
                ref_grads=ref_grads, gx=gx, ref_gx=ref_gx)


def test_bf16_gradients_match_jax_per_tensor(case):
    assert distance(case["out"], case["ref_out"]) <= 2.0 ** -6
    assert sorted(case["grads"]) == sorted(case["ref_grads"])
    dists = {k: distance(case["grads"][k], ref)
             for k, ref in case["ref_grads"].items()}
    dists["input"] = distance(case["gx"], case["ref_gx"])
    assert max(dists.values()) <= GRAD_SHARE, dists
    assert len(dists) >= 8


# the Bottleneck's 3 x 3 weight, whose gradient a broken backward could
# hand back transposed (its in and out channels are equal); two ASPP
# branches of one shape, whose gradients it could swap
WRONG = {"bottleneck": ("conv2.weight", None),
         "aspp_head": ("aspp_modules.branches.1.conv.weight",
                       "aspp_modules.branches.2.conv.weight")}


def test_a_wrong_backward_fails_the_bound(case):
    tensor, other = WRONG[case["name"]]
    ref = case["ref_grads"][jax_name(tensor)]
    got = case["grads"][jax_name(tensor)]
    assert distance(got, ref) <= GRAD_SHARE
    wrong = (np.swapaxes(got, 2, 3) if other is None  # HWIO: in <-> out
             else case["grads"][jax_name(other)])
    assert distance(wrong, ref) > 2 * GRAD_SHARE
