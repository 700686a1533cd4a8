"""The bf16 compute policy (the schedule's ``amp=True``) against the JAX
package, on the CPU.

The port's policy is ``torch.autocast`` to bfloat16 over float32
parameters, entered by ``encode_decode`` and ``forward_train``; the JAX
package casts each conv and linear input and weight to bfloat16
(``compute_cast``).  Both keep the ViT's residual stream in bfloat16 (the
patch embedding's output is bf16 and every residual add stays there),
LayerNorm and BatchNorm normalise in float32 and round their output to
bfloat16 once, attention scores and softmax are float32 with P rounded to
bfloat16 for the PV product, and the losses cast the logits to float32.
The rounding points that differ: GELU (torch rounds its float32 result
once, JAX computes on bf16 values), the bilinear and bicubic resizes and
the sum orders of the bf16 products, which torch accumulates in float32
before one rounding and XLA's CPU may round in between.

Tolerances, on the tiny SETR-PUP (configs/network/setr/setr_pup_vit-s.py
cut to 2 layers of width 128, heads of d = 32 and 64, patch 8, 40²
images) and on the flagship's structure (``tiny_flagship_train_cfg``:
DeepLabV3 at depth 18 with its sigmoid losses, 64² images): logits within
2**-4 of the largest |logit| (about eight bf16 rounding steps of it) and
the same hard prediction at 98 % of the pixels; after one SGD step, the
loss at rtol 1e-2, and each gradient tensor at a relative (Frobenius)
distance from JAX's of at most twice the distance of the port's float32
gradient from it, and for SETR's at most 0.25.  bf16 rounding moves
SETR's small-width gradients by 8-10 % of their norm on either side, so
the two bf16 steps sit 11-15 % apart and a lost or doubled term shows as
100 %.  DeepLabV3's backbone gradients are mostly bf16 noise (see its
test); its step is also held on its BatchNorm statistics and its
classifiers' gradients within 0.25.  The same weights give
float32-policy logits that differ from the bf16 ones by more than a bf16
rounding, so the test sees which policy ran.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax, tiny_flagship_train_cfg,
                                tiny_setr_network, to_nchw, to_nhwc)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.core.mixed_precision import \
    policy as jpolicy  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.mixed_precision import (  # noqa: E402,E501
    Policy, amp_policy, compute_autocast, get_policy, policy, policy_scope,
    set_policy)
from image_segmentation_lab_tpu_torch.models.backbones import vit  # noqa: E402,E501
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.ops import flash_attention  # noqa: E402,E501

SCHEDULE = load_python_config("configs/schedule/kvasir_training_schedule.py")
LOGIT_SHARE = 2.0 ** -4  # of max |logit|
GRAD_SHARE, GRAD_RATIO = 0.25, 2.0  # per gradient tensor, see the docstring
ARGMAX_AGREE = 0.98
IGNORE = 255


def test_policy_api_matches_jax():
    """The JAX names and dtypes; ``amp_policy`` maps the schedule flag;
    ``policy_scope`` restores the previous policy, also after a raise."""
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    assert sorted(policy._POLICIES) == sorted(jpolicy._POLICIES)
    for name, ref in jpolicy._POLICIES.items():
        got = policy._POLICIES[name]
        assert (got.param_dtype, got.compute_dtype, got.output_dtype) == (
            dtypes[ref.param_dtype], dtypes[ref.compute_dtype],
            dtypes[ref.output_dtype]), name
    assert SCHEDULE["amp"] is True
    before = get_policy()
    assert before == Policy()
    try:
        assert amp_policy(True).compute_dtype == torch.bfloat16
        assert get_policy() == policy._POLICIES["bf16"]
        with policy_scope("fp32") as inner:
            assert get_policy() is inner
            assert inner.compute_dtype == torch.float32
        assert get_policy().compute_dtype == torch.bfloat16
        with compute_autocast("cpu"):
            assert torch.is_autocast_enabled("cpu")
            assert torch.get_autocast_dtype("cpu") == torch.bfloat16
        with pytest.raises(RuntimeError), policy_scope("fp32"):
            raise RuntimeError
        assert get_policy().compute_dtype == torch.bfloat16
        assert amp_policy(False) == Policy()
        with compute_autocast("cpu"):
            assert not torch.is_autocast_enabled("cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            set_policy("bf16_full")
        with pytest.raises(TypeError):
            set_policy(torch.bfloat16)
    finally:
        set_policy(before)
    assert get_policy() == before


def test_plain_attention_keeps_float32_scores_under_autocast():
    """The plain forward and backward give under bf16 autocast exactly
    what they give outside it: float32 scores, lse and dS."""
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 9, 2, 32).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = flash_attention.attention_plain(q, k, v, 0.2)
    delta = flash_attention.backward_delta(o, do)
    grads = flash_attention.attention_backward_plain(q, k, v, do, lse,
                                                     delta, 0.2)
    with policy_scope("bf16"), compute_autocast("cpu"):
        o_amp, lse_amp = flash_attention.attention_plain(q, k, v, 0.2)
        grads_amp = flash_attention.attention_backward_plain(
            q, k, v, do, lse, delta, 0.2)
    assert lse_amp.dtype == torch.float32 and o_amp.dtype == torch.bfloat16
    for out, ref in ((o_amp, o), (lse_amp, lse), *zip(grads_amp, grads)):
        assert out.dtype == ref.dtype
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def wide_setr(num_heads):
    """The tiny SETR at width 128 with ``num_heads`` heads (d = 128 /
    num_heads), drop path off."""
    network = tiny_setr_network()
    network["backbone"].update(embed_dims=128, num_heads=num_heads,
                               drop_path_rate=0.0)
    for head in ("decode_head", "auxiliary_head"):
        network[head]["in_channels"] = 128
    return network


# the network and its images' side for each case
CASES = {"d32": (lambda: wide_setr(4), 40), "d64": (lambda: wide_setr(2), 40),
         "deeplabv3": (tiny_flagship_train_cfg, 64)}


def bf16_case(name):
    """The case's network, its JAX module and variables, and its images'
    side; the JAX variables are built once per case."""
    make_network, size = CASES[name]
    return (make_network(), *jax_case(name), size)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    make_network, size = CASES[name]
    jm = jax_build(make_network())
    variables = init_jax(jm, jnp.zeros((1, size, size, 3)),
                         jnp.zeros((1, size, size), jnp.int32),
                         method="forward_train", train=False)
    return jm, variables


def batch(seed, n=2, size=40):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, size, size, 3).astype(np.float32)
    gt = rng.randint(0, 2, (n, size, size)).astype(np.int32)
    gt[rng.rand(n, size, size) < 0.1] = IGNORE
    return img, gt


@pytest.mark.parametrize("name", ["d32", "d64", "deeplabv3"])
def test_setr_bf16_forward_matches_jax(name, monkeypatch):
    network, jm, variables, size = bf16_case(name)
    img, _ = batch(seed=3, size=size)
    with jpolicy.policy_scope("bf16"):
        ref = compile_quickly(jax.jit(lambda v, x: jm.apply(
            v, x, method="encode_decode")), variables, img)(variables, img)
    assert ref.dtype == jnp.bfloat16
    ref = ref.astype(np.float32)

    attention_dtypes = []
    attention = vit.multihead_attention

    def spy(q, k, v, scale):
        attention_dtypes.append((q.dtype, k.dtype, v.dtype))
        return attention(q, k, v, scale)

    monkeypatch.setattr(vit, "multihead_attention", spy)
    model = bridge(build_segmentor(network), variables)
    with torch.no_grad():
        with policy_scope("bf16"):
            out = model.encode_decode(to_nchw(img))
        fp32 = to_nhwc(model.encode_decode(to_nchw(img)))
    assert out.dtype == torch.bfloat16
    if name == "deeplabv3":
        assert attention_dtypes == []
    else:
        assert attention_dtypes[:2] == [(torch.bfloat16,) * 3] * 2
        assert attention_dtypes[2:] == [(torch.float32,) * 3] * 2
    out = to_nhwc(out.float())
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= LOGIT_SHARE * scale, (err, scale)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= ARGMAX_AGREE
    # the float32 policy's logits are further from bf16's than a rounding
    assert np.abs(fp32 - out).max() > 2.0 ** -8 * scale


def sgd_gradients(before, after, lr, weight_decay):
    """The gradient of a first SGD step (momentum buffer = g + wd·p):
    ``g = (before - after) / lr - wd·before``."""
    return {k: (before[k] - after[k]) / lr - weight_decay * before[k]
            for k in before}


def test_setr_bf16_train_step_matches_jax():
    """One step of ``make_train_step`` under ``amp_policy(True)`` against
    the JAX step under ``policy_scope("bf16")``, from the same weights:
    the loss, and each parameter's gradient recovered from the SGD
    update."""
    step = bf16_step("d64")
    for name, ref in step["ref_grads"].items():
        err, err32 = step["distance"](name)
        assert err <= min(GRAD_SHARE, GRAD_RATIO * err32), (name, err, err32)


def test_deeplabv3_bf16_train_step_matches_jax():
    """The same step for the flagship's structure: the loss, every
    gradient within GRAD_RATIO of the port's float32 gradient's distance,
    the classifiers' gradients (decode and aux ``conv_seg``) also within
    GRAD_SHARE, and every BatchNorm running statistic after the step
    within four bf16 rounding steps of its largest value.  The backbone's
    gradients pass through the input gradients of train-mode BatchNorms,
    whose mean subtractions amplify bf16 rounding: in either package its
    bf16 gradients differ from the float32 ones by tens of percent of
    their norm up to several times it, so only the classifiers are held
    to GRAD_SHARE."""
    step = bf16_step("deeplabv3")
    for name in step["ref_grads"]:
        err, err32 = step["distance"](name)
        assert err <= GRAD_RATIO * err32, (name, err, err32)
    for name in ("decode_head.conv_seg.weight", "decode_head.conv_seg.bias",
                 "auxiliary_head.conv_seg.weight",
                 "auxiliary_head.conv_seg.bias"):
        err, _ = step["distance"](name)
        assert err <= GRAD_SHARE, (name, err)
    out, ref = step["model"].state_dict(), step["ref_model"].state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        atol = 4 * 2.0 ** -8 * float(ref[key].abs().max())
        np.testing.assert_allclose(out[key].numpy(), ref[key].numpy(),
                                   rtol=0, atol=atol, err_msg=key)


def bf16_step(name):
    """One bf16 step of the case in each package from the same weights,
    and the port's float32 step: the port's model after it, JAX's (through
    the bridge), the gradients recovered from the updates, and
    ``distance(name)``: the relative (Frobenius) distance of the port's
    bf16 and float32 gradients from JAX's bf16 one."""
    network, jm, variables, size = bf16_case(name)
    img, gt = batch(seed=4, size=size)
    opt_cfg = SCHEDULE["optimizer"]
    lr, wd = opt_cfg["lr"], opt_cfg["weight_decay"]

    tx = jbuild_optimizer(dict(opt_cfg))
    params = variables["params"]
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               frozen_params={},
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(params))
    with jpolicy.policy_scope("bf16"):
        jstep = compile_quickly(jtrain.make_train_step(jm, tx, donate=False),
                                jstate, img, gt, jax.random.PRNGKey(0))
        jstate, jlog = jstep(jstate, img, gt, jax.random.PRNGKey(0))

    model = bridge(build_segmentor(network), variables)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = train_state.create_train_state(model, opt_cfg)
    step = train_state.make_train_step(state.model, state.optimizer)
    with policy_scope("bf16"):
        log = step(to_nchw(img), torch.from_numpy(gt).long(),
                   torch.Generator().manual_seed(0))
    assert get_policy() == Policy()
    np.testing.assert_allclose(float(log["loss"]), float(jlog["loss"]),
                               rtol=1e-2)

    # the float32 step from the same weights: how far bf16 rounding alone
    # moves a gradient
    model32 = bridge(build_segmentor(network), variables)
    state32 = train_state.create_train_state(model32, opt_cfg)
    train_state.make_train_step(state32.model, state32.optimizer)(
        to_nchw(img), torch.from_numpy(gt).long(),
        torch.Generator().manual_seed(0))

    grads = sgd_gradients(before, dict(model.named_parameters()), lr, wd)
    grads32 = sgd_gradients(before, dict(model32.named_parameters()), lr, wd)
    ref_model = bridge(build_segmentor(network), jstate.variables())
    ref_grads = sgd_gradients(before, dict(ref_model.named_parameters()),
                              lr, wd)
    assert sorted(ref_grads) == sorted(before)

    def distance(key):
        ref = ref_grads[key].detach()
        return tuple(float((g[key].detach() - ref).norm() / ref.norm())
                     for g in (grads, grads32))

    return dict(model=model, ref_model=ref_model, ref_grads=ref_grads,
                distance=distance)
