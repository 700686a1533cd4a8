"""Train steps of the ViT decoders and Twins, the other tiny configs'
forward, the bicubic resize by a scale factor and the bridge at full
width against the JAX package, on the CPU (slow-marked: together they take
about a minute and a half in one process, beyond what the default run can
spare).

The tiny SETR-MLA, DPT, Segmenter and SVT configs of
``test_torch_port_vit_decoders.py`` (widths 8-32, without drop path and
dropout): one float32 step of ``make_train_step`` under the kvasir
schedule's SGD (lr 0.01, momentum 0.9, weight decay 5e-4, its StepLR at
one step an epoch), its train-mode decode logits at the slice tolerance
rtol 1e-3 / atol 3e-3 with the same hard predictions but at genuine ties,
the loss (1e-5), every parameter after the update (rtol 1e-4 / atol
1e-5), and every gradient within rtol 1e-4 / atol 1e-5 of the port's
float64 gradient and of JAX's, the latter widened by JAX's own distance
from the float64 gradient: in SVT's UPerHead the pooling pyramid's 1 x 1
branch batch-normalises two nearly equal values a channel, where the JAX
BatchNorm's one-pass float32 variance (``E[x²] - E[x]²``) cancels, so
that JAX's float32 gradients sit up to 6e-5 (5 % of a first-conv bias's
gradient) from float64 while the port's (two-pass) sit within 1e-6.
Under the bf16 policy, the train-mode forward: SETR-MLA's and SVT's at
the amp gates of ``PERF.md`` §2 (decode logits
within 2**-4 of the largest |logit| and 98 % equal argmax, the loss at
rtol 1e-2), DPT's and Segmenter's, whose bf16 rounding alone moves their
logits beyond that gate in both packages, within twice the larger
package's own bf16 distance, with the same argmax and loss gates.  The
JAX side of all four is one compiled program.  The other four tiny
configs (MLN, PCPVT, PoolFormer-FPN, PSPNet-v1d) through
``whole_inference`` at the slice tolerance with the same hard predictions
but at genuine ties, and the bridge both ways, in one compiled program.
``resize(scale_factor=)`` in the bicubic mode at 0.5, 2 and 4 and its
gradient against ``jax.vjp``.  The bridge maps the eight full-width
configs strictly on shapes alone (``jax.eval_shape`` against a port model
on the ``meta`` device).
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as flax_nn  # noqa: E402
from test_torch_port_vit_decoders import (  # noqa: E402
    RESIZE_INPUT, TINY, resize_grad, tiny_batch, tiny_network, tiny_twins)
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
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.utils.ops import \
    resize as jresize  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_name, jax_state_dict, layout_maps, mapped_state_dict)
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.mixed_precision import \
    policy_scope  # noqa: E402
from image_segmentation_lab_tpu_torch.models.backbones import (  # noqa: E402
    mit, vit)
from image_segmentation_lab_tpu_torch.models.basic import \
    LayerNorm  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.utils.ops import resize  # noqa: E402

pytestmark = pytest.mark.slow

TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_SHARE, ARGMAX_AGREE = 2.0 ** -4, 0.98
SCHEDULE = load_python_config("configs/schedule/kvasir_training_schedule.py")
STEPPED = ("setr/setr_mla_vit-s", "dpt/dpt_vit-s",
           "segmenter/segmenter_vit-s", "twins/twins_svt-s_upernet")


class Segmentors(flax_nn.Module):
    """The tiny segmentors of ``configs`` as submodules ``model<i>``: one
    variable tree and one compiled program; ``whole`` runs
    ``whole_inference``, else ``forward_train``."""

    configs: tuple = STEPPED

    @flax_nn.compact
    def __call__(self, imgs, gts, train=False, whole=False):
        out = {}
        for i, config in enumerate(self.configs):
            model = jax_build(tiny_network(config)).clone(parent=self,
                                                         name=f"model{i}")
            out[config] = (model.whole_inference(imgs[config], rescale=False)
                           if whole else
                           model.forward_train(imgs[config], gts[config],
                                               train=train))
        return out


@pytest.fixture(scope="module")
def steps():
    """The JAX side of every step: per config the float32 train-mode loss,
    decode logits and gradients, the parameters after one SGD update, and
    the bf16 policy's loss and decode logits; the variables."""
    imgs = {c: tiny_batch(c, seed=9)[0] for c in STEPPED}
    gts = {c: tiny_batch(c, seed=9)[1] for c in STEPPED}
    bundle = Segmentors()
    lr = jbuild_from_cfg(SCHEDULE["lr_config"], JLR).schedule(
        SCHEDULE["optimizer"]["lr"], 1)
    tx = jbuild_optimizer({**SCHEDULE["optimizer"], "lr": lr})
    with tiny_twins():
        variables = init_jax(bundle, imgs, gts)
        params = variables["params"]

        def loss_fn(params, policy):
            with jpolicy.policy_scope(policy):
                outs, _ = bundle.apply(
                    {**variables, "params": params}, imgs, gts, train=True,
                    rngs={"dropout": jax.random.PRNGKey(0)},
                    mutable=["batch_stats"])
            losses = {c: jtrain.parse_losses(outs[c][1])[0]
                      for c in STEPPED}
            return sum(losses.values()), (
                losses, {c: outs[c][0]["decode"] for c in STEPPED})

        def run(params):
            (_, f32), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, "fp32")
            updates, _ = tx.update(grads, tx.init(params), params)
            return (f32, grads, optax.apply_updates(params, updates),
                    loss_fn(params, "bf16")[1])

        out = compile_quickly(jax.jit(run), params)(params)
    return variables, jax.device_get(out)


def port_grads(model):
    """The port's gradients under their JAX names, in JAX layouts."""
    layout = layout_maps(model, to_jax=True)
    return {jax_name(name): layout.get(name, np.asarray)(p.grad.numpy())
            for name, p in model.named_parameters()}


def tiny_model(config, variables):
    name = f"model{STEPPED.index(config)}"
    with tiny_twins():
        return bridge(build_segmentor(tiny_network(config)),
                      {col: tree[name] for col, tree in variables.items()
                       if name in tree})


def attention_in_input_dtype(q, k, v, scale):
    """Plain attention with no float32 cast, for the float64 step."""
    scores = torch.einsum("nlhd,nshd->nhls", q, k) * scale
    return torch.einsum("nhls,nshd->nlhd", torch.softmax(scores, dim=-1), v)


def layer_norm_in_input_dtype(self, x):
    return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                        self.eps)


def float64_grads(config, variables, img, gt):
    """The port's gradients of the same train-mode loss in float64
    (attention and LayerNorm without their float32 casts), under their
    JAX names, in JAX layouts."""
    model = tiny_model(config, variables).double().train()
    with contextlib.ExitStack() as stack:
        for module in (vit, mit):
            stack.enter_context(mock.patch.object(
                module, "multihead_attention", attention_in_input_dtype))
        stack.enter_context(mock.patch.object(
            LayerNorm, "forward", layer_norm_in_input_dtype))
        stack.enter_context(torch.enable_grad())
        _, losses = model.forward_train(to_nchw(img).double(),
                                        torch.from_numpy(gt).long())
        train_state.parse_losses(losses)[0].backward()
    return {k: v.astype(np.float64) for k, v in port_grads(model).items()}


def assert_logit_parity(jax_logits, port_logits, rtol=1e-3, atol=3e-3):
    """Logits at the slice tolerance; a pixel whose class differs only at
    a genuine tie (JAX's top-2 gap below 2·atol), and at most 0.1 % of
    the pixels (one of a tiny batch's 8192 may tie)."""
    jl, pl = np.asarray(jax_logits), np.asarray(port_logits)
    np.testing.assert_allclose(pl, jl, rtol=rtol, atol=atol)
    mism = jl.argmax(-1) != pl.argmax(-1)
    if mism.any():
        srt = np.sort(jl[mism], axis=-1)
        gaps = srt[:, -1] - srt[:, -2]
        assert mism.mean() <= 1e-3 and gaps.max() < 2 * atol, (
            f"{mism.sum()} argmax mismatches, max top-2 gap {gaps.max()}")


@pytest.mark.parametrize("config", STEPPED)
def test_tiny_sgd_step_matches_jax(config, steps):
    variables, ((losses, logits), grads, params, _) = steps
    name = f"model{STEPPED.index(config)}"
    img, gt = tiny_batch(config, seed=9)
    model = tiny_model(config, variables)
    state = train_state.create_train_state(
        model, SCHEDULE["optimizer"], SCHEDULE["lr_config"])
    step = train_state.make_train_step(state.model, state.optimizer,
                                       state.scheduler)
    seen = []
    forward_train = model.forward_train

    def recorded(*args, **kwargs):
        out, loss_dict = forward_train(*args, **kwargs)
        seen.append(out["decode"].detach())
        return out, loss_dict

    model.forward_train = recorded
    log = step(to_nchw(img), torch.from_numpy(gt).long(),
               torch.Generator().manual_seed(0))
    size = TINY[config][4]
    assert seen[0].shape == (2, 2, size, size)
    assert_logit_parity(logits[config], to_nhwc(seen[0]))
    np.testing.assert_allclose(float(log["loss"]), float(losses[config]),
                               rtol=1e-5)
    ref_grads = state_dict_from_variables({"params": grads[name]})
    got = port_grads(model)
    truth = float64_grads(config, variables, img, gt)
    assert sorted(got) == sorted(ref_grads) == sorted(truth)
    for key, ref in ref_grads.items():
        np.testing.assert_allclose(got[key], truth[key], err_msg=key, **TOL)
        slack = np.abs(ref - truth[key])
        bound = TOL["atol"] + TOL["rtol"] * np.abs(ref) + slack
        assert (np.abs(got[key] - ref) <= bound).all(), (
            key, np.abs(got[key] - ref).max(), slack.max())
    ref_params = state_dict_from_variables({"params": params[name]})
    got = {k: v for k, v in jax_state_dict(model).items()
           if k in ref_params}
    assert sorted(got) == sorted(ref_params)
    for key, ref in ref_params.items():
        np.testing.assert_allclose(got[key], ref, err_msg=key, **TOL)


# the configs held to the amp gates; on the others the bf16 policy's own
# rounding moves the tiny models' logits (whose weights are unit-gain
# draws) beyond them in both packages alike: DPT's by 4.3 % of the largest
# |logit| (JAX) and 4.4 % (port) from their float32 logits, Segmenter's
# (a LayerNorm over its two class logits) by 31 % and 17 %; there the
# port's bf16 logits are held to twice the larger of the two packages'
# own bf16 distances, with the same argmax gate
AMP_GATED = ("setr/setr_mla_vit-s", "twins/twins_svt-s_upernet")


@pytest.mark.parametrize("config", STEPPED)
def test_tiny_bf16_forward_matches_jax(config, steps):
    """Train-mode ``forward_train`` under the bf16 policy from the same
    weights: the decode logits (bf16, but Segmenter's, which its head
    makes in float32 as the JAX head does) and the loss."""
    variables, ((_, logits32), _, _, (losses, logits)) = steps
    img, gt = tiny_batch(config, seed=9)
    dtype = (torch.float32 if config.startswith("segmenter")
             else torch.bfloat16)
    assert logits[config].dtype == jnp.dtype(str(dtype).split(".")[1])
    ref = np.asarray(jnp.asarray(logits[config]).astype(jnp.float32))
    model = tiny_model(config, variables).train()
    x, y = to_nchw(img), torch.from_numpy(gt).long()
    with torch.no_grad():
        out32 = to_nhwc(model.forward_train(x, y)[0]["decode"])
        with policy_scope("bf16"):
            out, loss_dict = model.forward_train(x, y)
            loss, _ = train_state.parse_losses(loss_dict)
    assert out["decode"].dtype == dtype
    out = to_nhwc(out["decode"].float())
    scale = np.abs(ref).max()
    if config in AMP_GATED:
        bound = LOGIT_SHARE * scale
    else:
        bound = 2 * max(np.abs(ref - np.asarray(logits32[config])).max(),
                        np.abs(out - out32).max())
    assert np.abs(out - ref).max() <= bound
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= ARGMAX_AGREE
    np.testing.assert_allclose(float(loss), float(losses[config]),
                               rtol=1e-2)


UNSTEPPED = tuple(sorted(set(TINY) - set(STEPPED)))


@pytest.fixture(scope="module")
def whole_references():
    """The JAX logits of the unstepped tiny configs, and the variables."""
    imgs = {c: tiny_batch(c)[0] for c in UNSTEPPED}
    gts = {c: tiny_batch(c)[1] for c in UNSTEPPED}
    bundle = Segmentors(UNSTEPPED)
    with tiny_twins():
        variables = init_jax(bundle, imgs, gts)
        fn = compile_quickly(jax.jit(lambda v, x: bundle.apply(
            v, x, gts, whole=True)), variables, imgs)
        return variables, jax.device_get(fn(variables, imgs))


@pytest.mark.parametrize("config", UNSTEPPED)
def test_tiny_config_whole_inference_matches_jax(config, whole_references):
    """The configs whose step is not held above: ``whole_inference`` at the
    slice tolerance, and the bridge both ways (the state written back
    under the JAX names and layouts)."""
    variables, outputs = whole_references
    name = f"model{UNSTEPPED.index(config)}"
    variables = {col: tree[name] for col, tree in variables.items()}
    size = TINY[config][4]
    with tiny_twins():
        pm = bridge(build_segmentor(tiny_network(config)), variables)
    with torch.no_grad():
        out = pm.whole_inference(to_nchw(tiny_batch(config)[0]),
                                 rescale=False)
    assert out.shape == (2, 2, size, size)
    assert_argmax_parity(np.asarray(outputs[config]), to_nhwc(out))
    got = jax_state_dict(pm)
    want = state_dict_from_variables(variables)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("scale", [0.5, 2, 4])
def test_resize_bicubic_scale_factor_matches_jax(scale):
    """The bicubic rule with a user scale (no config takes it): the JAX
    resize and its ``jax.vjp`` at rtol 1e-5 / atol 2e-5."""
    x = RESIZE_INPUT

    def fn(x):
        return jresize(x, scale_factor=scale, mode="bicubic",
                       align_corners=False, warning=False)

    def both(x):
        out, vjp = jax.vjp(fn, x)
        return out, vjp(jnp.asarray(resize_grad(scale)))[0]

    ref, gref = compile_quickly(jax.jit(both), x)(x)
    t = to_nchw(x).requires_grad_(True)
    with torch.enable_grad():
        out = resize(t, scale_factor=scale, mode="bicubic",
                     align_corners=False, warning=False)
        out.backward(to_nchw(resize_grad(scale)))
    tol = dict(rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(to_nhwc(out.detach()), np.asarray(ref), **tol)
    np.testing.assert_allclose(to_nhwc(t.grad), np.asarray(gref), **tol)


@pytest.mark.parametrize("config", sorted(TINY))
def test_bridge_maps_the_full_size_configs_strictly(config):
    """Every JAX leaf of the full-width config maps to a port tensor of
    the mapped shape and no port tensor is left over, on shapes alone: the
    JAX variables from ``jax.eval_shape`` as zero-stride arrays, the port
    model on the ``meta`` device."""
    network = load_python_config(f"configs/network/{config}.py")["model"]

    def heads(segmentor, img):
        feats = segmentor.extract_feat(img)
        aux = segmentor.aux_head_modules
        return (segmentor.decode_head_module(feats),
                None if aux is None else aux(feats))

    shapes = jax.eval_shape(lambda: jax_build(network).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), method=heads))
    leaves = state_dict_from_variables(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes))
    with torch.device("meta"):
        model = build_segmentor(network)
    mapped = mapped_state_dict(model, leaves)
    assert len(mapped) == len(leaves)
    assert sum(a.size for a in mapped.values()) > 15_000_000
