"""The SegFormer (MiT) slice and the pyramid heads against the JAX package,
on the CPU.

Single modules (``EfficientMultiheadAttention`` at sr 1 and 2, and in
training with attention dropout on one mask drawn for both, ``MixFFN``,
one encoder layer, ``MixVisionTransformer``, ``SegFormerHead``, ``PPM``,
``PSPHead``, ``UPerHead``) at widths 8-32 on maps of at most 64²: rtol
1e-4 / atol 1e-5 (float32 sums in other orders).  ``adaptive_avg_pool2d``
at uneven bins: bit for bit, float32 and bf16, on values whose bin sums
are exact in float32 (so the free summation order cannot show), and within
2 float32 ulps of 1 on unit normals.  The whole tiny SegFormer
(``configs/network/segformer/segformer_mit_tiny_synthetic.py``, head dim 8)
at the slice tolerance rtol 1e-3 / atol 3e-3 with the same hard
predictions but at genuine ties; one float32 step of ``make_train_step``
under the SegFormer schedule's AdamW and ``WarmScheduler``: the loss
(1e-5), every gradient and every parameter after the update (rtol 1e-4 /
atol 1e-5).  Under the bf16 policy, the amp gates of ``PERF.md`` §2:
logits within 2**-4 of the largest |logit| and 98 % equal argmax, the loss
at rtol 1e-2 and each gradient within 0.25 relative (Frobenius) norm of
JAX's bf16 gradient.  The JAX side runs its CPU einsum attention.  The
bridge maps every config of the slice at full width strictly, on shapes
alone (``jax.eval_shape`` against a port model on the ``meta`` device).
"""

import contextlib
from unittest import mock

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
from image_segmentation_lab_tpu.models.backbones import mit as jmit  # noqa: E402,E501
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import (  # noqa: E402
    psp_head as jpsp, segformer_head as jsegformer, uper_head as juper)
from image_segmentation_lab_tpu.ops.pooling import \
    adaptive_avg_pool2d as jpool  # noqa: E402
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
    BACKBONE, DECODEHEAD)
from image_segmentation_lab_tpu_torch.models.backbones import mit  # noqa: E402,E501
from image_segmentation_lab_tpu_torch.models.basic import \
    drop as port_drop  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import (  # noqa: E402,E501
    PPM, PSPHead, SegFormerHead, UPerHead)
from image_segmentation_lab_tpu_torch.ops.pooling import \
    adaptive_avg_pool2d  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_SHARE, ARGMAX_AGREE, GRAD_SHARE = 2.0 ** -4, 0.98, 0.25
TINY = "configs/network/segformer/segformer_mit_tiny_synthetic.py"
SCHEDULE = load_python_config("configs/schedule/segformer_schedule.py")
BN = dict(type="SyncBN", requires_grad=True)
IGNORE = 255


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def tokens(x):
    """An NHWC array as port tokens ``(N, H·W, C)`` and its ``(H, W)``."""
    n, h, w, c = x.shape
    return torch.from_numpy(x.reshape(n, h * w, c)), (h, w)


# ------------------------------------------------------------- pooling
@pytest.mark.parametrize("hw,out", [((80, 80), 6), ((20, 20), 3),
                                    ((3, 5), 6), ((80, 80), 2),
                                    ((7, 9), 1)])
def test_adaptive_avg_pool2d_is_the_jax_rule_bit_for_bit(hw, out):
    """Uneven bins (80/6 and 20/3 are PSP's and UPerNet's at 640²; 3 -> 6
    has more bins than inputs), uniform bins (80/2, whose count 1600 has
    an inexact reciprocal) and 1 x 1, in float32 and bf16, against the JAX
    function under ``jax.jit`` as its models run it (each bin's sum times
    the reciprocal of its count): on multiples of 2**-6 below 8 every bin
    sum is exact in float32, so both packages give the same bits; on unit
    normals float32 sums in other orders stay within 2 ulps of the inputs'
    scale (1), and bf16 rounds them to the same bits."""
    rng = np.random.RandomState(0)
    grid = rng.randint(-512, 512, (1, 2, *hw)).astype(np.float32) / 64
    normal = rng.randn(1, 2, *hw).astype(np.float32)
    x = np.concatenate([grid, normal])  # one sample each
    nhwc = np.transpose(x, (0, 2, 3, 1))
    refs = compile_quickly(jax.jit(lambda x: [
        jpool(x.astype(dtype), out).astype(jnp.float32)
        for dtype in (jnp.float32, jnp.bfloat16)]), nhwc)(nhwc)
    for dtype, ref in zip((torch.float32, torch.bfloat16), refs):
        got = adaptive_avg_pool2d(torch.from_numpy(x).to(dtype), out)
        assert got.dtype == dtype
        ref = np.transpose(np.asarray(ref), (0, 3, 1, 2))
        got = got.float().numpy()
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=2 ** -22)


def test_adaptive_avg_pool2d_backward_is_torchs():
    """The gradient spreads each output's gradient evenly over its
    (overlapping) bin, as ``F.adaptive_avg_pool2d``'s backward does."""
    x = torch.randn(2, 3, 13, 11, requires_grad=True)  # bins of 4-5 rows
    g = torch.randn(2, 3, 3, 4)
    with torch.enable_grad():
        (got,) = torch.autograd.grad(
            (adaptive_avg_pool2d(x, (3, 4)) * g).sum(), x)
        (ref,) = torch.autograd.grad(
            (torch.nn.functional.adaptive_avg_pool2d(x, (3, 4)) * g).sum(),
            x)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- modules
MIT = dict(embed_dims=8, num_stages=3, num_layers=(1, 2, 1),
           num_heads=(1, 2, 4), patch_sizes=(7, 3, 3), strides=(4, 2, 2),
           sr_ratios=(4, 2, 1), out_indices=(0, 2), mlp_ratio=2)
HEAD = dict(channels=8, num_classes=2, norm_cfg=BN)
MULTIPLE = dict(input_transform="multiple_select")
PPM_ARGS = ((1, 2, 3, 6), 12, 8)
PPM_KW = dict(norm_cfg=BN, act_cfg=dict(type="ReLU"))
# name: (JAX module, port module, input shapes (NHWC); one shape is one
# map, a list is a head's inputs).  Attention at sr 1 and 2 (and at sr 2
# in training with attention-probability dropout, both packages drawing
# the mask of ``fixed_keep_mask``), the FFN and a layer take tokens; MiT runs three stages on 64² (16², 8², 4² maps, taps
# 0 and 2); the heads run in eval mode (BatchNorm on running statistics)
# with pooled maps at uneven bins (10/3, 10/6, 13/6, 5/3, 3 -> 6)
MODULES = {
    "attn_sr1": (lambda: jmit.EfficientMultiheadAttention(16, 2),
                 lambda: mit.EfficientMultiheadAttention(16, 2), (2, 8, 8, 16)),
    "attn_sr2": (lambda: jmit.EfficientMultiheadAttention(32, 2, sr_ratio=2),
                 lambda: mit.EfficientMultiheadAttention(32, 2, sr_ratio=2),
                 (2, 8, 10, 32)),
    "attn_drop": (
        lambda: jmit.EfficientMultiheadAttention(16, 2, sr_ratio=2,
                                                 attn_drop_rate=0.5),
        lambda: mit.EfficientMultiheadAttention(16, 2, sr_ratio=2,
                                                attn_drop_rate=0.5),
        (2, 8, 8, 16)),
    "ffn": (lambda: jmit.MixFFN(16, 32), lambda: mit.MixFFN(16, 32),
            (2, 6, 7, 16)),
    "layer": (lambda: jmit.TransformerEncoderLayer(16, 2, 64, sr_ratio=2),
              lambda: mit.TransformerEncoderLayer(16, 2, 64, sr_ratio=2),
              (2, 8, 8, 16)),
    "mit": (lambda: jmit.MixVisionTransformer(**MIT),
            lambda: mit.MixVisionTransformer(**MIT), (2, 64, 64, 3)),
    "segformer_head": (
        lambda: jsegformer.SegFormerHead(
            in_channels=[8, 16, 24], in_index=(0, 1, 2), **MULTIPLE, **HEAD),
        lambda: SegFormerHead(in_channels=[8, 16, 24], in_index=(0, 1, 2),
                              **MULTIPLE, **HEAD),
        [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 24)]),
    "ppm": (lambda: jpsp.PPM(*PPM_ARGS, **PPM_KW),
            lambda: PPM(*PPM_ARGS, **PPM_KW), (2, 13, 10, 12)),
    "psp_head": (lambda: jpsp.PSPHead(in_channels=16, in_index=1, **HEAD),
                 lambda: PSPHead(in_channels=16, in_index=1, **HEAD),
                 [(2, 8, 8, 4), (2, 10, 10, 16)]),
    "uper_head": (
        lambda: juper.UPerHead(in_channels=[8, 16, 24, 32],
                               in_index=(0, 1, 2, 3), **MULTIPLE, **HEAD),
        lambda: UPerHead(in_channels=[8, 16, 24, 32], in_index=(0, 1, 2, 3),
                         **MULTIPLE, **HEAD),
        [(2, 20, 20, 8), (2, 10, 10, 16), (2, 5, 5, 24), (2, 3, 3, 32)]),
}


TRAIN = ("attn_drop",)
TOKENS = ("attn_sr1", "attn_sr2", "attn_drop", "ffn", "layer")


def fixed_keep_mask(shape, keep):
    """One Bernoulli(``keep``) draw of ``shape`` from a numpy seed."""
    return np.random.RandomState(5).rand(*shape) < keep


def same_dropout_masks():
    """Both packages' dropout draws replaced by ``fixed_keep_mask``."""
    return (mock.patch.object(jax.random, "bernoulli",
                              lambda key, keep, shape: jnp.asarray(
                                  fixed_keep_mask(shape, keep))),
            mock.patch.object(port_drop, "keep_mask",
                              lambda shape, keep, like: torch.from_numpy(
                                  fixed_keep_mask(tuple(shape), keep)).to(
                                  like.dtype)))


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
        return {name: MODULES[name][0]().clone(parent=self, name=name)(
                    x, **({"train": True} if name in TRAIN else {}))
                for name, x in inputs.items()}


@pytest.fixture(scope="module")
def references():
    """The JAX outputs of every module, and the variables."""
    inputs = {name: module_inputs(name) for name in MODULES}
    bundle = Bundle()
    rngs = {"dropout": jax.random.PRNGKey(0)}
    with contextlib.ExitStack() as stack:
        for patch in same_dropout_masks():
            stack.enter_context(patch)
        variables = init_jax(bundle, inputs)
        fn = compile_quickly(jax.jit(lambda v, x: bundle.apply(
            v, x, rngs=rngs)), variables, inputs)
    return variables, jax.device_get(fn(variables, inputs))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, references):
    variables, outputs = references
    port = MODULES[name][1]()
    bridge(port, {col: tree[name] for col, tree in variables.items()
                  if name in tree})
    x = module_inputs(name)
    with torch.no_grad(), contextlib.ExitStack() as stack:
        if name in TRAIN:
            port.train()
            for patch in same_dropout_masks():
                stack.enter_context(patch)
        if name in TOKENS:
            outs = [port(*tokens(x))]
            refs = [outputs[name].reshape(outs[0].shape)]
        else:
            outs = port([to_nchw(t) for t in x] if isinstance(x, list)
                        else to_nchw(x))
            refs = outputs[name]
            if isinstance(outs, torch.Tensor):
                outs, refs = [outs], [refs]
            outs = [to_nhwc(o) for o in outs]
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    if name == "mit":
        assert [o.shape for o in outs] == [(2, 16, 16, 8), (2, 4, 4, 32)]


def test_unported_mit_features_raise():
    for kw in (dict(frozen_stages=1), dict(with_cp=True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            mit.MixVisionTransformer(**MIT, **kw)


def test_init_has_the_jax_distributions():
    """One stage of width 32 on 32²: the pointwise projections truncated
    normal (std 0.02), the real convs (patch embedding, sr, depthwise)
    kaiming normal (fan_out), zero biases, unit LayerNorms; each tensor's
    std within 3 standard errors of the JAX module's own init."""
    kw = dict(embed_dims=16, num_stages=1, num_layers=(1,), num_heads=(2,),
              patch_sizes=(7,), strides=(4,), sr_ratios=(2,),
              out_indices=(0,))
    jm, pm = jmit.MixVisionTransformer(**kw), mit.MixVisionTransformer(**kw)
    args = (jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    ref = state_dict_from_variables(
        compile_quickly(jax.jit(jm.init), *args)(*args))
    init_weights(pm, torch.Generator().manual_seed(0))
    got = jax_state_dict(pm)
    assert sorted(got) == sorted(ref)
    for key, a in got.items():
        b = ref[key]
        if key.endswith("bias") or b.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        assert abs(a.std() - b.std()) <= 3 * np.sqrt(2 / a.size) * b.std(), \
            key
    assert abs(got["stage1_block1.attn.q.weight"].std() - 0.02) < 0.005


def test_registries():
    assert BACKBONE.get("MiT") is BACKBONE.get("MixVisionTransformer") \
        is mit.MixVisionTransformer
    for head in (SegFormerHead, PSPHead, UPerHead):
        assert DECODEHEAD.get(head.__name__) is head


# ------------------------------------------------------------- the slice
def batch(n=2, size=64, seed=7):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, size, size, 3).astype(np.float32)
    gt = rng.randint(0, 2, (n, size, size)).astype(np.int32)
    gt[rng.rand(n, size, size) < 0.1] = IGNORE
    return img, gt


@pytest.fixture(scope="module")
def tiny():
    network = load_python_config(TINY)["model"]
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64), jnp.int32),
                         method="forward_train", train=False)
    return network, jm, variables


def test_tiny_segformer_whole_inference_matches_jax(tiny):
    network, jm, variables = tiny
    x, _ = batch(seed=3)
    ref = compile_quickly(jax.jit(lambda v, x: jm.apply(
        v, x, method="whole_inference", rescale=False)), variables,
        x)(variables, x)
    pm = bridge(build_segmentor(network), variables)
    with torch.no_grad():
        out = pm.whole_inference(to_nchw(x), rescale=False)
    assert out.shape == (2, 2, 64, 64)
    assert_argmax_parity(np.asarray(ref), to_nhwc(out))


def capturing(tx):
    """``tx`` whose state also holds the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def bf16_loss(jm, variables, img, gt):
    """Train-mode ``forward_train`` under the bf16 policy: the loss and the
    decode logits as a function of the parameters."""
    def loss_fn(params):
        with jpolicy.policy_scope("bf16"):
            (logits, losses), _ = jm.apply(
                {**variables, "params": params}, img, gt,
                method="forward_train", train=True,
                rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return jtrain.parse_losses(losses)[0], logits["decode"]
    return loss_fn


@pytest.fixture(scope="module")
def jax_steps(tiny):
    """The JAX side of both step tests in one program: one float32 train
    step under the SegFormer schedule (AdamW, its ``WarmScheduler`` at one
    step an epoch) on ``batch(seed=9)``: the log, the variables after it
    and the gradients (a state dict); the bf16 policy's loss, decode
    logits and gradients (no optimizer) on ``batch(seed=4)``."""
    _, jm, variables = tiny
    schedule = jbuild_from_cfg(SCHEDULE["lr_config"], JLR).schedule(
        SCHEDULE["optimizer"]["lr"], 1)
    tx = capturing(jbuild_optimizer({**SCHEDULE["optimizer"],
                                     "lr": schedule}))
    params = variables["params"]
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              frozen_params={},
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(params))
    train_step = jtrain.make_train_step(jm, tx, donate=False)
    (img, gt), (img16, gt16) = batch(seed=9), batch(seed=4)

    def both(state, params):
        return (train_step(state, img, gt, jax.random.PRNGKey(0)),
                jax.value_and_grad(bf16_loss(jm, variables, img16, gt16),
                                   has_aux=True)(params))

    (state, log), bf16 = compile_quickly(jax.jit(both), state, params)(
        state, params)
    grads = state_dict_from_variables({"params": state.opt_state[1]})
    return (log, state.variables(), grads), bf16


def port_grads(model):
    """The port's gradients under their JAX names, in JAX layouts."""
    layout = layout_maps(model, to_jax=True)
    return {jax_name(name): layout.get(name, np.asarray)(p.grad.numpy())
            for name, p in model.named_parameters()}


def test_tiny_segformer_adamw_step_matches_jax(tiny, jax_steps):
    network, _, variables = tiny
    img, gt = batch(seed=9)
    jlog, jvars, jgrads = jax_steps[0]
    model = bridge(build_segmentor(network), variables)
    state = train_state.create_train_state(
        model, SCHEDULE["optimizer"], SCHEDULE["lr_config"])
    step = train_state.make_train_step(state.model, state.optimizer,
                                       state.scheduler)
    log = step(to_nchw(img), torch.from_numpy(gt).long(),
               torch.Generator().manual_seed(0))
    for key, ref in jlog.items():
        tol = dict(rtol=1e-6, atol=0) if "acc" in key else dict(rtol=1e-5,
                                                                atol=1e-5)
        np.testing.assert_allclose(float(log[key]), float(ref), err_msg=key,
                                   **tol)
    grads = port_grads(model)
    assert sorted(grads) == sorted(jgrads)
    for key, ref in jgrads.items():
        np.testing.assert_allclose(grads[key], ref, err_msg=key, **TOL)
    ref_state = state_dict_from_variables(jvars)
    got = jax_state_dict(model)
    assert sorted(got) == sorted(ref_state)
    for key, ref in ref_state.items():
        np.testing.assert_allclose(got[key], ref, err_msg=key, **TOL)
    assert model.decode_head.fusion_conv.bn.num_batches_tracked == 1


# the last stage norm's bias reaches the loss only through a 1x1 conv into
# a train-mode BatchNorm, which takes out a per-channel constant: its
# gradient is 0 in exact arithmetic, and in either package's bf16 step a
# rounding residue (about 1e-3 of the largest gradient), which is held to
# one bf16 rounding step of the largest gradient instead
EXACT_ZERO = ("backbone.norm2.bias",)


def test_tiny_segformer_bf16_forward_and_step_match_jax(tiny, jax_steps):
    """Train-mode ``forward_train`` and its gradients under the bf16
    policy, from the same weights (no optimizer)."""
    network, _, variables = tiny
    img, gt = batch(seed=4)
    (jloss, ref), jgrads = jax_steps[1]
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    jgrads = state_dict_from_variables({"params": jgrads})

    model = bridge(build_segmentor(network), variables).train()
    with torch.enable_grad(), policy_scope("bf16"):
        logits, losses = model.forward_train(to_nchw(img),
                                             torch.from_numpy(gt).long())
        loss, _ = train_state.parse_losses(losses)
        loss.backward()
    assert logits["decode"].dtype == torch.bfloat16
    out = to_nhwc(logits["decode"].detach().float())
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= LOGIT_SHARE * scale
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= ARGMAX_AGREE
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)
    grads = port_grads(model)
    assert sorted(grads) == sorted(jgrads)
    largest = max(np.abs(g).max() for g in jgrads.values())
    for key, ref in jgrads.items():
        if key in EXACT_ZERO:
            assert np.abs(grads[key]).max() <= 2.0 ** -8 * largest, key
            continue
        dist = np.linalg.norm(grads[key] - ref) / np.linalg.norm(ref)
        assert dist <= GRAD_SHARE, (key, dist)


# ------------------------------------------------------------- the bridge
FULL_SIZE = ["segformer/segformer_mit-b2", "upernet/upernet_mit-b0",
             "upernet/upernet_r50", "pspnet/pspnet_r50-d8"]


@pytest.mark.parametrize("config", FULL_SIZE)
def test_bridge_maps_the_full_size_configs_strictly(config):
    """Every JAX leaf of the full-width config maps to a port tensor of
    the mapped shape and no port tensor is left over, on shapes alone: the
    JAX variables from ``jax.eval_shape`` as zero-stride arrays, the port
    model on the ``meta`` device."""
    network = load_python_config(f"configs/network/{config}.py")["model"]

    def heads(segmentor, img):
        """Every submodule's forward, and nothing else (no losses)."""
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
    assert sum(a.size for a in mapped.values()) > 3_000_000
