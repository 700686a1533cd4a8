"""The non-local decode-head family and DeepLabV3+'s separable ASPP against
the JAX package, on the CPU.

Each of the slice's modules at widths 8-32 on 6²-12² maps (ANN's on 24²,
where its pools of 1, 3, 6 and 8 have whole bins), batch 2, from
seeded numpy inputs and weights (``torch_port_helpers.init_jax``): the
``DepthwiseSeparableConvModule``, ``DepthwiseSeparableASPPHead``,
``NonLocal2d`` (``embedded_gaussian`` with ``sub_sample`` and a bare
``conv_out``; ``dot_product`` with a normed one), ``NLHead``, ``DNLHead``,
``GCHead``, ``CCHead`` (a non-square map), ``DAHead`` (its three logits
and, in training, its ``pam.``/``cam.`` losses), ``SelfAttentionBlock``
(query max-pool, pyramid-pooled keys, normed two-conv projections,
``out_project``), ``ANNHead``, ``ISAHead`` (a 10 x 11 map padded to 12²),
``EMAHead`` (and its updated ``bases``) and ``PSAHead`` (a 9² map, whose
shrink flips ``align_corners``, with a 7 x 7 mask that misses taps).

Per module one compiled JAX program (``compile_quickly``) gives three
cases: eval mode (the heads' call) at rtol 1e-4 / atol 1e-5; train mode
(batch statistics, the updated ``batch_stats``, the heads'
``forward_train`` losses) against the JAX package's own rule run in
float64 (a second program, ``torch_port_helpers.jax_in_float64``); and
the eval forward under the bf16 policy at the amp gate of ``PERF.md`` §2
(within 2**-4 of the largest |output|, the heads' argmax 98 % equal),
where every score product of the port runs in float32 on the bf16
operands.

The tiny whole-model steps, the float64 checks and the full-width bridges
are slow-marked, in ``test_torch_port_nonlocal_steps.py``.
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (as_float64, bridge,  # noqa: E402
                                compile_quickly, init_jax, jax_in_float64,
                                to_nchw, to_nhwc)

from image_segmentation_lab_tpu.core.initialize.checkpoint import \
    state_dict_from_variables  # noqa: E402
from image_segmentation_lab_tpu.core.mixed_precision import \
    policy as jpolicy  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import (  # noqa: E402
    ann_head as jann, cc_head as jcc, da_head as jda, dnl_head as jdnl,
    ema_head as jema, gc_head as jgc, isa_head as jisa, nl_head as jnl,
    psa_head as jpsa, sep_aspp_head as jsep)
from image_segmentation_lab_tpu.models.utils import (  # noqa: E402
    depthwise_separable_conv_module as jdsconv, non_local as jnon_local,
    self_attention_block as jsab)
from image_segmentation_lab_tpu.ops.pooling import \
    max_pool2d as jmax_pool2d  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_name, jax_state_dict)
from image_segmentation_lab_tpu_torch.core.registry_hub import \
    DECODEHEAD  # noqa: E402
from image_segmentation_lab_tpu_torch.models.basic import \
    LayerNorm  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import (  # noqa: E402,E501
    ann_head, aspp_head, cc_head, da_head, dnl_head, ema_head, gc_head,
    isa_head, nl_head, psa_head, sep_aspp_head)
from image_segmentation_lab_tpu_torch.models.utils import (  # noqa: E402
    depthwise_separable_conv_module as dsconv, non_local,
    self_attention_block as sab)
from image_segmentation_lab_tpu_torch.ops.pooling import \
    max_pool2d  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
OUT_SHARE, ARGMAX_AGREE = 2.0 ** -4, 0.98
BN = dict(type="SyncBN", requires_grad=True)
HEAD = dict(in_channels=32, channels=16, num_classes=3, norm_cfg=BN,
            dropout_ratio=0.0)
LABEL_SIZE = (2, 16, 16)
SAB = dict(key_in_channels=16, query_in_channels=24, channels=8,
           out_channels=12, key_query_num_convs=2, key_query_norm=True,
           value_out_norm=True, matmul_norm=True, with_out=True,
           norm_cfg=BN, act_cfg=dict(type="ReLU"))
ANN = dict(HEAD, in_channels=[16, 32], in_index=[0, 1],
           input_transform="multiple_select", project_channels=8)
SEP_ASPP = dict(HEAD, in_index=3, dilations=(1, 2, 3), c1_in_channels=8,
                c1_channels=4)


def jax_sab():
    return jsab.SelfAttentionBlock(
        query_downsample=lambda x: jmax_pool2d(x, 2, 2),
        key_downsample=jann.PPMConcat((1, 2, 3)), **SAB)


def port_sab():
    return sab.SelfAttentionBlock(
        query_downsample=lambda x: max_pool2d(x, 2, 2),
        key_downsample=ann_head.PPMConcat((1, 2, 3)), **SAB)


# name: (JAX module, port module, input shapes (NHWC), a head, the modules
# of the port whose float32 scores the bf16 case checks)
MODULES = {
    "depthwise_separable_conv": (
        lambda: jdsconv.DepthwiseSeparableConvModule(
            16, 24, 3, padding=2, dilation=2, norm_cfg=BN),
        lambda: dsconv.DepthwiseSeparableConvModule(
            16, 24, 3, padding=2, dilation=2, norm_cfg=BN),
        [(2, 10, 10, 16)], False, ()),
    "sep_aspp_head": (
        lambda: jsep.DepthwiseSeparableASPPHead(**SEP_ASPP),
        lambda: sep_aspp_head.DepthwiseSeparableASPPHead(**SEP_ASPP),
        [(2, 12, 12, 8), (2, 6, 6, 8), (2, 6, 6, 16), (2, 6, 6, 32)], True,
        ()),
    "non_local": (lambda: jnon_local.NonLocal2d(16, sub_sample=True),
                  lambda: non_local.NonLocal2d(16, sub_sample=True),
                  [(2, 8, 8, 16)], False, (non_local,)),
    "non_local_dot_product": (
        lambda: jnon_local.NonLocal2d(16, mode="dot_product", norm_cfg=BN),
        lambda: non_local.NonLocal2d(16, mode="dot_product", norm_cfg=BN),
        [(2, 9, 7, 16)], False, (non_local,)),
    "nl_head": (lambda: jnl.NLHead(**HEAD), lambda: nl_head.NLHead(**HEAD),
                [(2, 8, 8, 32)], True, (non_local,)),
    "dnl_head": (lambda: jdnl.DNLHead(**HEAD),
                 lambda: dnl_head.DNLHead(**HEAD), [(2, 8, 8, 32)], True,
                 (dnl_head,)),
    "gc_head": (lambda: jgc.GCHead(**HEAD), lambda: gc_head.GCHead(**HEAD),
                [(2, 8, 8, 32)], True, ()),
    "cc_head": (lambda: jcc.CCHead(**HEAD), lambda: cc_head.CCHead(**HEAD),
                [(2, 7, 10, 32)], True, (cc_head,)),
    "da_head": (lambda: jda.DAHead(pam_channels=4, **HEAD),
                lambda: da_head.DAHead(pam_channels=4, **HEAD),
                [(2, 8, 8, 32)], True, (da_head,)),
    "self_attention_block": (jax_sab, port_sab,
                             [(2, 8, 8, 24), (2, 6, 6, 16)], False, (sab,)),
    "ann_head": (lambda: jann.ANNHead(**ANN), lambda: ann_head.ANNHead(**ANN),
                 [(2, 24, 24, 16), (2, 24, 24, 32)], True, (sab,)),
    "isa_head": (lambda: jisa.ISAHead(isa_channels=8, down_factor=(4, 4),
                                      **HEAD),
                 lambda: isa_head.ISAHead(isa_channels=8, down_factor=(4, 4),
                                          **HEAD),
                 [(2, 10, 11, 32)], True, (sab,)),
    "ema_head": (lambda: jema.EMAHead(ema_channels=24, num_bases=8, **HEAD),
                 lambda: ema_head.EMAHead(ema_channels=24, num_bases=8,
                                          **HEAD),
                 [(2, 8, 8, 32)], True, ()),
    "psa_head": (lambda: jpsa.PSAHead(mask_size=(7, 7), **HEAD),
                 lambda: psa_head.PSAHead(mask_size=(7, 7), **HEAD),
                 [(2, 9, 9, 32)], True, (psa_head,)),
}
MODES = ("eval", "train", "bf16")


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def module_inputs(name):
    return [rand(*s, seed=10 + i) for i, s in enumerate(MODULES[name][2])]


def head_label(seed=7):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 3, LABEL_SIZE).astype(np.int32)
    gt[rng.rand(*LABEL_SIZE) < 0.1] = 255
    return gt


def jax_call(module, name, xs, train):
    """A head's call on its input list (``forward_train`` in training),
    another module's on its arguments."""
    if not MODULES[name][3]:
        return module(*xs, train=train)
    if train:
        return module.forward_train(list(xs), jnp.asarray(head_label()),
                                    train=True)
    return module(list(xs), train=False)


@functools.lru_cache(maxsize=None)
def references(name):
    """The JAX variables of ``name`` and its eval and bf16-policy eval
    outputs, from one program."""
    module = MODULES[name][0]()
    xs = module_inputs(name)
    variables = init_jax(module, xs if MODULES[name][3] else xs[0],
                         *([] if MODULES[name][3] else xs[1:]))

    def run(variables, xs):
        def call():
            return module.apply(variables, xs, method=lambda m, xs: jax_call(
                m, name, xs, False))

        with jpolicy.policy_scope("bf16"):
            bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                          call())
        return dict(eval=call(), bf16=bf16)

    fn = compile_quickly(jax.jit(run), variables, xs)
    return variables, jax.device_get(fn(variables, xs))


def port_module(name):
    variables, _ = references(name)
    return bridge(MODULES[name][1](), variables)


def port_call(module, name, xs):
    if not MODULES[name][3]:
        return module(*xs)
    if module.training:
        return module.forward_train(xs, torch.from_numpy(head_label()).long())
    return module(xs)


@contextlib.contextmanager
def recorded_scores(modules, seen):
    """Appends the dtypes of every ``float32_product`` in ``modules``."""
    with contextlib.ExitStack() as stack:
        for module in modules:
            real = module.float32_product

            def recorded(a, b, real=real):
                out = real(a, b)
                seen.append((a.dtype, b.dtype, out.dtype))
                return out

            stack.enter_context(mock.patch.object(module, "float32_product",
                                                  recorded))
        yield


def assert_close_tree(got, want, **tol):
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


def nhwc_outputs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(to_nhwc(o.float()) for o in outs)


def train_outputs(name, dtype):
    """The port's train-mode outputs (a head's logits and losses) and
    updated buffers, under JAX names, as float64 numpy arrays."""
    port = port_module(name).to(dtype).train()
    xs = [to_nchw(x).to(dtype) for x in module_inputs(name)]
    with torch.no_grad(), mock.patch.object(
            LayerNorm, "forward", lambda self, x: F.layer_norm(
                x, self.normalized_shape, self.weight, self.bias, self.eps)):
        out = port_call(port, name, xs)
    if MODULES[name][3]:
        logits, losses = out
        got = {f"loss {k}": v.double().numpy() for k, v in losses.items()}
        out = (logits,)
    else:
        got = {}
    got.update({f"out {i}": o.astype(np.float64)
                for i, o in enumerate(nhwc_outputs(out))})
    buffers = {jax_name(b) for b, _ in port.named_buffers()}
    got.update({k: v.astype(np.float64)
                for k, v in jax_state_dict(port).items() if k in buffers})
    return got


@functools.lru_cache(maxsize=None)
def train_reference(name):
    """The JAX train call of ``name`` on the same variables and inputs,
    run in float64 (``jax_in_float64``): its outputs, the heads' losses
    and the updated ``batch_stats`` under the names of
    ``train_outputs``."""
    module = MODULES[name][0]()
    variables = as_float64(references(name)[0])
    xs = as_float64(module_inputs(name))

    def run(variables, xs):
        return module.apply(variables, xs, method=lambda m, xs: jax_call(
            m, name, xs, True), mutable=["batch_stats"])

    with jax_in_float64():
        fn = compile_quickly(jax.jit(run), variables, xs)
        ref_out, new_state = jax.device_get(fn(variables, xs))
    if MODULES[name][3]:
        ref_logits, ref_losses = ref_out
        ref = {f"loss {k}": np.asarray(v) for k, v in ref_losses.items()}
        ref_out = (ref_logits,)
    else:
        ref = {}
    ref.update({f"out {i}": np.asarray(o) for i, o in enumerate(
        jax.tree_util.tree_leaves(ref_out))})
    ref.update(state_dict_from_variables(new_state))
    return ref


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, mode):
    """Eval mode at rtol 1e-4 / atol 1e-5.  Train mode (the outputs, the
    heads' losses and every updated buffer) against the JAX package's rule
    run in float64: the port's float32 forward at rtol 1e-4 / atol 1e-5,
    its float64 forward at rtol 1e-6 / atol 1e-6 (the two packages share
    only float32 resize tables).  JAX's own float32 program is no truth
    here: its BatchNorm's one-pass variance (``E[x²] - E[x]²``) cancels on
    channels whose mean dwarfs their spread, as the attention-weighted
    averages of EMA's reconstruction and the SelfAttentionBlock's context
    are, and moves its train outputs there by up to 2e-4 from float64.
    bf16 at the amp gate."""
    if mode == "train":
        truth = train_reference(name)
        got = train_outputs(name, torch.float32)
        exact = train_outputs(name, torch.float64)
        assert sorted(got) == sorted(exact) == sorted(truth)
        for key, value in truth.items():
            np.testing.assert_allclose(got[key], value, **TOL, err_msg=key)
            np.testing.assert_allclose(exact[key], value, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        return
    _, refs = references(name)
    port = port_module(name)
    xs = [to_nchw(x) for x in module_inputs(name)]
    seen = []
    with torch.no_grad(), recorded_scores(MODULES[name][4], seen):
        if mode == "bf16":
            with torch.autocast("cpu", dtype=torch.bfloat16):
                out = port_call(port, name, xs)
        else:
            out = port_call(port, name, xs)
    if mode == "eval":
        assert_close_tree(nhwc_outputs(out), refs["eval"], **TOL)
        return
    got = nhwc_outputs(out)
    want = [np.asarray(r) for r in jax.tree_util.tree_leaves(refs["bf16"])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= OUT_SHARE * np.abs(w).max()
        if MODULES[name][3]:
            assert (g.argmax(-1) == w.argmax(-1)).mean() >= ARGMAX_AGREE
    # every score product ran on the bf16 operands, in float32
    assert bool(seen) == bool(MODULES[name][4])
    for a, b, product in seen:
        assert product == torch.float32 and torch.bfloat16 in (a, b), seen


def mmcv_psa_mask(x, mask_size, psa_type):
    """mmcv's ``PSAMask`` forward loops on NCHW ``x (N, M, h, w)`` ->
    ``(N, L, L)`` indexed [n, a, b] as ``psa_mask`` returns it."""
    n, _, h, w = x.shape
    mask_h, mask_w = mask_size
    half_h, half_w = (mask_h - 1) // 2, (mask_w - 1) // 2
    out = np.zeros((n, h * w, h * w), x.dtype)
    for i in range(h):
        for j in range(w):
            for mi in range(max(0, half_h - i), min(mask_h, h + half_h - i)):
                for mj in range(max(0, half_w - j),
                                min(mask_w, w + half_w - j)):
                    a, b = i * w + j, (i + mi - half_h) * w + j + mj - half_w
                    if psa_type == "collect":
                        out[:, a, b] = x[:, mi * mask_w + mj, i, j]
                    else:
                        out[:, b, a] = x[:, mi * mask_w + mj, i, j]
    return out


@pytest.mark.parametrize("psa_type", ["collect", "distribute"])
def test_psa_mask_is_mmcv_psamask(psa_type):
    """The gather gives mmcv's loops' planes exactly, on a 5 x 6 map with
    a 5 x 3 mask (taps outside the map and the map outside the mask)."""
    x = rand(2, 15, 5, 6, seed=3)
    got = psa_head.psa_mask(torch.from_numpy(x), (5, 3), psa_type)
    np.testing.assert_array_equal(got.numpy(),
                                  mmcv_psa_mask(x, (5, 3), psa_type))


def test_registries_and_the_aspp_hook():
    """Every head of the slice is registered; DeepLabV3+'s head takes the
    ASPP head's image pool and bottleneck and makes its dilated branches
    separable through ``_build_aspp_module``."""
    for head in (sep_aspp_head.DepthwiseSeparableASPPHead, nl_head.NLHead,
                 dnl_head.DNLHead, gc_head.GCHead, cc_head.CCHead,
                 da_head.DAHead, ann_head.ANNHead, isa_head.ISAHead,
                 ema_head.EMAHead, psa_head.PSAHead):
        assert DECODEHEAD.get(head.__name__) is head
    plain = aspp_head.ASPPHead(**{k: v for k, v in SEP_ASPP.items()
                                  if not k.startswith("c1_")})
    assert type(plain.aspp_modules) is aspp_head.ASPPModule
    sep = sep_aspp_head.DepthwiseSeparableASPPHead(**SEP_ASPP)
    assert [type(b) for b in sep.aspp_modules.branches] == [
        type(plain.aspp_modules.branches[0])] + [
        dsconv.DepthwiseSeparableConvModule] * 2
    for part in ("image_pool_conv", "bottleneck"):
        assert (getattr(sep, part).state_dict().keys()
                == getattr(plain, part).state_dict().keys())


def test_ema_gradient_is_zero_and_bases_move_only_in_training():
    """``ema_mid_conv`` gets no gradient from the loss (as through the JAX
    package's ``stop_gradient``) and a zero one from the train step, so SGD
    still decays it, as optax does; ``bases`` move in training and stay
    at eval."""
    from image_segmentation_lab_tpu_torch.core.initialize.init_functions \
        import init_weights
    from image_segmentation_lab_tpu_torch.train_state import make_train_step

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.head = ema_head.EMAHead(ema_channels=24, num_bases=8,
                                         **HEAD)

        def forward_train(self, img, gt):
            return self.head.forward_train([img], gt)

    model = Model()
    head = model.head
    init_weights(head, torch.Generator().manual_seed(0))
    bases = head.ema_module.bases.clone()
    np.testing.assert_allclose(bases.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    img = to_nchw(rand(2, 8, 8, 32))
    with torch.no_grad():
        head.eval()([img])
    assert torch.equal(head.ema_module.bases, bases)
    mid = head.ema_mid_conv.conv.weight
    before = mid.detach().clone()
    lr, decay = 0.01, 5e-4
    step = make_train_step(model, torch.optim.SGD(
        model.parameters(), lr=lr, momentum=0.9, weight_decay=decay))
    step(img, torch.from_numpy(head_label()).long(),
         torch.Generator().manual_seed(0))
    assert not torch.equal(head.ema_module.bases, bases)
    assert mid.grad is not None and not mid.grad.any()
    torch.testing.assert_close(mid.detach(), before * (1 - lr * decay))
    assert head.ema_in_conv.conv.weight.grad.any()


@pytest.mark.parametrize("head, option", [
    (gc_head.GCHead, dict(pooling_type="avg")),
    (dnl_head.DNLHead, dict(mode="dot_product")),
    (psa_head.PSAHead, dict(compact=True))])
def test_options_no_config_selects_raise(head, option):
    """The JAX heads' options that no config turns on are not ported yet
    and raise, naming the queue that holds them."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        head(**HEAD, **option)
