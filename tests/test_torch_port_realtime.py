"""PIDNet-S/-M, DDRNet-23-slim and their losses against the JAX package,
on the CPU.

``OhemCrossEntropy`` in both regimes (more valid pixels than ``min_kept``,
and fewer: the threshold becomes the largest valid probability), with
ignored pixels, class weights and a pixel weight: the kept set exactly,
the loss at rtol 1e-6.  ``BoundaryLoss`` on {0, 1} targets with a few
other values (weight 0) at rtol 1e-6.  ``boundary_from_label`` at edge
widths 1-5 with ignored pixels, bit for bit.

Single modules at widths 8-32 in one compiled JAX program, each at rtol
1e-4 / atol 1e-5: DAPPM and PAPPM on 10 x 10 and 9 x 7 maps (the pools
give 5², 3², 2² and the global mean), PagFM (plain, ``with_channel``,
``after_relu``), Bag, LightBag, the segmenthead block, tiny PIDNet-S,
PIDNet-M (Bag + DAPPM) and DDRNet backbones, and the PIDHead and DDRHead
``forward_train`` in eval mode on random taps against a 32² label: the
merged logits, every loss, ``acc_seg``, and the ``sigmoid(d) > 0.8`` mask
exactly.

The slow-marked tests run the tiny PIDNet-S (``channels`` 8 at 128², so
the 1/64 map is 2²) and DDRNet through one float32 SGD step of the kvasir
schedule (losses 1e-5, every gradient and parameter after the update at
rtol 1e-4 / atol 1e-5, the decode logits at rtol 1e-3 / atol 3e-3), the
tiny PIDNet-M through ``whole_inference``, and the bridge both ways at
full width for ``pidnet/pidnet-s.py`` and ``ddrnet/ddrnet_23-slim.py``.
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
    ddrnet as jddrnet, pidnet as jpidnet)
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import (  # noqa: E402
    ddr_head as jddr_head, ham_head as jham, pid_head as jpid_head)
from image_segmentation_lab_tpu.models.losses import (  # noqa: E402
    boundary_loss as jboundary, ohem_cross_entropy as johem)
from image_segmentation_lab_tpu.utils.ops import \
    resize as jresize  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_name, jax_state_dict, layout_maps, mapped_state_dict)
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.registry_hub import (  # noqa: E402,E501
    BACKBONE, DECODEHEAD, LOSS)
from image_segmentation_lab_tpu_torch.models.backbones import (  # noqa: E402
    ddrnet, pidnet)
from image_segmentation_lab_tpu_torch.models.basic import \
    LayerNorm  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import (  # noqa: E402,E501
    DDRHead, PIDHead, ham_head, pid_head)
from image_segmentation_lab_tpu_torch.models.losses import (  # noqa: E402
    BoundaryLoss, OhemCrossEntropy, ohem_cross_entropy)

TOL = dict(rtol=1e-4, atol=1e-5)
BN = dict(type="SyncBN", requires_grad=True)


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def labels(shape, classes=3, ignore_share=0.1, seed=2):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, classes, shape).astype(np.int32)
    gt[rng.rand(*shape) < ignore_share] = 255
    return gt


# ------------------------------------------------------------- losses
# (logits shape, min_kept, thres, class weight, pixel weight, ignore share)
OHEM_CASES = {
    "mined": ((2, 3, 16, 16), 100, 0.7, None, False, 0.1),
    "threshold": ((2, 3, 16, 16), 10, 0.7, None, False, 0.1),
    "fewer_valid_than_min_kept": ((2, 3, 16, 16), 2000, 0.9, None, False,
                                  0.1),
    "class_and_pixel_weights": ((2, 3, 16, 16), 300, 0.7, [0.5, 1.0, 2.0],
                                True, 0.2),
    "all_ignored": ((1, 2, 4, 4), 100, 0.7, None, False, 1.0),
}
EDGE_WIDTHS = (1, 2, 3, 4, 5)


def ohem_inputs(case):
    shape, min_kept, thres, cw, pixel_weight, ignore = OHEM_CASES[case]
    score = rand(*shape, seed=3) * 2
    gt = labels((shape[0], *shape[2:]), shape[1], ignore)
    weight = (np.random.RandomState(4).rand(shape[0], *shape[2:])
              .astype(np.float32) if pixel_weight else None)
    kw = dict(min_kept=min_kept, thres=thres, class_weight=cw,
              loss_weight=0.5)
    return score, gt, weight, kw


def boundary_loss_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 1, 12, 10).astype(np.float32) * 3
    t = (rng.rand(2, 12, 10) < 0.2).astype(np.float32)
    t[rng.rand(2, 12, 10) < 0.05] = 0.5  # neither 0 nor 1: weight 0
    return x, t


def edge_labels(edge_width):
    """Blobs of three classes with ignored pixels, on a non-square map."""
    rng = np.random.RandomState(edge_width)
    gt = np.kron(rng.randint(0, 3, (2, 5, 6)), np.ones((4, 3), int))
    gt = gt.astype(np.int32)
    gt[rng.rand(*gt.shape) < 0.05] = 255
    return gt


def jax_ohem_kept(score, gt, min_kept, thres):
    """The JAX loss's kept set, from its own probabilities."""
    c = score.shape[1]
    logp = jax.nn.log_softmax(
        jnp.transpose(score, (0, 2, 3, 1)).reshape(-1, c), axis=-1)
    flat = gt.reshape(-1)
    valid = flat != 255
    p = jnp.exp(jnp.take_along_axis(logp, jnp.where(valid, flat, 0)[:, None],
                                    axis=-1)[:, 0])
    p = jnp.where(valid, p, jnp.inf)
    k = jnp.clip(jnp.minimum(max(min_kept, 1), valid.sum() - 1), 0,
                 p.size - 1)
    return valid & (p < jnp.maximum(jnp.sort(p)[k], thres))


@pytest.fixture(scope="module")
def loss_references():
    """Every loss case's JAX value (and OHEM's kept set), one program."""
    def run():
        out = {}
        for case in OHEM_CASES:
            score, gt, weight, kw = ohem_inputs(case)
            out[case] = (johem.OhemCrossEntropy(**kw)(
                jnp.transpose(score, (0, 2, 3, 1)), gt,
                weight=None if weight is None else jnp.asarray(weight),
                ignore_index=255),
                jax_ohem_kept(score, gt, kw["min_kept"], kw["thres"]))
        for seed in (0, 1):
            x, t = boundary_loss_inputs(seed)
            out[f"boundary{seed}"] = jboundary.BoundaryLoss(
                loss_weight=20.0)(jnp.transpose(x, (0, 2, 3, 1)), t)
        for w in EDGE_WIDTHS:
            out[f"edges{w}"] = jpid_head.boundary_from_label(
                jnp.asarray(edge_labels(w)), w, 255)
        return out

    return jax.device_get(compile_quickly(jax.jit(run))())


@pytest.mark.parametrize("case", sorted(OHEM_CASES))
def test_ohem_cross_entropy_matches_jax(case, loss_references):
    """The loss, and the kept set exactly."""
    score, gt, weight, kw = ohem_inputs(case)
    ref, ref_kept = loss_references[case]
    kept = []
    real = ohem_cross_entropy.ohem_kept

    def recorded(*args):
        kept.append(real(*args))
        return kept[-1]

    loss = OhemCrossEntropy(**kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ohem_cross_entropy, "ohem_kept", recorded)
        got = loss(torch.from_numpy(score), torch.from_numpy(gt).long(),
                   weight=None if weight is None else torch.from_numpy(
                       weight), ignore_index=255)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_array_equal(kept[0].numpy(), np.asarray(ref_kept))
    assert loss.loss_name == "loss_ohem"


def test_ohem_keeps_all_but_the_easiest_below_min_kept():
    """With fewer valid pixels than ``min_kept`` the threshold is the
    largest valid probability, which itself drops out (the JAX quirk)."""
    p = torch.tensor([0.5, 0.2, float("inf"), 0.9])
    kept = ohem_cross_entropy.ohem_kept(p, torch.isfinite(p), 100, 0.1)
    assert kept.tolist() == [True, True, False, False]


@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_loss_matches_jax(seed, loss_references):
    x, t = boundary_loss_inputs(seed)
    got = BoundaryLoss(loss_weight=20.0)(torch.from_numpy(x),
                                         torch.from_numpy(t))
    np.testing.assert_allclose(float(got),
                               float(loss_references[f"boundary{seed}"]),
                               rtol=1e-6)


@pytest.mark.parametrize("edge_width", EDGE_WIDTHS)
def test_boundary_from_label_is_the_jax_map(edge_width, loss_references):
    """The same {0, 1} map bit for bit."""
    gt = edge_labels(edge_width)
    ref = np.asarray(loss_references[f"edges{edge_width}"])
    got = pid_head.boundary_from_label(torch.from_numpy(gt), edge_width, 255)
    assert got.dtype == torch.float32 and got.shape == gt.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


# ------------------------------------------------------------- modules
PID_HEAD = dict(in_channels=32, channels=16, num_classes=3, norm_cfg=BN,
                dropout_ratio=0.0, loss_decode=[
                    dict(type="CrossEntropyLoss", loss_weight=0.4),
                    dict(type="OhemCrossEntropy", thres=0.9, min_kept=500),
                    dict(type="BoundaryLoss", loss_weight=20.0),
                    dict(type="OhemCrossEntropy", thres=0.9, min_kept=500)])
DDR_HEAD = dict(in_channels=32, channels=8, num_classes=3, norm_cfg=BN,
                dropout_ratio=0.0, loss_decode=[
                    dict(type="OhemCrossEntropy", thres=0.9, min_kept=300),
                    dict(type="OhemCrossEntropy", thres=0.9, min_kept=300,
                         loss_weight=0.4)])
HEAD_LABEL = labels((2, 32, 32), seed=7)
# name: (JAX module, port module, input shapes (NHWC; a list is several
# arguments), JAX method)
MODULES = {
    "dappm": (lambda: jddrnet.DAPPM(16, 8, 12, norm_cfg=BN),
              lambda: ddrnet.DAPPM(16, 8, 12, norm_cfg=BN),
              [(2, 10, 10, 16)]),
    "pappm": (lambda: jpidnet.PAPPM(16, 8, 12, norm_cfg=BN),
              lambda: pidnet.PAPPM(16, 8, 12, norm_cfg=BN),
              [(2, 9, 7, 16)]),
    "pagfm": (lambda: jpidnet.PagFM(16, 8, norm_cfg=BN),
              lambda: pidnet.PagFM(16, 8, norm_cfg=BN),
              [(2, 8, 8, 16), (2, 4, 4, 16)]),
    "pagfm_channel_relu": (
        lambda: jpidnet.PagFM(16, 8, after_relu=True, with_channel=True,
                              norm_cfg=BN),
        lambda: pidnet.PagFM(16, 8, after_relu=True, with_channel=True,
                             norm_cfg=BN),
        [(2, 8, 8, 16), (2, 4, 4, 16)]),
    "bag": (lambda: jpidnet.Bag(16, 12, norm_cfg=BN),
            lambda: pidnet.Bag(16, 12, norm_cfg=BN), [(2, 6, 6, 16)] * 3),
    "light_bag": (lambda: jpidnet.LightBag(16, 12, norm_cfg=BN),
                  lambda: pidnet.LightBag(16, 12, norm_cfg=BN),
                  [(2, 6, 6, 16)] * 3),
    "segmenthead": (lambda: jpid_head._BasePIDHead(16, 8, 3, norm_cfg=BN),
                    lambda: pid_head._BasePIDHead(16, 8, 3, norm_cfg=BN),
                    [(2, 6, 6, 16)]),
    "pid_head": (lambda: jpid_head.PIDHead(**PID_HEAD),
                 lambda: PIDHead(**PID_HEAD),
                 [(2, 8, 8, 16), (2, 8, 8, 16), (2, 8, 8, 32)]),
    "ddr_head": (lambda: jddr_head.DDRHead(**DDR_HEAD),
                 lambda: DDRHead(**DDR_HEAD), [(2, 8, 8, 16), (2, 8, 8, 32)]),
}
HEADS = ("pid_head", "ddr_head")


def module_inputs(name):
    xs = [rand(*s, seed=10 + i) for i, s in enumerate(MODULES[name][2])]
    if name == "pid_head":
        xs[1] *= 8  # the D tap: boundary logits on both sides of 0.8
    return xs


class Bundle(flax_nn.Module):
    """Every JAX module of ``MODULES`` as a submodule of its name: one
    variable tree and one compiled program.  The heads run
    ``forward_train`` in eval mode (and record their confident-boundary
    mask), the rest their call."""

    @flax_nn.compact
    def __call__(self, inputs):
        out = {}
        for name, xs in inputs.items():
            module = MODULES[name][0]().clone(parent=self, name=name)
            if name in HEADS:
                out[name] = module.forward_train(
                    list(xs), jnp.asarray(HEAD_LABEL), train=False)
            if name == "pid_head":
                d = jresize(module.d_head(xs[1], train=False),
                            size=HEAD_LABEL.shape[1:], mode="bilinear",
                            align_corners=False)
                out["pid_head_confident"] = jax.nn.sigmoid(d[..., 0]) > 0.8
            if name not in HEADS:
                out[name] = module(*xs, train=False)
        return out


@pytest.fixture(scope="module")
def references():
    inputs = {name: module_inputs(name) for name in MODULES}
    bundle = Bundle()
    variables = init_jax(bundle, inputs)
    fn = compile_quickly(jax.jit(bundle.apply), variables, inputs)
    return variables, jax.device_get(fn(variables, inputs))


def port_module(name, variables):
    return bridge(MODULES[name][1](),
                  {col: tree[name] for col, tree in variables.items()
                   if name in tree})


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, references):
    variables, outputs = references
    port = port_module(name, variables)
    xs = [to_nchw(x) for x in module_inputs(name)]
    masks = []
    real = pid_head.boundary_confident

    def recorded(*args):
        masks.append(real(*args))
        return masks[-1]

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pid_head, "boundary_confident", recorded)
        if name in HEADS:
            logits, losses = port.forward_train(
                xs, torch.from_numpy(HEAD_LABEL).long())
            ref_logits, ref_losses = outputs[name]
            np.testing.assert_allclose(to_nhwc(logits), ref_logits, **TOL)
            assert sorted(losses) == sorted(ref_losses)
            for key, ref in ref_losses.items():
                np.testing.assert_allclose(float(losses[key]), float(ref),
                                           rtol=1e-5, err_msg=key)
        else:
            out = port(*xs)
            outs = out if isinstance(out, tuple) else (out,)
            refs = jax.tree_util.tree_leaves(outputs[name])
            assert [o.shape[2:] for o in outs] == [r.shape[1:3]
                                                   for r in refs]
            for o, r in zip(outs, refs):
                np.testing.assert_allclose(to_nhwc(o), np.asarray(r), **TOL)
    if name == "pid_head":
        # the JAX head's confident-boundary pixels, exactly
        want = np.asarray(outputs["pid_head_confident"])
        assert len(masks) == 1 and 0 < want.mean() < 1
        np.testing.assert_array_equal(masks[0].numpy(), want)


def test_registries():
    assert BACKBONE.get("PIDNet") is pidnet.PIDNet
    assert BACKBONE.get("DDRNet") is ddrnet.DDRNet
    assert DECODEHEAD.get("PIDHead") is PIDHead
    assert DECODEHEAD.get("DDRHead") is DDRHead
    assert LOSS.get("OhemCrossEntropy") is OhemCrossEntropy
    assert LOSS.get("BoundaryLoss") is BoundaryLoss


def test_heads_have_no_conv_seg_and_init_their_classifiers():
    """The segmentheads classify (normal(0, 0.01), zero bias, as the JAX
    ``_BasePIDHead``); the base head's ``conv_seg`` is gone, as JAX never
    makes it."""
    from image_segmentation_lab_tpu_torch.core.initialize.init_functions \
        import init_weights
    head = PIDHead(**PID_HEAD)
    assert not hasattr(head, "conv_seg")
    init_weights(head, torch.Generator().manual_seed(0))
    for block in (head.i_head, head.p_head, head.d_head):
        assert float(block.cls.weight.std()) < 0.02
        assert float(block.cls.bias.abs().max()) == 0.0
    assert not hasattr(DDRHead(**DDR_HEAD), "conv_seg")


# ------------------------------------------------------------- the slice
SCHEDULE = load_python_config("configs/schedule/kvasir_training_schedule.py")
TINY_BACKBONE = dict(channels=8, ppm_channels=8)
TINY_SIZE = 128  # the 1/64 map is 2 x 2
# config: (backbone, decode head) updates; the full-width losses as they are
TINY = {
    "pidnet/pidnet-s": (TINY_BACKBONE, dict(in_channels=32, channels=16)),
    "ddrnet/ddrnet_23-slim": (TINY_BACKBONE,
                              dict(in_channels=32, channels=8)),
    "segnext/segnext_mscan-t": (
        dict(embed_dims=(8, 16, 32, 32), depths=(1, 1, 2, 1),
             drop_path_rate=0.0),
        dict(in_channels=[16, 32, 32], channels=32, ham_channels=32,
             dropout_ratio=0.0)),
}
STEPPED = tuple(TINY)


def tiny_network(config):
    """The network config cut to size: PIDNet and DDRNet at ``channels`` 8,
    SegNeXt at dims (8, 16, 32, 32) with ``MD_R`` 4, no drop path or
    dropout."""
    backbone, head = TINY[config]
    network = load_python_config(f"configs/network/{config}.py")["model"]
    network["backbone"].update(backbone)
    network["decode_head"].update(head)
    if "ham_kwargs" in network["decode_head"]:
        network["decode_head"]["ham_kwargs"]["MD_R"] = 4
    return network


def tiny_batch(n=2, seed=9):
    """Images, and blob labels (edges on blob borders only) with 10 %
    ignored pixels."""
    rng = np.random.RandomState(seed)
    img = rng.randn(n, TINY_SIZE, TINY_SIZE, 3).astype(np.float32)
    gt = np.kron(rng.randint(0, 2, (n, 16, 16)), np.ones((8, 8), int))
    gt = gt.astype(np.int32)
    gt[rng.rand(*gt.shape) < 0.1] = 255
    return img, gt


@functools.lru_cache(maxsize=None)
def jax_bases(shape):
    """The JAX package's bases of a fixed key: both packages take these."""
    draw = jax.jit(lambda key: jax.random.uniform(key, shape, jnp.float32))
    return np.array(draw(jax.random.PRNGKey(0)))


@contextlib.contextmanager
def same_bases():
    """Both packages' NMF2D bases are ``jax_bases``."""
    with mock.patch.object(jham.NMF2D, "_rng",
                           lambda self: jax.random.PRNGKey(0)), \
            mock.patch.object(ham_head, "draw_bases",
                              lambda shape, device, dtype, training:
                              torch.tensor(jax_bases(tuple(shape)),
                                           device=device, dtype=dtype)):
        yield


class Segmentors(flax_nn.Module):
    """The tiny segmentors as submodules ``model<i>``: one variable tree
    and one compiled program; ``whole`` runs ``whole_inference``, else
    ``forward_train``."""

    @flax_nn.compact
    def __call__(self, img, gt, train=False, whole=False):
        out = {}
        for i, config in enumerate(STEPPED):
            model = jax_build(tiny_network(config)).clone(parent=self,
                                                         name=f"model{i}")
            out[config] = (model.whole_inference(img, rescale=False)
                           if whole else
                           model.forward_train(img, gt, train=train))
        return out


@pytest.fixture(scope="module")
def steps():
    """The JAX side of every step: per config the float32 train-mode
    losses, decode logits and gradients, the parameters after one SGD
    update, and the bf16 policy's loss and decode logits; the
    variables."""
    img, gt = tiny_batch()
    bundle = Segmentors()
    lr = jbuild_from_cfg(SCHEDULE["lr_config"], JLR).schedule(
        SCHEDULE["optimizer"]["lr"], 1)
    tx = jbuild_optimizer({**SCHEDULE["optimizer"], "lr": lr})
    with same_bases():
        variables = init_jax(bundle, img, gt)
        params = variables["params"]

        def loss_fn(params, policy):
            with jpolicy.policy_scope(policy):
                outs, _ = bundle.apply(
                    {**variables, "params": params}, img, gt, train=True,
                    mutable=["batch_stats"])
            losses = {c: jtrain.parse_losses(outs[c][1])[0] for c in STEPPED}
            return sum(losses.values()), (
                {c: outs[c][1] for c in STEPPED},
                {c: outs[c][0]["decode"] for c in STEPPED})

        def run(params):
            (_, f32), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, "fp32")
            updates, _ = tx.update(grads, tx.init(params), params)
            return (f32, grads, optax.apply_updates(params, updates),
                    loss_fn(params, "bf16")[1])

        out = compile_quickly(jax.jit(run), params)(params)
    return variables, jax.device_get(out)


def tiny_model(config, variables):
    name = f"model{STEPPED.index(config)}"
    return bridge(build_segmentor(tiny_network(config)),
                  {col: tree[name] for col, tree in variables.items()
                   if name in tree})


def port_grads(model):
    """The port's gradients under their JAX names, in JAX layouts."""
    layout = layout_maps(model, to_jax=True)
    return {jax_name(name): layout.get(name, np.asarray)(p.grad.numpy())
            for name, p in model.named_parameters()}


def run_step(config, variables, dtype=torch.float32, choices=None):
    """One SGD step of the port from the JAX variables: the model, the
    step's log, its train-mode decode logits and losses.  In float32 the
    step records its discrete choices in ``choices``; in float64 it takes
    them from there (``replayed_choices``), with LayerNorm in the input's
    dtype (the port's casts to float32)."""
    model = tiny_model(config, variables).to(dtype)
    state = train_state.create_train_state(
        model, SCHEDULE["optimizer"], SCHEDULE["lr_config"])
    step = train_state.make_train_step(state.model, state.optimizer,
                                       state.scheduler)
    seen = []
    forward_train = model.forward_train

    def recorded(*args, **kwargs):
        out, loss_dict = forward_train(*args, **kwargs)
        seen.append((out["decode"].detach(), loss_dict))
        return out, loss_dict

    model.forward_train = recorded
    img, gt = tiny_batch()
    float64 = dtype == torch.float64
    with contextlib.ExitStack() as stack:
        stack.enter_context(same_bases())
        if float64:
            stack.enter_context(replayed_choices(choices))
            stack.enter_context(mock.patch.object(
                LayerNorm, "forward", lambda self, x: F.layer_norm(
                    x, self.normalized_shape, self.weight, self.bias,
                    self.eps)))
        elif choices is not None:
            stack.enter_context(recorded_choices(choices))
        log = step(to_nchw(img).to(dtype), torch.from_numpy(gt).long(),
                   torch.Generator().manual_seed(0))
    return model, log, seen[0]


@contextlib.contextmanager
def recorded_choices(choices):
    """Appends every OHEM kept set, confident-boundary mask and ReLU
    branch (the inputs above 0) to ``choices``."""
    kept, confident = (ohem_cross_entropy.ohem_kept,
                       pid_head.boundary_confident)

    def record(fn):
        def wrapped(*args):
            choices.append(fn(*args))
            return choices[-1]
        return wrapped

    def relu(x, inplace=False):
        choices.append(x.detach() > 0)
        return real_relu(x, inplace=inplace)

    real_relu = F.relu
    with mock.patch.object(ohem_cross_entropy, "ohem_kept", record(kept)), \
            mock.patch.object(pid_head, "boundary_confident",
                              record(confident)), \
            mock.patch.object(F, "relu", relu):
        yield


@contextlib.contextmanager
def replayed_choices(choices):
    """Hands out ``choices`` in their order instead of computing them."""
    taken = iter(choices)
    with mock.patch.object(ohem_cross_entropy, "ohem_kept",
                           lambda *args: next(taken)), \
            mock.patch.object(pid_head, "boundary_confident",
                              lambda *args: next(taken)), \
            mock.patch.object(F, "relu", lambda x, inplace=False: torch.where(
                next(taken), x, x.new_zeros(()))):
        yield
    assert next(taken, None) is None


def held_to_float64(got, ref, truth, scaled=False):
    """Each of the port's tensors ``got`` within rtol 1e-4 / atol 1e-5 of
    the port's float64 ``truth`` (with ``scaled``, the atol plus 1e-4 of
    the tensor's largest value), and within the same of JAX's ``ref``
    widened by JAX's own distance from ``truth``."""
    assert sorted(got) == sorted(ref) == sorted(truth)
    for key, value in ref.items():
        atol = TOL["atol"] + (TOL["rtol"] * np.abs(truth[key]).max()
                              if scaled else 0.0)
        np.testing.assert_allclose(got[key], truth[key], rtol=TOL["rtol"],
                                   atol=atol, err_msg=key)
        slack = np.abs(value - truth[key])
        bound = atol + TOL["rtol"] * np.abs(value) + slack
        assert (np.abs(got[key] - value) <= bound).all(), (
            key, np.abs(got[key] - value).max(), slack.max())


@pytest.mark.slow
@pytest.mark.parametrize("config", STEPPED)
def test_tiny_sgd_step_matches_jax(config, steps):
    """The decode logits at the slice tolerance and every loss at 1e-5
    against JAX; every parameter after the update within rtol 1e-4 / atol
    1e-5, and every gradient within rtol 1e-4 / atol 1e-5 plus 1e-4 of the
    tensor's largest value (float32 sums over the 2 x 128² pixels of a
    conv's weight gradient), of the port's float64 step (on the float32
    step's ReLU branches, OHEM kept sets and boundary masks) and of JAX's,
    the latter widened by JAX's own distance from the float64 step: the
    JAX BatchNorm's one-pass float32 variance (``E[x²] - E[x]²``) cancels
    on the pooled branches' two values a channel (PAPPM's and DAPPM's
    global mean at batch 2), which moves JAX's float32 gradients of
    PIDNet-S's stem by up to 4e-2 from float64 and its updated stem by
    4e-4, where the port's (two-pass) stay within 2e-4 and 1e-6."""
    variables, ((losses, logits), grads, params, _) = steps
    name = f"model{STEPPED.index(config)}"
    choices = []
    model, log, (decode, loss_dict) = run_step(config, variables,
                                               choices=choices)
    exact, _, _ = run_step(config, variables, torch.float64, choices)
    assert decode.shape == (2, 2, TINY_SIZE, TINY_SIZE)
    np.testing.assert_allclose(to_nhwc(decode), logits[config], rtol=1e-3,
                               atol=3e-3)
    assert sorted(loss_dict) == sorted(losses[config])
    for key, ref in losses[config].items():
        np.testing.assert_allclose(float(loss_dict[key]), float(ref),
                                   rtol=1e-5, err_msg=key)
    held_to_float64(port_grads(model),
                    state_dict_from_variables({"params": grads[name]}),
                    {k: v.astype(np.float64)
                     for k, v in port_grads(exact).items()}, scaled=True)
    ref_params = state_dict_from_variables({"params": params[name]})
    truth = {k: v for k, v in jax_state_dict(exact).items()
             if k in ref_params}
    held_to_float64({k: v for k, v in jax_state_dict(model).items()
                     if k in ref_params}, ref_params, truth)


@pytest.mark.slow
def test_tiny_pidnet_m_whole_inference_matches_jax():
    """PIDNet-M's branch (Bag + DAPPM, three stem blocks) through
    ``whole_inference`` at the slice tolerance, and the bridge both
    ways."""
    network = tiny_network("pidnet/pidnet-s")
    network["backbone"].update(num_stem_blocks=3, num_branch_blocks=4)
    img, gt = tiny_batch()
    jm = jax_build(network)
    variables = init_jax(jm, img, gt, img_metas={}, rescale=False,
                         return_loss=True, train=True)
    ref = compile_quickly(jax.jit(lambda v, x: jm.apply(
        v, x, rescale=False, method="whole_inference")), variables, img)(
            variables, img)
    pm = bridge(build_segmentor(network), variables)
    with torch.no_grad():
        out = pm.whole_inference(to_nchw(img), rescale=False)
    assert_argmax_parity(np.asarray(ref), to_nhwc(out))
    want = state_dict_from_variables(variables)
    got = jax_state_dict(pm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.slow
@pytest.mark.parametrize("config", STEPPED)
def test_bridge_loads_the_full_size_configs_strictly_both_ways(config):
    """The full-width config's JAX train-init variables (every head,
    including PIDHead's P and D heads and DDRHead's spatial head) load
    strictly into the port and come back under the same names and
    layouts, bit for bit."""
    network = load_python_config(f"configs/network/{config}.py")["model"]
    jm = jax_build(network)
    img, gt = np.zeros((1, 64, 64, 3), np.float32), np.zeros((1, 64, 64),
                                                             np.int32)
    with same_bases():
        variables = init_jax(jm, img, gt, img_metas={}, rescale=False,
                             return_loss=True, train=True)
    want = state_dict_from_variables(variables)
    pm = build_segmentor(network)
    assert len(mapped_state_dict(pm, want)) == len(want)
    bridge(pm, variables)
    got = jax_state_dict(pm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert sum(v.size for v in want.values()) > 1_000_000
