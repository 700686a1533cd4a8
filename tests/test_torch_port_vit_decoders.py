"""The ViT decoders (SETR-MLA's neck and head, the MultiLevelNeck, DPT,
Segmenter), Twins, PoolFormer with the FPN neck and head, and ResNetV1d
against the JAX package, on the CPU.

``avg_pool2d`` in every ``ceil_mode`` / ``count_include_pad`` case against
the JAX function under ``jax.jit``, as its models run it: bit for bit on
values whose window sums are exact in float32 (so the free summation
order cannot show), within 2 float32 ulps of 1 on unit normals.
``resize(scale_factor=)`` at 0.5, 2 and 4 on an odd grid (25 x 17), in
the bilinear (both ``align_corners``) and nearest modes, against the JAX
resize and its gradient against ``jax.vjp`` (rtol 1e-5 / atol 2e-5; the
nearest rule bit for bit; the bicubic mode is in the slow file).

Single modules at widths 8-32, each at rtol 1e-4 / atol 1e-5 (float32
sums in other orders): the MLA neck, the MultiLevelNeck on 5 x 5 taps
(the 0.5 level gives 2 x 2 at step 2), the SETR-MLA head, the DPT head
with its ``project`` readout on ``(map, cls)`` pairs, the Segmenter head,
a ViT with ``output_cls_token``, the FPN neck with an extra pooled level
and the FPN head; the Twins PEG, locally grouped attention on a map that
pads (10 x 12) and one that does not (14 x 7), a GSA and an LSA layer, a
PoolFormer block, a ResNetV1d Bottleneck whose averaged shortcut meets an
odd map (9 x 9 -> 5 x 5), and ``LayerNorm2d``.  The modules share one
compiled JAX program.

The eight configs cut to size (widths 8-32, one or two blocks a stage,
without drop path and head dropout; Twins' arch tables get a tiny entry in
both packages while the models are built) are held in the slow
``test_torch_port_vit_decoder_steps.py``: four through their SGD step,
four through ``whole_inference``, each with the bridge both ways, and the
eight full-width configs through the bridge on shapes alone.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax, to_nchw, to_nhwc)

from image_segmentation_lab_tpu.models.backbones import (  # noqa: E402
    poolformer as jpoolformer, resnet as jresnet, twins as jtwins,
    vit as jvit)
from image_segmentation_lab_tpu.models.basic import \
    normalization as jnorm  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import (  # noqa: E402
    dpt_head as jdpt, fpn_head as jfpn_head, segmenter_mask_head as jseg,
    setr_mla_head as jmla_head)
from image_segmentation_lab_tpu.models.necks import (  # noqa: E402
    fpn as jfpn, mla_neck as jmla, multilevel_neck as jmln)
from image_segmentation_lab_tpu.ops.pooling import \
    avg_pool2d as javg_pool2d  # noqa: E402
from image_segmentation_lab_tpu.utils.ops import \
    resize as jresize  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.registry_hub import (  # noqa: E402,E501
    BACKBONE, DECODEHEAD, NECK, NORMALIZATION)
from image_segmentation_lab_tpu_torch.models.backbones import (  # noqa: E402
    poolformer, resnet, twins, vit)
from image_segmentation_lab_tpu_torch.models.basic import \
    LayerNorm2d  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import (  # noqa: E402,E501
    DPTHead, FPNHead, SegmenterMaskTransformerHead, SETRMLAHead)
from image_segmentation_lab_tpu_torch.models.necks import (  # noqa: E402
    FPN, MLANeck, MultiLevelNeck)
from image_segmentation_lab_tpu_torch.ops.pooling import \
    avg_pool2d  # noqa: E402
from image_segmentation_lab_tpu_torch.utils.ops import resize  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
BN = dict(type="SyncBN", requires_grad=True)
RELU = dict(type="ReLU")


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------- pooling
POOLS = [((13, 11), 3, 1, 1), ((13, 11), 2, 2, 0), ((13, 11), 3, 2, 1),
         ((8, 8), 2, 2, 0), ((12, 11), 3, 3, 1)]
POOL_CASES = [(hw, k, s, p, ceil_mode, count_include_pad)
              for hw, k, s, p in POOLS for ceil_mode in (False, True)
              for count_include_pad in (False, True)]


def pool_input(hw):
    """One sample on multiples of 2**-6 below 8 (every window sum exact
    in float32), one of unit normals."""
    rng = np.random.RandomState(0)
    grid = rng.randint(-512, 512, (1, *hw, 4)).astype(np.float32) / 64
    return np.concatenate([grid, rng.randn(1, *hw, 4).astype(np.float32)])


@pytest.fixture(scope="module")
def pool_references():
    """Every case's JAX pooling in float32 and bf16, one program."""
    xs = [pool_input(case[0]) for case in POOL_CASES]
    fn = jax.jit(lambda xs: [
        [javg_pool2d(x.astype(dtype), *case[1:]).astype(jnp.float32)
         for dtype in (jnp.float32, jnp.bfloat16)]
        for x, case in zip(xs, POOL_CASES)])
    return jax.device_get(compile_quickly(fn, xs)(xs))


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_avg_pool2d_is_the_jax_rule(case, pool_references):
    """PoolFormer's 3/1/1 mixer, ResNetV1d's 2/2 shortcut on an odd map
    (a clipped last window under ``ceil_mode``), and strides with
    padding, each with and without ``ceil_mode`` and the padding
    counted; float32 and bf16 (rounded once from the float32 result)."""
    hw, *args = POOL_CASES[case]
    x = pool_input(hw)
    for dtype, ref in zip((torch.float32, torch.bfloat16),
                          pool_references[case]):
        got = avg_pool2d(to_nchw(x).to(dtype), *args)
        assert got.dtype == dtype
        got, ref = to_nhwc(got.float()), np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=0,
                                   atol=2 ** -22 if dtype == torch.float32
                                   else 2 ** -6)


def test_avg_pool2d_backward_spreads_each_window_over_its_count():
    """The gradient of ``ceil_mode``'s clipped window without the padding
    counted: each output's gradient over its taps, divided by their
    number."""
    x = torch.zeros(1, 1, 3, 3, requires_grad=True)
    with torch.enable_grad():
        avg_pool2d(x, 2, 2, ceil_mode=True,
                   count_include_pad=False).sum().backward()
    np.testing.assert_array_equal(
        x.grad[0, 0].numpy(), [[0.25, 0.25, 0.5], [0.25, 0.25, 0.5],
                               [0.5, 0.5, 1.0]])


# ------------------------------------------------------------- resize
RESIZES = [(scale, mode, align) for scale in (0.5, 2, 4)
           for mode, align in (("bilinear", False), ("bilinear", True),
                               ("nearest", None))]
RESIZE_INPUT = rand(2, 25, 17, 3, seed=3)


def resize_grad(scale):
    return rand(2, int(25 * scale), int(17 * scale), 3, seed=4)


@pytest.fixture(scope="module")
def resize_references():
    """Every case's JAX resize and its ``jax.vjp``, one program."""
    def case(x, scale, mode, align):
        out, vjp = jax.vjp(lambda x: jresize(
            x, scale_factor=scale, mode=mode, align_corners=align,
            warning=False), x)
        return out, vjp(jnp.asarray(resize_grad(scale)))[0]

    fn = jax.jit(lambda x: [case(x, *c) for c in RESIZES])
    return jax.device_get(compile_quickly(fn, RESIZE_INPUT)(RESIZE_INPUT))


@pytest.mark.parametrize("case", range(len(RESIZES)))
def test_resize_scale_factor_matches_jax(case, resize_references):
    """0.5, 2 and 4 in the bilinear (both ``align_corners``) and nearest
    modes: 25 x 17 at 0.5 gives 12 x 8 read at step 2 (not 25/12); the
    gradient of the bilinear mode runs the resize backward's tables
    (``axis_table`` with the scale)."""
    scale, mode, align = RESIZES[case]
    ref, gref = resize_references[case]
    t = to_nchw(RESIZE_INPUT).requires_grad_(True)
    with torch.enable_grad():
        out = resize(t, scale_factor=scale, mode=mode, align_corners=align,
                     warning=False)
        out.backward(to_nchw(resize_grad(scale)))
    assert out.shape[2:] == (int(25 * scale), int(17 * scale))
    if mode == "bilinear":
        assert type(out.grad_fn).__name__ == "BilinearResizeBackward"
    tol = (dict(rtol=0, atol=0) if mode == "nearest"
           else dict(rtol=1e-5, atol=2e-5))
    np.testing.assert_allclose(to_nhwc(out.detach()), np.asarray(ref),
                               **tol)
    np.testing.assert_allclose(to_nhwc(t.grad), np.asarray(gref), **tol)


def test_scale_factor_and_size_rules_differ_on_an_odd_grid():
    """At 0.5 on 25 rows the size rule reads at step 25/12 and the scale
    rule at step 2: other values."""
    x = torch.from_numpy(rand(1, 1, 25, 25))
    by_scale = resize(x, scale_factor=0.5, align_corners=False)
    by_size = resize(x, (12, 12), align_corners=False)
    assert by_scale.shape == by_size.shape == (1, 1, 12, 12)
    assert (by_scale - by_size).abs().max() > 0.1


# ------------------------------------------------------------- modules
TWINS_TINY = {
    "svt-tiny": dict(dims=(8, 16, 24, 32), depths=(2, 2, 2, 2),
                     heads=(1, 2, 2, 4), mlps=(2, 2, 2, 2),
                     srs=(8, 4, 2, 1), wss=(7, 7, 7, 7)),
    "pcpvt-tiny": dict(dims=(8, 16, 24, 32), depths=(2, 1, 1, 1),
                       heads=(1, 2, 2, 4), mlps=(2, 2, 2, 2),
                       srs=(8, 4, 2, 1), wss=None)}


@contextlib.contextmanager
def tiny_twins():
    """Twins' arch tables of both packages with the tiny entries."""
    with mock.patch.dict(jtwins.ARCH_TABLE, TWINS_TINY), \
            mock.patch.dict(twins.ARCH_TABLE, TWINS_TINY):
        yield


TINY_VIT = dict(embed_dims=16, num_layers=4, num_heads=2, patch_size=8,
                pretrain_img_size=24, out_indices=(0, 1, 2, 3))
MULTIPLE = dict(input_transform="multiple_select", in_index=(0, 1, 2, 3))
HEAD = dict(num_classes=2, norm_cfg=BN)
TAPS = [(2, 5, 5, 16)] * 4
FPN_LEVELS = [(2, 15, 15, 8), (2, 8, 8, 16), (2, 4, 4, 24), (2, 2, 2, 32)]
POOLFORMER = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32))
DPT = dict(in_channels=(16,) * 4, channels=8, embed_dims=16,
           post_process_channels=(4, 8, 12, 16), readout_type="project",
           patch_size=8, **MULTIPLE, **HEAD)
SEGMENTER = dict(in_channels=16, channels=16, in_index=0, num_layers=2,
                 num_heads=2, dropout_ratio=0.0, num_classes=2)
# name: (JAX module, port module, input shapes (NHWC); a list is a list
# of maps, a pair (map, cls) in it a ViT tap with its class token).  The
# token modules take an NHWC map in JAX and ``(N, L, C)`` tokens with the
# map's size in the port
MODULES = {
    "mla_neck": (
        lambda: jmla.MLANeck(in_channels=[16] * 4, out_channels=8,
                             norm_cfg=BN, act_cfg=RELU),
        lambda: MLANeck(in_channels=[16] * 4, out_channels=8, norm_cfg=BN,
                        act_cfg=RELU), TAPS),
    "mln": (lambda: jmln.MultiLevelNeck(in_channels=[16] * 4,
                                        out_channels=8,
                                        scales=[4, 2, 1, 0.5]),
            lambda: MultiLevelNeck(in_channels=[16] * 4, out_channels=8,
                                   scales=[4, 2, 1, 0.5]), TAPS),
    "setr_mla_head": (
        lambda: jmla_head.SETRMLAHead(in_channels=[8] * 4, channels=16,
                                      mla_channels=4, **MULTIPLE, **HEAD),
        lambda: SETRMLAHead(in_channels=[8] * 4, channels=16,
                            mla_channels=4, **MULTIPLE, **HEAD),
        [(2, 5, 5, 8)] * 4),
    "dpt_head": (lambda: jdpt.DPTHead(**DPT), lambda: DPTHead(**DPT),
                 [((2, 5, 5, 16), (2, 16))] * 4),
    "segmenter_head": (
        lambda: jseg.SegmenterMaskTransformerHead(**SEGMENTER),
        lambda: SegmenterMaskTransformerHead(**SEGMENTER),
        [(2, 5, 6, 16)]),
    "vit_cls": (
        lambda: jvit.VisionTransformer(**TINY_VIT, output_cls_token=True),
        lambda: vit.VisionTransformer(**TINY_VIT, output_cls_token=True),
        (2, 40, 40, 3)),
    "fpn": (lambda: jfpn.FPN(in_channels=[8, 16, 24, 32], out_channels=8,
                             num_outs=5),
            lambda: FPN(in_channels=[8, 16, 24, 32], out_channels=8,
                        num_outs=5), FPN_LEVELS),
    "fpn_head": (
        lambda: jfpn_head.FPNHead(in_channels=[8] * 4, channels=8,
                                  feature_strides=[4, 8, 16, 32],
                                  **MULTIPLE, **HEAD),
        lambda: FPNHead(in_channels=[8] * 4, channels=8,
                        feature_strides=[4, 8, 16, 32], **MULTIPLE,
                        **HEAD),
        [(2, 16, 16, 8), (2, 8, 8, 8), (2, 4, 4, 8), (2, 2, 2, 8)]),
    "peg": (lambda: jtwins.ConditionalPositionEncoding(16),
            lambda: twins.ConditionalPositionEncoding(16), (2, 6, 7, 16)),
    "lsa_pad": (lambda: jtwins.LocallyGroupedSelfAttention(16, 2, 7),
                lambda: twins.LocallyGroupedSelfAttention(16, 2, 7),
                (2, 10, 12, 16)),
    "lsa": (lambda: jtwins.LocallyGroupedSelfAttention(16, 2, 7),
            lambda: twins.LocallyGroupedSelfAttention(16, 2, 7),
            (2, 14, 7, 16)),
    "gsa_layer": (lambda: jtwins.GSAEncoderLayer(16, 2, 32, sr_ratio=2),
                  lambda: twins.GSAEncoderLayer(16, 2, 32, sr_ratio=2),
                  (2, 8, 8, 16)),
    "lsa_layer": (lambda: jtwins.LSAEncoderLayer(16, 2, 32, window_size=7),
                  lambda: twins.LSAEncoderLayer(16, 2, 32, window_size=7),
                  (2, 9, 9, 16)),
    "poolformer_block": (lambda: jpoolformer.PoolFormerBlock(16),
                         lambda: poolformer.PoolFormerBlock(16),
                         (2, 7, 9, 16)),
    "v1d_bottleneck": (
        lambda: jresnet.Bottleneck(16, 8, stride=2, avg_down=True,
                                   norm_cfg=BN),
        lambda: resnet.Bottleneck(16, 8, stride=2, avg_down=True,
                                  norm_cfg=BN), (2, 9, 9, 16)),
    "layernorm2d": (lambda: jnorm.LayerNorm2d(16),
                    lambda: LayerNorm2d(16), (2, 5, 5, 16)),
}
TOKENS = ("peg", "lsa_pad", "lsa", "gsa_layer", "lsa_layer")
NO_TRAIN_ARG = ("peg", "layernorm2d")


def module_inputs(name):
    shapes = MODULES[name][2]
    if not isinstance(shapes, list):
        return rand(*shapes)
    return [tuple(rand(*s, seed=10 * i + j) for j, s in enumerate(shape))
            if isinstance(shape[0], tuple) else rand(*shape, seed=i)
            for i, shape in enumerate(shapes)]


class Bundle(flax_nn.Module):
    """Every JAX module of ``MODULES`` as a submodule of its name: one
    variable tree and one compiled program for all of them."""

    @flax_nn.compact
    def __call__(self, inputs):
        return {name: MODULES[name][0]().clone(parent=self, name=name)(
                    x, **({} if name in NO_TRAIN_ARG else {"train": False}))
                for name, x in inputs.items()}


@pytest.fixture(scope="module")
def references():
    """The JAX outputs of every module, and the variables."""
    inputs = {name: module_inputs(name) for name in MODULES}
    bundle = Bundle()
    variables = init_jax(bundle, inputs)
    fn = compile_quickly(jax.jit(bundle.apply), variables, inputs)
    return variables, jax.device_get(fn(variables, inputs))


def to_port(x):
    """NHWC maps as NCHW tensors, class tokens as they are, lists kept."""
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(t) for t in x)
    return to_nchw(x) if x.ndim == 4 else torch.from_numpy(x)


def leaves(out):
    """A port output's tensors in order, maps as NHWC arrays."""
    if isinstance(out, (list, tuple)):
        return [a for t in out for a in leaves(t)]
    return [to_nhwc(out) if out.dim() == 4 else out.numpy()]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, references):
    variables, outputs = references
    port = MODULES[name][1]()
    bridge(port, {col: tree[name] for col, tree in variables.items()
                  if name in tree})
    x = module_inputs(name)
    refs = [np.asarray(r) for r in jax.tree_util.tree_leaves(outputs[name])]
    with torch.no_grad():
        if name in TOKENS:
            n, h, w, c = x.shape
            outs = [port(torch.from_numpy(x.reshape(n, h * w, c)),
                         (h, w)).numpy()]
            refs = [refs[0].reshape(outs[0].shape)]
        else:
            outs = leaves(port(to_port(x)))
    assert [o.shape for o in outs] == [r.shape for r in refs]
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out, ref, **TOL)
    if name == "mln":
        assert [o.shape[1] for o in outs] == [20, 10, 5, 2]
    if name == "fpn":
        assert [o.shape[1] for o in outs] == [15, 8, 4, 2, 1]


def test_segmenter_head_has_no_classifier_conv():
    head = SegmenterMaskTransformerHead(**SEGMENTER)
    assert not hasattr(head, "conv_seg")
    assert head.proj_patch.shape == head.proj_classes.shape == (16, 16)


def test_pad_mask_separates_padding_from_the_map():
    """10 x 12 in groups of 7: 14 x 14 padded; a group's padded and real
    positions see each other at -1000, like with like at 0."""
    mask = twins.pad_mask(14, 14, 4, 2, 7, torch.device("cpu"))
    assert mask.shape == (4, 49, 49)
    assert float(mask[0].abs().max()) == 0  # the top-left group is whole
    last = mask[3].numpy()
    real = np.zeros((7, 7), bool)
    real[:3, :5] = True
    real = real.ravel()
    assert (last[np.ix_(real, ~real)] == -1000).all()
    assert (last[np.ix_(real, real)] == 0).all()
    assert (last[np.ix_(~real, ~real)] == 0).all()


def test_registries():
    assert BACKBONE.get("Twins-PCPVT") is BACKBONE.get("PCPVT") is \
        twins.PCPVT
    assert BACKBONE.get("Twins-SVT") is twins.SVT
    assert BACKBONE.get("PoolFormer") is poolformer.PoolFormer
    assert BACKBONE.get("ResNetV1d") is resnet.ResNetV1d
    for neck in (MLANeck, MultiLevelNeck, FPN):
        assert NECK.get(neck.__name__) is neck
    for head in (SETRMLAHead, DPTHead, SegmenterMaskTransformerHead,
                 FPNHead):
        assert DECODEHEAD.get(head.__name__) is head
    assert NORMALIZATION.get("LayerNorm2d") is LayerNorm2d


@pytest.mark.parametrize("cls", [twins.PCPVT, twins.SVT,
                                 poolformer.PoolFormer])
def test_unported_backbone_features_raise(cls):
    for kw in (dict(frozen_stages=1), dict(with_cp=True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            cls(**kw)


# ------------------------------------------------------------- the slice
TINY_NECK = dict(in_channels=[16] * 4, out_channels=16)
TINY_HEADS = dict(in_channels=[16] * 4, channels=16)
TINY_AUX = dict(in_channels=16, channels=8)
# config: (backbone, neck, decode head, aux head, image size); the ViT
# family on 40² (a 5 x 5 grid; MLN's 0.5 level at step 2), Twins on 64²
# (its LSA groups pad at every stage), PoolFormer on 64², ResNetV1d-18 on
# 60² (15² after the stem: the averaged shortcut clips a window)
TINY = {
    "setr/setr_mla_vit-s": (
        TINY_VIT, TINY_NECK,
        dict(in_channels=[16] * 4, channels=16, mla_channels=4),
        TINY_AUX, 40),
    "upernet/upernet_vit-b_mln": (
        dict(TINY_VIT, arch="small"), TINY_NECK, TINY_HEADS, TINY_AUX, 40),
    "dpt/dpt_vit-s": (TINY_VIT, None, {k: v for k, v in DPT.items()
                                       if k not in HEAD}, None, 40),
    "segmenter/segmenter_vit-s": (
        dict(TINY_VIT, out_indices=(3,)), None,
        dict({k: v for k, v in SEGMENTER.items() if k != "num_classes"},
             drop_path_rate=0.0), None, 40),
    "twins/twins_pcpvt-s_upernet": (
        dict(arch="pcpvt-tiny"), None,
        dict(in_channels=[8, 16, 24, 32], channels=16), TINY_AUX | dict(
            in_channels=24), 64),
    "twins/twins_svt-s_upernet": (
        dict(arch="svt-tiny"), None,
        dict(in_channels=[8, 16, 24, 32], channels=16), TINY_AUX | dict(
            in_channels=24), 64),
    "poolformer/fpn_poolformer_s12": (
        POOLFORMER, dict(in_channels=[8, 16, 24, 32], out_channels=8),
        dict(in_channels=[8] * 4, channels=8), None, 64),
    "pspnet/pspnet_r50-v1d-d8": (
        dict(depth=18, stem_channels=8, base_channels=8), None,
        dict(in_channels=64, channels=8), dict(in_channels=32, channels=8),
        60),
}


def tiny_network(config):
    """The network config cut to size, without drop path and dropout."""
    backbone, neck, head, aux = TINY[config][:4]
    network = load_python_config(f"configs/network/{config}.py")["model"]
    network["backbone"].update(backbone)
    if "drop_path_rate" in network["backbone"]:
        network["backbone"]["drop_path_rate"] = 0.0
    if neck:
        network["neck"].update(neck)
    network["decode_head"].update(head, dropout_ratio=0.0)
    if aux:
        network["auxiliary_head"].update(aux, dropout_ratio=0.0)
    return network


def tiny_batch(config, n=2, seed=5):
    size = TINY[config][4]
    rng = np.random.RandomState(seed)
    img = rng.randn(n, size, size, 3).astype(np.float32)
    gt = rng.randint(0, 2, (n, size, size)).astype(np.int32)
    gt[rng.rand(n, size, size) < 0.1] = 255
    return img, gt
