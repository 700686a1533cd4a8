"""The SETR serving slice against the JAX package, on the CPU.

Modules (LayerNorm, Linear, bicubic resize, ViT attention, the ViT
backbone): rtol 1e-4 / atol 1e-4, a few float32 ulps after reordered sums.
The tiny SETR-PUP segmentor (configs/network/setr/setr_pup_vit-s.py cut to
2 layers of width 32, 2 heads, patch 8): logits at rtol 1e-3 / atol 3e-3
with identical hard predictions except at genuine ties, the slice
tolerance of tests/test_torch_port_slice.  The full-size state dict of the
config loads strictly through the bridge (no forward pass).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (assert_argmax_parity, bridge,  # noqa: E402
                                init_jax, jax_apply, to_nchw, to_nhwc)

from image_segmentation_lab_tpu.core.initialize.checkpoint import (  # noqa: E402,E501
    save_checkpoint, state_dict_from_variables)
from image_segmentation_lab_tpu.models.backbones import vit as jvit  # noqa: E402,E501
from image_segmentation_lab_tpu.models.basic.convolution import \
    Linear as JLinear  # noqa: E402
from image_segmentation_lab_tpu.models.basic.normalization import \
    LayerNorm as JLayerNorm  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.utils.ops import resize as jresize  # noqa: E402,E501
from image_segmentation_lab_tpu_torch.bridge import \
    load_jax_state_dict  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.inference import (  # noqa: E402
    inference_model, init_model)
from image_segmentation_lab_tpu_torch.core.registry_hub import (  # noqa: E402,E501
    BACKBONE, DECODEHEAD, DROPOUT, NORMALIZATION)
from image_segmentation_lab_tpu_torch.models.backbones import vit  # noqa: E402,E501
from image_segmentation_lab_tpu_torch.models.basic import (  # noqa: E402
    DropPath, LayerNorm, Linear)
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import \
    SETRUPHead  # noqa: E402
from image_segmentation_lab_tpu_torch.utils.ops import resize  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SETR_CONFIG = "configs/network/setr/setr_pup_vit-s.py"
TINY_VIT = dict(embed_dims=32, num_layers=2, num_heads=2, patch_size=8,
                pretrain_img_size=24, out_indices=(0, 1), final_norm=True)


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def check_tokens(jax_module, port_module, x):
    """Same weights, same (N, L, C) input: the same output."""
    variables = init_jax(jax_module, x)
    bridge(port_module, variables)
    ref = jax_apply(jax_module, variables, x)
    with torch.no_grad():
        out = port_module(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_layer_norm():
    check_tokens(JLayerNorm(12), LayerNorm(12), rand(2, 5, 12) * 3 + 1)
    x = torch.from_numpy(rand(2, 5, 12)).to(torch.bfloat16)
    out = LayerNorm(12)(x)
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (12,), eps=1e-5)
    torch.testing.assert_close(out, ref.to(torch.bfloat16), rtol=0, atol=0)


def test_linear():
    check_tokens(JLinear(7, 5), Linear(7, 5), rand(2, 3, 7))


@pytest.mark.parametrize("src,dst", [(14, 5), (4, 9)])
def test_bicubic_resize(src, dst):
    """The position-table resize: torch's a = -0.75 kernel, unclamped
    negative source coordinates, replicated border taps."""
    x = rand(1, src, src, 6)
    ref = jresize(jnp.asarray(x), (dst, dst), mode="bicubic",
                  align_corners=False)
    out = resize(to_nchw(x), (dst, dst), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **TOL)


def test_vit_attention():
    check_tokens(jvit.MultiheadAttention(32, 2), vit.MultiheadAttention(32, 2),
                 rand(2, 17, 32))


@pytest.mark.parametrize("variant", ["cls_bicubic", "no_cls_bilinear"])
def test_vision_transformer(variant):
    """2 layers of width 32 at patch 8 on 40² (a 5x5 grid), with the
    position table stored at a 3x3 grid so that it is resized."""
    kw = dict(TINY_VIT)
    if variant == "no_cls_bilinear":
        kw.update(with_cls_token=False, interpolate_mode="bilinear",
                  final_norm=False)
    jm, pm = jvit.VisionTransformer(**kw), vit.VisionTransformer(**kw)
    x = rand(2, 40, 40, 3)
    variables = init_jax(jm, x)
    bridge(pm, variables)
    refs = jax.jit(lambda v, x: jm.apply(v, x))(variables, x)
    with torch.no_grad():
        outs = pm(to_nchw(x))
    assert len(outs) == len(refs) == 2
    for out, ref in zip(outs, refs):
        assert out.shape == (2, 32, 5, 5)
        np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **TOL)


def test_unported_vit_features_raise():
    for kw in (dict(num_experts=4), dict(with_cp=True),
               dict(output_cls_token=True), dict(frozen_stages=1)):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            vit.VisionTransformer(**TINY_VIT, **kw)


def test_drop_path():
    """Identity in eval mode; in training each sample's branch is either
    zero or scaled by 1 / (1 - p)."""
    x = torch.ones(64, 3, 5)
    layer = DropPath(0.25)
    assert layer.eval()(x) is x
    out = layer.train()(x)
    per_sample = out.flatten(1)
    kept = per_sample == torch.tensor(1 / 0.75)
    assert (kept | (per_sample == 0)).all() and 0 < kept.sum() < kept.numel()
    assert (per_sample == per_sample[:, :1]).all()


def test_registries():
    assert BACKBONE.get("ViT") is BACKBONE.get("VisionTransformer") \
        is vit.VisionTransformer
    assert DECODEHEAD.get("SETRUPHead") is SETRUPHead
    assert NORMALIZATION.get("LN") is NORMALIZATION.get("LayerNorm") \
        is LayerNorm
    assert DROPOUT.get("DropPath") is DropPath


def tiny_setr_network():
    """configs/network/setr/setr_pup_vit-s.py, cut to the tiny ViT."""
    network = load_python_config(SETR_CONFIG)["model"]
    network["backbone"].update(TINY_VIT)
    for head in ("decode_head", "auxiliary_head"):
        network[head].update(in_channels=32, channels=8)
    return network


@pytest.fixture(scope="module")
def setr_pair():
    network = tiny_setr_network()
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, 40, 40, 3)),
                         jnp.zeros((1, 40, 40), jnp.int32),
                         method="forward_train", train=False)
    x = rand(2, 40, 40, 3, seed=7)
    return network, jm, variables, x


def test_setr_whole_inference(setr_pair):
    network, jm, variables, x = setr_pair
    pm = bridge(build_segmentor(network), variables)
    ref = jax_apply(jm, variables, x, method="whole_inference", rescale=False)
    with torch.no_grad():
        out = pm.whole_inference(to_nchw(x), rescale=False)
    assert out.shape == (2, 2, 40, 40)
    assert_argmax_parity(ref, to_nhwc(out))


def test_setr_predict_through_init_model(setr_pair, tmp_path):
    """``init_model`` on the cut config loads a checkpoint the JAX package
    wrote; ``predict`` and ``inference_model`` give the JAX class maps."""
    network, jm, variables, x = setr_pair
    config = tmp_path / "setr_pup_vit_tiny.py"
    config.write_text(f"model = {network!r}\n")
    checkpoint = tmp_path / "weights.pth"
    save_checkpoint(variables, checkpoint, metadata={"CLASSES": ["bg", "fg"]})
    model = init_model(config, checkpoint=checkpoint, device="cpu")
    ref = jax_apply(jm, variables, x, method="predict", rescale=False)
    assert 0 < ref.mean() < 1  # both classes occur
    with torch.no_grad():
        out = model.predict(to_nchw(x), rescale=False)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(inference_model(model, x), ref)


def test_bridge_loads_the_full_size_setr_state_dict():
    """The full-width, full-depth config's JAX state dict (aux head
    included) loads strictly; a square linear weight with an asymmetric
    value shows the (in, out) -> (out, in) transpose."""
    network = load_python_config(SETR_CONFIG)["model"]
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, 32, 32, 3)),
                         jnp.zeros((1, 32, 32), jnp.int32),
                         method="forward_train", train=False)
    sd = state_dict_from_variables(variables)
    without_aux = sum(v.size for k, v in sd.items()
                      if not k.startswith("auxiliary_head"))
    assert without_aux == 24_325_250
    pm = build_segmentor(network)
    load_jax_state_dict(pm, sd)
    proj = sd["backbone.block0.attn.proj.weight"]
    assert proj.shape == (384, 384) and np.abs(proj - proj.T).max() > 0.1
    np.testing.assert_array_equal(
        pm.backbone.block0.attn.proj.weight.detach().numpy(), proj.T)
    np.testing.assert_array_equal(pm.backbone.pos_embed.detach().numpy(),
                                  sd["backbone.pos_embed"])
    assert pm.backbone.pos_embed.shape == (1, 197, 384)
