"""SegNeXt's MSCAN encoder and LightHamHead against the JAX package, on
the CPU.

Single modules at widths 8-32 in one compiled JAX program, each at rtol
1e-4 / atol 1e-5: MSCA's attention (the 5 x 5 and the strip pairs up to
21 x 1 on a 23 x 25 map, so every strip reaches past the edge), its
spatial-attention wrapper, the MLP, an MSCA block (BN, layer scales), a
tiny MSCAN (dims (8, 16, 32, 32), depths (1, 1, 2, 1)), ``NMF2D`` at eval
and in training with its gradient (``jax.vjp`` against the port's
backward), the ``Hamburger`` and a ``LightHamHead`` (``ham_channels`` 32,
``MD_R`` 4, GroupNorm of 8 groups).  Both packages take the JAX draw of
``PRNGKey(0)`` as the NMF's bases (``test_torch_port_realtime.same_bases``).

The port's own bases: at eval one input gives the same bits on every call
(a generator seeded with 0 on the input's device), in training they come
from the installed generator and nothing else.  Under the bf16 autocast
the NMF runs in float32: its bf16 output is the float32 NMF of the same
input rounded once.

The slow-marked test runs the tiny SegNeXt's train-mode forward under the
bf16 policy at the amp gates of ``PERF.md`` §2 (decode logits within 2**-4
of the largest |logit|, 98 % equal argmax, the loss at rtol 1e-2); its
float32 step and full-width bridge are in ``test_torch_port_realtime.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402
from test_torch_port_realtime import (same_bases, steps,  # noqa: E402,F401
                                      tiny_batch, tiny_model)
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax, to_nchw, to_nhwc)

from image_segmentation_lab_tpu.models.backbones import \
    mscan as jmscan  # noqa: E402
from image_segmentation_lab_tpu.models.decode_heads import \
    ham_head as jham  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.core.mixed_precision import \
    policy_scope  # noqa: E402
from image_segmentation_lab_tpu_torch.core.registry_hub import (  # noqa: E402,E501
    BACKBONE, DECODEHEAD)
from image_segmentation_lab_tpu_torch.models.backbones import \
    mscan  # noqa: E402
from image_segmentation_lab_tpu_torch.models.basic.drop import \
    use_generator  # noqa: E402
from image_segmentation_lab_tpu_torch.models.decode_heads import \
    ham_head  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
BN = dict(type="SyncBN", requires_grad=True)
GN = dict(type="GN", num_groups=8, requires_grad=True)
HAM = dict(MD_S=1, MD_R=4, TRAIN_STEPS=6, EVAL_STEPS=7, INV_T=100,
           RAND_INIT=True)
TINY_MSCAN = dict(embed_dims=(8, 16, 32, 32), depths=(1, 1, 2, 1),
                  norm_cfg=BN)
HEAD = dict(in_channels=[16, 32, 32], in_index=[1, 2, 3],
            input_transform="multiple_select", channels=16, ham_channels=32,
            ham_kwargs=HAM, dropout_ratio=0.0, num_classes=2, norm_cfg=GN)


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def nmf_input(seed=3):
    """A non-negative map, as the Hamburger's ReLU gives the NMF."""
    return np.abs(rand(2, 6, 7, 16, seed=seed))


# name: (JAX module, port module, input shapes (NHWC), train)
MODULES = {
    "msca_attention": (lambda: jmscan.MSCAAttention(8),
                       lambda: mscan.MSCAAttention(8), (2, 23, 25, 8)),
    "msca_spatial": (lambda: jmscan.MSCASpatialAttention(8),
                     lambda: mscan.MSCASpatialAttention(8), (2, 9, 11, 8)),
    "msca_mlp": (lambda: jmscan.MSCAMlp(8, 32), lambda: mscan.MSCAMlp(8, 32),
                 (2, 9, 11, 8)),
    "msca_block": (lambda: jmscan.MSCABlock(16, 4, norm_cfg=BN),
                   lambda: mscan.MSCABlock(16, 4, norm_cfg=BN),
                   (2, 9, 11, 16)),
    "mscan": (lambda: jmscan.MSCAN(**TINY_MSCAN),
              lambda: mscan.MSCAN(**TINY_MSCAN), (2, 64, 64, 3)),
    "nmf": (lambda: jham.NMF2D(HAM), lambda: ham_head.NMF2D(HAM), None),
    "hamburger": (lambda: jham.Hamburger(16, HAM, norm_cfg=GN),
                  lambda: ham_head.Hamburger(16, HAM, norm_cfg=GN),
                  (2, 6, 7, 16)),
    "light_ham_head": (lambda: jham.LightHamHead(**HEAD),
                       lambda: ham_head.LightHamHead(**HEAD), None),
}
HEAD_INPUTS = [(2, 16, 16, 8), (2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 32)]
NMF_COTANGENT = rand(2, 6, 7, 16, seed=4)


def module_inputs(name):
    if name == "nmf":
        return nmf_input()
    if name == "light_ham_head":
        return [rand(*s, seed=i) for i, s in enumerate(HEAD_INPUTS)]
    return rand(*MODULES[name][2])


class Bundle(flax_nn.Module):
    """Every JAX module of ``MODULES`` as a submodule of its name, one
    program; the NMF also in training, with ``jax.vjp`` of its input."""

    @flax_nn.compact
    def __call__(self, inputs):
        out = {name: MODULES[name][0]().clone(parent=self, name=name)(
                   x, train=False) for name, x in inputs.items()}
        nmf = jham.NMF2D(HAM, name="nmf_train")
        value, vjp = jax.vjp(lambda x: nmf(x, train=True), inputs["nmf"])
        out["nmf_train"] = (value, vjp(jnp.asarray(NMF_COTANGENT))[0])
        return out


@pytest.fixture(scope="module")
def references():
    inputs = {name: module_inputs(name) for name in MODULES}
    bundle = Bundle()
    with same_bases():
        variables = init_jax(bundle, inputs)
        fn = compile_quickly(jax.jit(bundle.apply), variables, inputs)
        return variables, jax.device_get(fn(variables, inputs))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, references):
    variables, outputs = references
    port = bridge(MODULES[name][1](),
                  {col: tree[name] for col, tree in variables.items()
                   if name in tree})
    x = module_inputs(name)
    refs = [np.asarray(r) for r in jax.tree_util.tree_leaves(outputs[name])]
    with torch.no_grad(), same_bases():
        out = port([to_nchw(t) for t in x] if isinstance(x, list)
                   else to_nchw(x))
    outs = [to_nhwc(o) for o in (out if isinstance(out, tuple) else (out,))]
    assert [o.shape for o in outs] == [r.shape for r in refs]
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o, r, **TOL)


def test_nmf_in_training_and_its_gradient_match_jax(references):
    """``TRAIN_STEPS`` updates, and the gradient through the last
    coefficient step only (bases and coefficients detached)."""
    _, outputs = references
    ref, ref_grad = outputs["nmf_train"]
    nmf = ham_head.NMF2D(HAM).train()
    x = to_nchw(nmf_input()).requires_grad_(True)
    with torch.enable_grad(), same_bases():
        out = nmf(x)
        out.backward(to_nchw(NMF_COTANGENT))
    np.testing.assert_allclose(to_nhwc(out.detach()), np.asarray(ref), **TOL)
    np.testing.assert_allclose(to_nhwc(x.grad), np.asarray(ref_grad), **TOL)


def test_eval_bases_are_the_same_bits_on_every_call():
    nmf = ham_head.NMF2D(HAM).eval()
    x = to_nchw(nmf_input())
    first, second = nmf(x), nmf(x)
    assert torch.equal(first, second)
    bases = ham_head.draw_bases((2, 16, 4), x.device, torch.float32, False)
    assert torch.equal(bases, ham_head.draw_bases((2, 16, 4), x.device,
                                                  torch.float32, False))


def test_training_bases_come_from_the_installed_generator():
    nmf = ham_head.NMF2D(HAM).train()
    x = to_nchw(nmf_input())
    with pytest.raises(RuntimeError, match="use_generator"):
        nmf(x)
    outs = []
    for seed in (1, 1, 2):
        with use_generator(torch.Generator().manual_seed(seed)):
            outs.append(nmf(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_nmf_runs_in_float32_under_bf16_autocast():
    """The bf16 input's NMF is its float32 NMF rounded once: no product
    of the factorisation runs in bf16."""
    nmf = ham_head.NMF2D(HAM).eval()
    x = to_nchw(nmf_input()).bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = nmf(x)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, nmf(x.float()).bfloat16())


def test_registries_and_unported_features():
    assert BACKBONE.get("MSCAN") is mscan.MSCAN
    assert DECODEHEAD.get("LightHamHead") is ham_head.LightHamHead
    for kw in (dict(frozen_stages=1), dict(with_cp=True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            mscan.MSCAN(**kw)


LOGIT_SHARE, ARGMAX_AGREE = 2.0 ** -4, 0.98


@pytest.mark.slow
def test_tiny_segnext_bf16_forward_matches_jax(steps):
    """Train-mode ``forward_train`` under the bf16 policy from the same
    weights and bases: the decode logits in bf16 within 2**-4 of the
    largest |logit| and 98 % equal argmax, the loss at rtol 1e-2."""
    config = "segnext/segnext_mscan-t"
    variables, (_, _, _, (losses, logits)) = steps
    assert logits[config].dtype == jnp.bfloat16
    ref = np.asarray(jnp.asarray(logits[config]).astype(jnp.float32))
    model = tiny_model(config, variables).train()
    img, gt = tiny_batch()
    with torch.no_grad(), same_bases(), policy_scope("bf16"):
        out, loss_dict = model.forward_train(to_nchw(img),
                                             torch.from_numpy(gt).long())
        loss, _ = train_state.parse_losses(loss_dict)
    assert out["decode"].dtype == torch.bfloat16
    out = to_nhwc(out["decode"].float())
    assert np.abs(out - ref).max() <= LOGIT_SHARE * np.abs(ref).max()
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= ARGMAX_AGREE
    ref_loss = sum(float(v) for k, v in losses[config].items() if "loss" in k)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-2)
