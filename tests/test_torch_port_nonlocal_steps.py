"""The ten ResNetV1c-d8 configs of the non-local slice against the JAX
package, on the CPU (slow-marked).

Each config (``deeplabv3plus_r50-d8`` and the NL, DNL, GC, CC, DA, ANN,
ISA, EMA and PSA configs) is cut to a tiny model: ResNetV1c-18 with stem
and base width 8 (stage widths 8/16/32/64), the decode head at 16 channels
(ANN's projections, ISA's attention and EMA's bases at 8, DA's PAM at 4,
PSA's mask 9 x 9, DeepLabV3+'s c1 branch 8 -> 4), the FCN aux head at 8,
no dropout; 80² images, so the d8 map is 10² (ISA pads it to 16², PSA
shrinks it to 5²).  The losses are the configs' own (sigmoid
cross-entropy, the aux head at 0.4, DA's ``pam.``/``cam.`` terms).

One SGD step of the kvasir schedule from the same seeded weights,
against the JAX package's step run in float64 (one compiled program per
config, ``torch_port_helpers.jax_in_float64``): the port's float32 step
with its decode logits at rtol 1e-3 / atol 3e-3, every loss (and
``acc_seg``) within rtol 1e-5, and every gradient and parameter after the
update and every updated buffer (EMA's ``bases`` among them) within rtol
1e-4 / atol 1e-5 (the gradients plus 1e-4 of each tensor's largest
value); the port's float64 step, all of these within rtol 1e-6 / atol
1e-6.  JAX's own float32 step is no truth here: its BatchNorm's one-pass
variance (``E[x²] - E[x]²``) cancels at batch 2 on DeepLabV3+'s image
pool and on the attention heads' averaged maps, which moves its float32
gradients by up to 8e-3 from its float64 step.  The full-width configs'
JAX variables (EMA's ``bases`` from the ``batch_stats`` collection among
them) load strictly into the port and come back bit for bit.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import optax  # noqa: E402
from test_torch_port_realtime import SCHEDULE, port_grads  # noqa: E402
from torch_port_helpers import (as_float64, bridge,  # noqa: E402
                                compile_quickly, init_jax, jax_in_float64,
                                to_nchw, to_nhwc)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import LR_SCHEDULER as JLR  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_from_cfg as jbuild_from_cfg  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.core.initialize.checkpoint import \
    state_dict_from_variables  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_name, jax_state_dict, mapped_state_dict)
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.models.basic import \
    LayerNorm  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402

TINY_SIZE = 80
TOL = dict(rtol=1e-4, atol=1e-5)
EXACT = dict(rtol=1e-6, atol=1e-6)
TINY_BACKBONE = dict(depth=18, stem_channels=8, base_channels=8)
# config: its decode head cut to size
TINY_HEADS = {
    "deeplabv3/deeplabv3plus_r50-d8": dict(in_channels=64, channels=16,
                                           c1_in_channels=8, c1_channels=4),
    "nonlocal_net/nonlocal_r50-d8": dict(in_channels=64, channels=16),
    "dnlnet/dnl_r50-d8": dict(in_channels=64, channels=16),
    "gcnet/gcnet_r50-d8": dict(in_channels=64, channels=16),
    "ccnet/ccnet_r50-d8": dict(in_channels=64, channels=16),
    "danet/danet_r50-d8": dict(in_channels=64, channels=16, pam_channels=4),
    "ann/ann_r50-d8": dict(in_channels=[32, 64], channels=16,
                           project_channels=8),
    "isanet/isanet_r50-d8": dict(in_channels=64, channels=16,
                                 isa_channels=8),
    "emanet/emanet_r50-d8": dict(in_channels=64, channels=16,
                                 ema_channels=16, num_bases=8),
    "psanet/psanet_r50-d8": dict(in_channels=64, channels=16,
                                 mask_size=(9, 9)),
}
CONFIGS = tuple(TINY_HEADS)


def tiny_network(config):
    """The config cut to size (see the module docstring)."""
    network = load_python_config(f"configs/network/{config}.py")["model"]
    network["backbone"].update(TINY_BACKBONE)
    network["decode_head"].update(TINY_HEADS[config], dropout_ratio=0.0)
    network["auxiliary_head"].update(in_channels=32, channels=8,
                                     dropout_ratio=0.0)
    return network


def tiny_batch(n=2, seed=9):
    """Images, and 8 x 8-pixel blob labels with 10 % ignored pixels."""
    rng = np.random.RandomState(seed)
    img = rng.randn(n, TINY_SIZE, TINY_SIZE, 3).astype(np.float32)
    gt = np.kron(rng.randint(0, 2, (n, 10, 10)), np.ones((8, 8), int))
    gt = gt.astype(np.int32)
    gt[rng.rand(*gt.shape) < 0.1] = 255
    return img, gt


def jax_step(config):
    """The JAX side of one step, run in float64 (``jax_in_float64``): the
    float32 variables it starts from, the train-mode losses and decode
    logits, the gradients, the parameters after the SGD update and the
    updated ``batch_stats``."""
    img, gt = tiny_batch()
    model = jax_build(tiny_network(config))
    variables = init_jax(model, img, gt, img_metas={}, rescale=False,
                         return_loss=True, train=True)
    variables64, img = as_float64(variables), img.astype(np.float64)
    lr = jbuild_from_cfg(SCHEDULE["lr_config"], JLR).schedule(
        SCHEDULE["optimizer"]["lr"], 1)
    tx = jbuild_optimizer({**SCHEDULE["optimizer"], "lr": lr})

    def loss_fn(params):
        (outs, losses), state = model.apply(
            {**variables64, "params": params}, img, gt, train=True,
            method="forward_train", mutable=["batch_stats"])
        return jtrain.parse_losses(losses)[0], (losses, outs["decode"],
                                                state)

    def run(params):
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return aux, grads, optax.apply_updates(params, updates)

    params = variables64["params"]
    with jax_in_float64():
        out = compile_quickly(jax.jit(run), params)(params)
        return variables, jax.device_get(out)


def run_step(config, variables, dtype=torch.float32):
    """One SGD step of the port from the JAX variables: the model, its
    train-mode decode logits and losses; in float64 with LayerNorm in the
    input's dtype (the port's casts to float32)."""
    model = bridge(build_segmentor(tiny_network(config)), variables).to(dtype)
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
    with contextlib.ExitStack() as stack:
        if dtype == torch.float64:
            stack.enter_context(mock.patch.object(
                LayerNorm, "forward", lambda self, x: F.layer_norm(
                    x, self.normalized_shape, self.weight, self.bias,
                    self.eps)))
        step(to_nchw(img).to(dtype), torch.from_numpy(gt).long(),
             torch.Generator().manual_seed(0))
    return model, seen[0]


def buffers(model):
    """The updated buffers (BN statistics, EMA's bases) under JAX names."""
    names = {jax_name(b) for b, _ in model.named_buffers()}
    return {k: v.astype(np.float64) for k, v in jax_state_dict(model).items()
            if k in names}


def assert_close_dicts(got, want, scaled=False, **tol):
    """Each of ``got``'s arrays within ``tol`` of ``want``'s (with
    ``scaled``, the atol plus the rtol of the tensor's largest value)."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        value = np.asarray(value, np.float64)
        atol = tol["atol"] + (tol["rtol"] * np.abs(value).max()
                              if scaled else 0.0)
        np.testing.assert_allclose(got[key], value, rtol=tol["rtol"],
                                   atol=atol, err_msg=key)


@pytest.mark.slow
@pytest.mark.parametrize("config", CONFIGS)
def test_tiny_sgd_step_matches_jax(config):
    """The port's float32 and float64 steps against JAX's in float64, at
    the tolerances of the module docstring."""
    variables, ((losses, logits, state), grads, params) = jax_step(config)
    model, (decode, loss_dict) = run_step(config, variables)
    exact, (_, exact_losses) = run_step(config, variables, torch.float64)
    assert decode.shape == (2, 2, TINY_SIZE, TINY_SIZE)
    np.testing.assert_allclose(to_nhwc(decode), logits, rtol=1e-3,
                               atol=3e-3)
    grads = state_dict_from_variables({"params": grads})
    params = state_dict_from_variables({"params": params})
    state = state_dict_from_variables(state)
    for port, port_losses, loss_rtol, tol in (
            (model, loss_dict, 1e-5, TOL), (exact, exact_losses, 1e-6, EXACT)):
        assert_close_dicts({k: float(v) for k, v in port_losses.items()},
                           losses, rtol=loss_rtol, atol=0.0)
        assert_close_dicts(port_grads(port), grads, scaled=True, **tol)
        assert_close_dicts({k: v for k, v in jax_state_dict(port).items()
                            if k in params}, params, **tol)
        assert_close_dicts(buffers(port), state, **tol)


@pytest.mark.slow
@pytest.mark.parametrize("config", CONFIGS)
def test_bridge_loads_the_full_size_configs_strictly_both_ways(config):
    """The full-width config's JAX train-init variables (EMA's bases in
    ``batch_stats``, CC's and DA's scalar ``gamma``s) load strictly into
    the port and come back under the same names, shapes and layouts, bit
    for bit."""
    network = load_python_config(f"configs/network/{config}.py")["model"]
    jm = jax_build(network)
    img, gt = np.zeros((1, 64, 64, 3), np.float32), np.zeros((1, 64, 64),
                                                             np.int32)
    variables = init_jax(jm, img, gt, img_metas={}, rescale=False,
                         return_loss=True, train=True)
    want = state_dict_from_variables(variables)
    pm = build_segmentor(network)
    assert len(mapped_state_dict(pm, want)) == len(want)
    bridge(pm, variables)
    got = jax_state_dict(pm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert sum(v.size for v in want.values()) > 30_000_000
