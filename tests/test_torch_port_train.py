"""The train path against the JAX package, on the CPU.

The tiny SETR-PUP (configs/network/setr/setr_pup_vit-s.py cut to 2 layers
of width 32, 2 heads, patch 8, with its aux head; drop path off) on 40²
images whose labels hold ignored pixels: ``forward_train``'s loss dict, and
every parameter and BatchNorm running statistic after one and after three
SGD steps of ``make_train_step`` (the kvasir schedule's SGD: lr 0.01,
momentum 0.9, weight decay 5e-4), read back through ``bridge.py``, equal
the JAX ``make_train_step``'s with the JAX ``build_optimizer``: losses at
rtol 1e-5 / atol 1e-5, accuracy exactly, states at rtol 1e-4 / atol 1e-5
(float32 sums in another order, through forward, backward and update).
Attention runs the plain versions here: the JAX einsum path, the port's
``FlashAttention`` Function with its plain backward.  Optimizer
trajectories and schedules are held to float32 rounding.
"""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402
                                init_jax, tiny_flagship_cfg,
                                tiny_setr_network, to_nchw, to_nhwc)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import LR_SCHEDULER as JLR  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_from_cfg as jbuild_from_cfg  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.core.builder import (  # noqa: E402
    LR_SCHEDULER, build_from_cfg, build_optimizer)
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402

SCHEDULE = load_python_config("configs/schedule/kvasir_training_schedule.py")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
IGNORE = 255


def batch(n=2, size=40, seed=7):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, size, size, 3).astype(np.float32)
    gt = rng.randint(0, 2, (n, size, size)).astype(np.int32)
    gt[rng.rand(n, size, size) < 0.1] = IGNORE
    return img, gt


def jax_variables(network, size=40):
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, size, size, 3)),
                         jnp.zeros((1, size, size), jnp.int32),
                         method="forward_train", train=False)
    return jm, variables


def jax_forward_train(jm, variables, img, gt):
    fn = compile_quickly(jax.jit(lambda v, i, g: jm.apply(
        v, i, g, method="forward_train", train=True,
        mutable=["batch_stats"])[0][1]), variables, img, gt)
    return {k: np.asarray(v) for k, v in fn(variables, img, gt).items()}


def port_forward_train(network, variables, img, gt):
    model = bridge(build_segmentor(network), variables).train()
    with torch.enable_grad():
        _, losses = model.forward_train(to_nchw(img),
                                        torch.from_numpy(gt).long())
    return {k: v.detach().numpy() for k, v in losses.items()}


def assert_loss_dicts_equal(out, ref):
    assert sorted(out) == sorted(ref)
    for key in ref:
        tol = dict(rtol=1e-6, atol=0) if "acc" in key else LOSS_TOL
        np.testing.assert_allclose(out[key], ref[key], err_msg=key, **tol)


@pytest.fixture(scope="module")
def setr():
    network = tiny_setr_network()
    network["backbone"]["drop_path_rate"] = 0.0
    jm, variables = jax_variables(network)
    return network, jm, variables


def test_setr_forward_train_matches_jax(setr):
    network, jm, variables = setr
    img, gt = batch()
    ref = jax_forward_train(jm, variables, img, gt)
    assert sorted(ref) == ["aux.acc_seg", "aux.loss_ce", "decode.acc_seg",
                           "decode.loss_ce"]
    assert_loss_dicts_equal(port_forward_train(network, variables, img, gt),
                            ref)


def test_aux_head_list_and_rescale_match_jax():
    """A list of aux heads gives ``aux_<i>`` keys; with ``rescale`` the
    logits come back at ``ori_img_size_hw``."""
    network = tiny_setr_network()
    network["backbone"]["drop_path_rate"] = 0.0
    aux = network["auxiliary_head"]
    network["auxiliary_head"] = [aux, dict(aux, in_index=1, num_convs=2,
                                           up_scale=2)]
    jm, variables = jax_variables(network)
    img, gt = batch(seed=10)
    meta = {"ori_img_size_hw": (30, 36)}
    fn = compile_quickly(jax.jit(lambda v, i, g: jm.apply(
        v, i, g, meta, rescale=True, method="forward_train", train=True,
        mutable=["batch_stats"])[0]), variables, img, gt)
    ref_logits, ref_losses = fn(variables, img, gt)
    model = bridge(build_segmentor(network), variables).train()
    with torch.enable_grad():
        logits, losses = model.forward_train(
            to_nchw(img), torch.from_numpy(gt).long(), meta, rescale=True)
    assert sorted(losses) == sorted(ref_losses) == [
        "aux_0.acc_seg", "aux_0.loss_ce", "aux_1.acc_seg", "aux_1.loss_ce",
        "decode.acc_seg", "decode.loss_ce"]
    assert_loss_dicts_equal({k: v.detach().numpy() for k, v in losses.items()},
                            {k: np.asarray(v) for k, v in ref_losses.items()})
    for out, ref in ((logits["decode"], ref_logits["decode"]),
                     (logits["aux"][1], ref_logits["aux"][1])):
        assert out.shape == (2, 2, 30, 36)
        np.testing.assert_allclose(to_nhwc(out), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


def test_deeplabv3_forward_train_matches_jax():
    """The flagship structure's ASPP decode head and FCN aux head (softmax
    CE, aux weight 0.4), head dropout off."""
    network = tiny_flagship_cfg()
    for head in ("decode_head", "auxiliary_head"):
        network[head]["dropout_ratio"] = 0.0
    jm, variables = jax_variables(network, size=32)
    img, gt = batch(size=32, seed=8)
    ref = jax_forward_train(jm, variables, img, gt)
    assert_loss_dicts_equal(port_forward_train(network, variables, img, gt),
                            ref)


def port_state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_setr_train_steps_match_jax(setr):
    """One and three steps; the kvasir StepLR at step_size 1 so that the
    three steps run at three rates (0.01, 0.001, 0.0001)."""
    network, jm, variables = setr
    img, gt = batch(seed=9)
    lr_config = dict(SCHEDULE["lr_config"], step_size=1)
    base_lr = SCHEDULE["optimizer"]["lr"]

    schedule = jbuild_from_cfg(lr_config, JLR).schedule(base_lr, 1)
    tx = jbuild_optimizer({**SCHEDULE["optimizer"], "lr": schedule})
    params = variables["params"]
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               frozen_params={},
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(params))
    jstep = jtrain.make_train_step(jm, tx, donate=False)

    model = bridge(build_segmentor(network), variables)
    state = train_state.create_train_state(model, SCHEDULE["optimizer"],
                                           lr_config, steps_per_epoch=1)
    step = train_state.make_train_step(state.model, state.optimizer,
                                       state.scheduler)
    generator = torch.Generator().manual_seed(0)
    x, y = to_nchw(img), torch.from_numpy(gt).long()
    for i in range(3):
        jstate, jlog = jstep(jstate, img, gt, jax.random.PRNGKey(i))
        log = step(x, y, generator)
        assert_loss_dicts_equal({k: v.numpy() for k, v in log.items()},
                                {k: np.asarray(v) for k, v in jlog.items()})
        if i in (0, 2):
            ref = bridge(build_segmentor(network), jstate.variables())
            ref_state, out_state = port_state(ref), port_state(model)
            assert sorted(out_state) == sorted(ref_state)
            for key, value in ref_state.items():
                np.testing.assert_allclose(out_state[key], value,
                                           err_msg=f"step {i + 1}: {key}",
                                           **STATE_TOL)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)
    bn = model.decode_head.up_convs[0].bn
    assert bn.num_batches_tracked == 3


def test_parse_losses_matches_jax():
    losses = {"decode.loss_ce": np.float32(0.5),
              "decode.acc_seg": np.float32(80.0),
              "aux.loss_ce": np.array([0.1, 0.3], np.float32)}
    jloss, jlog = jtrain.parse_losses({k: jnp.asarray(v)
                                       for k, v in losses.items()})
    loss, log = train_state.parse_losses({k: torch.from_numpy(np.asarray(v))
                                          for k, v in losses.items()})
    assert sorted(log) == sorted(jlog)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-6)
    for key in jlog:
        np.testing.assert_allclose(log[key].numpy(), np.asarray(jlog[key]),
                                   rtol=1e-6)


OPTIMIZERS = {
    "sgd_kvasir": dict(SCHEDULE["optimizer"]),
    "sgd_nesterov": dict(type="SGD", lr=0.05, momentum=0.9, nesterov=True),
    "adam": dict(type="Adam", lr=1e-2, weight_decay=1e-2),
    "adamw": dict(type="AdamW", lr=1e-2, betas=(0.8, 0.99), eps=1e-6,
                  weight_decay=0.05),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_jax(name):
    """Five steps on a quadratic whose gradients depend on the iterate."""
    cfg = OPTIMIZERS[name]
    rng = np.random.RandomState(0)
    p0, target = (rng.randn(4, 3).astype(np.float32) for _ in range(2))

    def loss(p, t):
        return ((p - t) ** 2 * (1 + p ** 2)).sum()

    tx = jbuild_optimizer(dict(cfg))
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    for _ in range(5):
        grads = jax.grad(loss)(params, jnp.asarray(target))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer = build_optimizer(dict(cfg), [p])
    for _ in range(5):
        optimizer.zero_grad()
        with torch.enable_grad():
            loss(p, torch.from_numpy(target)).backward()
        optimizer.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               rtol=1e-5, atol=1e-6)


def test_unported_optimizer_options_raise():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(dict(type="RMSprop", lr=0.1), p)
    with pytest.raises(NotImplementedError, match="paramwise"):
        build_optimizer(dict(type="SGD", lr=0.1,
                             paramwise_cfg=dict(norm_decay_mult=0.0)), p)
    with pytest.raises(AssertionError, match="dampening"):
        build_optimizer(dict(type="SGD", lr=0.1, dampening=0.5), p)


SCHEDULERS = {
    "step": dict(type="StepLR", step_size=3, gamma=0.5),
    "poly": dict(type="PolynomialLR", total_iters=20, power=0.9),
    "exp": dict(type="ExponentialLR", gamma=0.9),
    "lambda": dict(type="LambdaLR", lr_lambda=lambda e: 1.0 / (1 + e)),
    "warm_after": dict(type="WarmScheduler", warmup_epochs=4,
                       mode="exponential", start_lr=1e-4,
                       after=dict(type="StepLR", step_size=5, gamma=0.3)),
    "warm_linear": dict(type="WarmScheduler", warmup_iters=6,
                        warmup_ratio=0.2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax_over_100_steps(name):
    """``steps_per_epoch=4``: the rate of each of 100 updates, as
    ``LambdaLR`` sets it, against the JAX schedule at that step."""
    base_lr = 0.02
    ref = jbuild_from_cfg(SCHEDULERS[name], JLR).schedule(base_lr, 4)
    optimizer = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))],
                                lr=base_lr)
    scheduler = build_from_cfg(SCHEDULERS[name], LR_SCHEDULER)
    torch_scheduler = scheduler.torch_scheduler(optimizer, 4)
    rates = []
    for _ in range(100):
        rates.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        torch_scheduler.step()
    np.testing.assert_allclose(
        rates, [float(ref(jnp.asarray(s))) for s in range(100)], rtol=1e-6)
    assert scheduler.schedule(base_lr, 4)(37) == pytest.approx(rates[37])


def drop_setr():
    """The tiny SETR with stochastic depth 0.5 and head dropout 0.2."""
    network = tiny_setr_network()
    network["backbone"]["drop_path_rate"] = 0.5
    for head in ("decode_head", "auxiliary_head"):
        network[head]["dropout_ratio"] = 0.2
    torch.manual_seed(0)
    return build_segmentor(network)


def test_train_steps_draw_only_from_the_given_generator():
    """Equally seeded generators give equal steps, other seeds other steps,
    and nothing is drawn from torch's global generator."""
    base = drop_setr()
    img, gt = batch(seed=11)
    x, y = to_nchw(img), torch.from_numpy(gt).long()

    def two_steps(seed):
        state = train_state.create_train_state(copy.deepcopy(base),
                                               SCHEDULE["optimizer"])
        step = train_state.make_train_step(state.model, state.optimizer)
        generator = torch.Generator().manual_seed(seed)
        logs = [step(x, y, generator) for _ in range(2)]
        return logs, port_state(state.model)

    rng_before = torch.random.get_rng_state()
    logs_a, state_a = two_steps(0)
    logs_b, state_b = two_steps(0)
    logs_c, state_c = two_steps(1)
    assert torch.equal(torch.random.get_rng_state(), rng_before)
    for log_a, log_b in zip(logs_a, logs_b):
        assert all(torch.equal(log_a[k], log_b[k]) for k in log_a)
    assert all(np.array_equal(state_a[k], state_b[k]) for k in state_a)
    assert any(not torch.equal(a["loss"], c["loss"])
               for a, c in zip(logs_a, logs_c))
    assert any(not np.array_equal(state_a[k], state_c[k]) for k in state_a)


def test_sampler_raises_in_losses():
    network = tiny_setr_network()
    network["decode_head"]["sampler"] = dict(type="OHEMPixelSampler")
    model = build_segmentor(network).eval()
    img, gt = batch(n=1)
    with pytest.raises(NotImplementedError, match="OHEM"):
        model.forward_train(to_nchw(img), torch.from_numpy(gt).long())
