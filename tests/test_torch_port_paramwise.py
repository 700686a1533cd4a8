"""``paramwise_cfg`` as torch param groups against the JAX package's
per-leaf multipliers, on the CPU; the tiny BEiT and MAE UPerNets under
``beit_finetune_schedule.py`` (layer decay 0.9 over 12 layers, the decode
head at ``lr_mult`` 10); resume under that schedule.

* Every parameter's JAX path (``bridge.jax_name`` joined by '/') is a leaf
  path of the JAX variables, and its ``(lr_mult, decay_mult)`` is what the
  JAX ``ParamwiseRules`` give it, on the full-width UPerNet-BEiT-B and
  UPerNet-Swin-T, for the BEiT schedule's cfg and for one with custom
  keys (one with ``decay_mult``), bias and norm decay mults; each group
  holds exactly the parameters of one pair, at ``lr = base·lr_mult``
  and ``weight_decay = base·decay_mult``.
* Trajectories: three steps of SGD (momentum), Adam and AdamW, with both
  cfgs and the BEiT schedule's warmup (one step an epoch), on parameters
  at paths that meet every rule (embeddings, blocks, norms, biases, the
  neck and the heads), under a loss ``sum(A · tanh(p) + p² / 2)`` that both
  packages differentiate: each step's loss (rtol 1e-5) and the
  parameters after the third (rtol 1e-4 / atol 1e-5), and each group's lr
  at each step equal to ``base_lr · lr_mult · schedule``.
* The tiny BEiT and MAE UPerNets: one float32 ``make_train_step`` each,
  held as ``test_torch_port_upernet_backbones.check_tiny_step`` holds
  Swin's, and BEiT's bf16 step at the amp gates.
* Resume: two steps, a checkpoint (``save_checkpoint`` with
  ``pack_train_state``), a fresh model and state restored from it and two
  more steps give the parameters of four uninterrupted steps within 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_port_upernet_backbones import (  # noqa: E402
    BEIT_SCHEDULE, check_tiny_bf16_step, check_tiny_step, tiny_network)
from torch_port_helpers import compile_quickly  # noqa: E402

from image_segmentation_lab_tpu.core import LR_SCHEDULER as JLR  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_from_cfg as jbuild_from_cfg  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.core.initialize.checkpoint import \
    state_dict_from_variables  # noqa: E402
from image_segmentation_lab_tpu.core.optimizers.paramwise import \
    ParamwiseRules as JRules  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_state_dict, load_jax_state_dict)
from image_segmentation_lab_tpu_torch.core.builder import \
    build_optimizer  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.core.initialize.checkpoint import (  # noqa: E402,E501
    load_file, pack_train_state, save_checkpoint, unpack_train_state)
from image_segmentation_lab_tpu_torch.core.optimizers.paramwise import (  # noqa: E402,E501
    ParamwiseRules, jax_path)
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3
CFGS = {
    "layer_decay": BEIT_SCHEDULE["optimizer"]["paramwise_cfg"],
    "custom_keys": dict(custom_keys={
        "decode_head": dict(lr_mult=10.0),
        "neck": dict(lr_mult=2.0, decay_mult=0.5),
        "block1": dict(lr_mult=0.5)},
        bias_decay_mult=0.0, norm_decay_mult=0.3),
}
OPTIMIZERS = {"SGD": dict(type="SGD", lr=0.1, momentum=0.9,
                          weight_decay=0.05),
              "Adam": dict(type="Adam", lr=1e-2, weight_decay=0.05),
              "AdamW": dict(type="AdamW", lr=1e-2, weight_decay=0.05)}


def jax_leaf_paths(variables):
    """``{'/'-joined path: ndim}`` of the JAX ``params`` leaves."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            variables["params"])[0]:
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        out[path] = len(leaf.shape)
    return out


@functools.lru_cache(maxsize=None)
def full_size(config):
    """The network of ``config`` and its JAX leaves, on shapes alone."""
    network = load_python_config(f"configs/network/{config}.py")["model"]
    shapes = jax.eval_shape(lambda: jax_build(network).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64), jnp.int32), method="forward_train"))
    return network, jax_leaf_paths(shapes)


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("config", ["beit/upernet_beit-b",
                                    "upernet/upernet_swin-t"])
def test_multipliers_are_the_jax_rules(config, cfg):
    network, leaves = full_size(config)
    with torch.device("meta"):
        model = build_segmentor(network)
    named = list(model.named_parameters())
    assert sorted(jax_path(n) for n, _ in named) == sorted(leaves)
    rules, jrules = ParamwiseRules(CFGS[cfg]), JRules(CFGS[cfg], 0.05)
    pairs = {}
    for name, p in named:
        path = jax_path(name)
        pair = rules.mults(path, p.dim())
        assert pair == jrules.mults(path, leaves[path]), path
        pairs.setdefault(pair, []).append(p)
    optimizer = build_optimizer(dict(type="AdamW", lr=3e-5,
                                     weight_decay=0.05, paramwise_cfg=CFGS[
                                         cfg]), named)
    assert len(optimizer.param_groups) == len(pairs) > 3
    for group in optimizer.param_groups:
        pair = (group["lr_mult"], group["decay_mult"])
        assert [id(p) for p in group["params"]] == [id(p)
                                                    for p in pairs[pair]]
        assert group["lr"] == 3e-5 * pair[0]
        assert group["weight_decay"] == 0.05 * pair[1]


def test_paramwise_needs_parameter_names():
    with pytest.raises(NotImplementedError, match="name"):
        build_optimizer(dict(type="SGD", lr=0.1, paramwise_cfg=CFGS[
            "custom_keys"]), [torch.nn.Parameter(torch.zeros(2))])


# parameter paths that meet every rule: the embeddings, blocks 0 and 3,
# norms and biases in the backbone, the neck, the heads; (path, shape)
PATHS = [("backbone/patch_embed_proj/weight", (8, 3, 2, 2)),
         ("backbone/patch_embed_proj/bias", (8,)),
         ("backbone/cls_token", (1, 1, 8)),
         ("backbone/pos_embed", (1, 5, 8)),
         ("backbone/block0/attn/qkv/weight", (24, 8)),
         ("backbone/block0/attn/q_bias", (8,)),
         ("backbone/block0/attn/relative_position_bias_table", (12, 2)),
         ("backbone/block0/norm1/weight", (8,)),
         ("backbone/block1/gamma_1", (8,)),
         ("backbone/block1/fc1/weight", (16, 8)),
         ("backbone/block3/fc2/bias", (8,)),
         ("neck/up4_deconv1/weight", (8, 8, 2, 2)),
         ("neck/ops_4_norm/bias", (8,)),
         ("decode_head/fpn_bottleneck/conv/weight", (4, 8, 3, 3)),
         ("decode_head/fpn_bottleneck/bn/weight", (4,)),
         ("decode_head/conv_seg/bias", (2,)),
         ("auxiliary_head/convs_0/conv/weight", (4, 8, 3, 3))]


class PathModel(torch.nn.Module):
    """Parameters at ``PATHS`` (port names: '/' -> '.')."""

    def __init__(self, values):
        super().__init__()
        for path, _ in PATHS:
            *parents, leaf = path.split("/")
            node = self
            for part in parents:
                if not hasattr(node, part):
                    node.add_module(part, torch.nn.Module())
                node = getattr(node, part)
            node.register_parameter(leaf, torch.nn.Parameter(
                torch.from_numpy(values[path].copy())))


def nested(values):
    """``{path: array}`` as the nested dict of a JAX ``params`` tree."""
    tree = {}
    for path, value in values.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def path_values(seed):
    rng = np.random.RandomState(seed)
    return {path: rng.randn(*shape).astype(np.float32)
            for path, shape in PATHS}


@pytest.fixture(scope="module")
def trajectories():
    """Every JAX trajectory from ``path_values(0)`` under the loss weights
    ``path_values(1)``: per optimizer and cfg the three steps' losses and
    the parameters after them."""
    weights = nested(path_values(1))

    def loss_fn(params):
        return sum(jnp.sum(a * jnp.tanh(p) + 0.5 * p * p) for a, p in zip(
            jax.tree_util.tree_leaves(weights),
            jax.tree_util.tree_leaves(params)))

    def run(tx, params):
        def body(carry, _):
            params, state = carry
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, state = tx.update(grads, state, params)
            return (jax.tree_util.tree_map(jnp.add, params, updates),
                    state), loss

        (params, _), losses = jax.lax.scan(body, (params, tx.init(params)),
                                           None, length=STEPS)
        return losses, params

    schedule = jbuild_from_cfg(BEIT_SCHEDULE["lr_config"], JLR)
    txs = {(opt, cfg): jbuild_optimizer(
        {**OPTIMIZERS[opt], "paramwise_cfg": CFGS[cfg],
         "lr": schedule.schedule(OPTIMIZERS[opt]["lr"], 1)})
        for opt in OPTIMIZERS for cfg in CFGS}
    params = nested(path_values(0))
    fn = jax.jit(lambda p: {k: run(tx, p) for k, tx in txs.items()})
    return jax.device_get(compile_quickly(fn, params)(params))


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_trajectories_match_jax(opt, cfg, trajectories):
    losses, params = trajectories[(opt, cfg)]
    model = PathModel(path_values(0))
    weights = path_values(1)
    named = {n: (p, torch.from_numpy(weights[jax_path(n)]))
             for n, p in model.named_parameters()}
    assert len(named) == len(PATHS)
    state = train_state.create_train_state(
        model, dict(OPTIMIZERS[opt], paramwise_cfg=CFGS[cfg]),
        BEIT_SCHEDULE["lr_config"])
    assert len(state.optimizer.param_groups) > 3
    rate = jbuild_from_cfg(BEIT_SCHEDULE["lr_config"], JLR).schedule(
        OPTIMIZERS[opt]["lr"], 1)
    for step in range(STEPS):
        state.optimizer.zero_grad()
        with torch.enable_grad():
            loss = sum((a * torch.tanh(p) + 0.5 * p * p).sum()
                       for p, a in named.values())
            loss.backward()
        np.testing.assert_allclose(float(loss.detach()),
                                   float(losses[step]), rtol=1e-5)
        for group in state.optimizer.param_groups:  # the rule in float32
            np.testing.assert_allclose(group["lr"], float(rate(step))
                                       * group["lr_mult"], rtol=1e-6)
        state.optimizer.step()
        state.scheduler.step()
    for path, value in state_dict_from_variables({"params": params}).items():
        np.testing.assert_allclose(
            named[path.replace("/", ".")][0].detach().numpy(), value,
            err_msg=path, **TOL)


@pytest.mark.parametrize("name", ["beit", "mae"])
def test_tiny_upernet_train_step_matches_jax(name):
    check_tiny_step(name)


def test_tiny_beit_upernet_bf16_forward_and_step_match_jax():
    check_tiny_bf16_step("beit")


def test_resume_under_the_beit_schedule_equals_the_uninterrupted_run(
        tmp_path):
    network = tiny_network("beit")
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 2, (2, 64, 64))))
               for _ in range(4)]

    def fresh():
        torch.manual_seed(0)
        model = build_segmentor(network)
        state = train_state.create_train_state(
            model, BEIT_SCHEDULE["optimizer"], BEIT_SCHEDULE["lr_config"])
        return state, train_state.make_train_step(
            state.model, state.optimizer, state.scheduler)

    def run(state, step, todo):
        for img, gt in todo:
            step(img, gt, torch.Generator().manual_seed(0))
            state.step += 1

    whole, step = fresh()
    run(whole, step, batches)
    first, step = fresh()
    run(first, step, batches[:2])
    save_checkpoint(first.model, tmp_path / "last.pth",
                    train_state=pack_train_state(first))
    resumed, step = fresh()
    ckpt = load_file(tmp_path / "last.pth")
    load_jax_state_dict(resumed.model, ckpt["state_dict"])
    resumed.model.train()
    unpack_train_state(resumed, ckpt["train_state"], "last.pth")
    assert len(resumed.optimizer.param_groups) > 4
    run(resumed, step, batches[2:])
    assert resumed.step == whole.step == 4
    ref, got = jax_state_dict(whole.model), jax_state_dict(resumed.model)
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6,
                                   err_msg=key)
