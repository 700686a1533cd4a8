"""Checkpoints, the weight bridge's inverse, the ``init_cfg`` hooks, EMA,
seeding, run directories and the environment record of the PyTorch port,
against the JAX package, on the CPU (``tiny_flagship_cfg``: the
flagship's structure at depth 18, stage widths 8-64).

- ``bridge.jax_state_dict`` is the JAX package's state dict of the same
  weights, and round-trips through ``load_jax_state_dict`` bit for bit.
- A port ``save_checkpoint`` file loads strictly through the JAX
  ``load_checkpoint`` (and unpickles with numpy alone); a JAX
  ``save_checkpoint`` file loads strictly through the port's.
- ``Constant`` (with a layer filter, a bias and an override) and
  ``Pretrained`` (with ``prefix``, on the backbone) equal the JAX hooks
  exactly; the random initializers match JAX's in distribution (mean and
  std of a conv weight within 3 standard errors of the difference).
- The EMA after 3 steps equals its closed form within 1e-6.
- ``init_random_seed``, ``set_random_seed``, ``increment_path`` (``exp``,
  ``exp2``, ``exp3``), ``mkdir_or_exist`` and ``scandir`` equal the JAX
  package's helpers.
"""

import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (bridge, init_jax, randomize_variables,  # noqa: E402,E501
                                tiny_flagship_cfg)

from image_segmentation_lab_tpu.core.fileio import path as jpath  # noqa: E402
from image_segmentation_lab_tpu.core.initialize import \
    checkpoint as jckpt  # noqa: E402
from image_segmentation_lab_tpu.core.initialize import \
    seed_init as jseed  # noqa: E402
from image_segmentation_lab_tpu.core.initialize import \
    weight_init as jinit  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu_torch.bridge import (  # noqa: E402
    jax_state_dict, load_jax_state_dict)
from image_segmentation_lab_tpu_torch.core.fileio import (  # noqa: E402
    increment_path, mkdir_or_exist, scandir)
from image_segmentation_lab_tpu_torch.core.initialize import (  # noqa: E402
    checkpoint, seed_init, weight_init)
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.utils import ema  # noqa: E402
from image_segmentation_lab_tpu_torch.utils.metadata import \
    get_environment_info  # noqa: E402

SIZE = 32


@pytest.fixture(scope="module")
def pair():
    """(config, JAX variables, the port model with those weights)."""
    cfg = tiny_flagship_cfg()
    variables = init_jax(jax_build(cfg), jnp.zeros((1, SIZE, SIZE, 3)),
                         jnp.zeros((1, SIZE, SIZE), jnp.int32),
                         return_loss=True, train=True)
    return cfg, variables, bridge(build_segmentor(cfg), variables)


def assert_state_dicts_equal(out, ref):
    assert sorted(out) == sorted(ref)
    for name, value in ref.items():
        assert out[name].dtype == np.asarray(value).dtype, name
        np.testing.assert_array_equal(out[name], value, err_msg=name)


def test_jax_state_dict_is_the_jax_state_dict_and_round_trips(pair):
    cfg, variables, model = pair
    state_dict = jax_state_dict(model)
    assert_state_dicts_equal(state_dict,
                             jckpt.state_dict_from_variables(variables))
    fresh = build_segmentor(cfg)
    load_jax_state_dict(fresh, state_dict)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 fresh.state_dict().items()):
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(a, b), name


def test_port_checkpoint_loads_strictly_in_jax(pair, tmp_path):
    cfg, variables, _ = pair
    model = bridge(build_segmentor(cfg), variables)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    with torch.enable_grad():
        sum(p.square().sum() for p in model.parameters()).backward()
    optimizer.step()
    state = type("State", (), dict(model=model, optimizer=optimizer,
                                   scheduler=None, step=1))
    path = tmp_path / "port.pth"
    checkpoint.save_checkpoint(model, path, metadata={"epoch": 0},
                               train_state=checkpoint.pack_train_state(state))
    assert not (tmp_path / "port.pth.tmp").exists()
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    loaded, ckpt = jckpt.load_checkpoint(template, path, strict=True,
                                         logger=None)
    assert_state_dicts_equal(jckpt.state_dict_from_variables(loaded),
                             jax_state_dict(model))
    assert ckpt["metadata"] == {"epoch": 0}
    assert ckpt["train_state"]["framework"] == "torch"
    # every tensor of the train state is numpy: the file needs no torch
    script = ("import pickle, sys; c = pickle.load(open(sys.argv[1], 'rb')); "
              "assert 'torch' not in sys.modules; "
              "print(sorted(c['train_state']))")
    out = subprocess.run([sys.executable, "-c", script, str(path)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.save_checkpoint(model, tmp_path / "o", backend="orbax")


def test_jax_checkpoint_loads_strictly_in_port(pair, tmp_path):
    cfg, variables, _ = pair
    path = tmp_path / "jax.pth"
    jckpt.save_checkpoint(variables, path, metadata={"epoch": 4},
                          train_state={"step": np.asarray(3)})
    model = build_segmentor(cfg)
    ckpt = checkpoint.load_checkpoint(model, path)
    assert ckpt["metadata"] == {"epoch": 4}
    assert_state_dicts_equal(jax_state_dict(model),
                             jckpt.state_dict_from_variables(variables))


def jax_params_after(variables, init_cfg, network_cfg=None):
    params = variables["params"]
    if network_cfg is not None:
        params = jinit.initialize_from_network_cfg(params, network_cfg,
                                                   jax.random.PRNGKey(0))
    else:
        params = jinit.initialize(params, init_cfg, jax.random.PRNGKey(0))
    return jckpt.state_dict_from_variables({**variables, "params": params})


CONSTANT = [dict(type="Constant", val=0.5, bias=0.25, layer=["Conv2d"]),
            dict(type="Constant", val=2.0, layer="BatchNorm2d",
                 override=dict(name="decode_head.conv_seg", type="Constant",
                               val=-1.0, bias=3.0))]


def test_constant_init_equals_jax(pair):
    cfg, variables, _ = pair
    model = bridge(build_segmentor(cfg), variables)
    weight_init.initialize(model, CONSTANT, torch.Generator().manual_seed(0))
    assert_state_dicts_equal(jax_state_dict(model),
                             jax_params_after(variables, CONSTANT))
    info = weight_init.get_init_info()
    assert info["decode_head.conv_seg.weight"].startswith("ConstantInit(")


def test_pretrained_init_with_prefix_equals_jax(pair, tmp_path):
    cfg, variables, _ = pair
    source = randomize_variables(variables, seed=7)
    path = tmp_path / "pretrained.pth"
    jckpt.save_checkpoint(source, path)
    network = dict(cfg, backbone=dict(cfg["backbone"], init_cfg=dict(
        type="Pretrained", checkpoint=str(path), prefix="backbone.")))
    model = bridge(build_segmentor(cfg), variables)
    weight_init.initialize_from_network_cfg(
        model, network, torch.Generator().manual_seed(0))
    ref = jax_params_after(variables, None, network_cfg=network)
    assert_state_dicts_equal(jax_state_dict(model), ref)
    # the backbone's parameters came from the file, its BN statistics and
    # the heads did not
    src = jckpt.state_dict_from_variables(source)
    np.testing.assert_array_equal(ref["backbone.stem_0.weight"],
                                  src["backbone.stem_0.weight"])
    assert not np.array_equal(ref["backbone.stem_1.running_mean"],
                              src["backbone.stem_1.running_mean"])


RANDOM_INITS = [dict(type="Normal", mean=0.1, std=0.02),
                dict(type="Xavier", gain=2.0, distribution="normal"),
                dict(type="Xavier", distribution="uniform"),
                dict(type="Kaiming", mode="fan_in"),
                dict(type="Kaiming", distribution="uniform"),
                dict(type="Caffe2Xavier"),
                dict(type="Uniform", a=-0.3, b=0.1),
                dict(type="TruncNormal", std=0.5, a=-0.4, b=0.8)]


@pytest.mark.parametrize("init_cfg", RANDOM_INITS,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_random_inits_match_jax_in_distribution(init_cfg):
    """On one 3 x 3 conv of 64 -> 128 channels (73,728 draws)."""
    module = torch.nn.ModuleDict({"conv": torch.nn.Conv2d(64, 128, 3)})
    weight_init.initialize(module, init_cfg, torch.Generator().manual_seed(3))
    ref = jinit.initialize({"conv": {"weight": jnp.zeros((3, 3, 64, 128))}},
                           init_cfg, jax.random.PRNGKey(0))
    a = module.conv.weight.detach().numpy().astype(np.float64).ravel()
    b = np.asarray(ref["conv"]["weight"], np.float64).ravel()
    n, sd = a.size, b.std()
    assert abs(a.mean() - b.mean()) <= 3 * np.sqrt(2 / n) * sd
    assert abs(a.std() - b.std()) <= 3 * np.sqrt(1 / n) * sd


def test_ema_after_three_steps_is_the_closed_form():
    model = torch.nn.Conv2d(2, 3, 3)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    targets = [{k: torch.randn_like(v) for k, v in start.items()}
               for _ in range(3)]

    def step(img, gt, generator, _it=iter(targets)):
        values = next(_it)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(values[name])
        return {}

    decay = 0.9
    wrapped, ema_params = ema.wrap_train_step_with_ema(step, model, decay)
    for _ in range(3):
        wrapped(None, None, None)
    for name, e0 in start.items():
        closed = decay ** 3 * e0 + (1 - decay) * (
            decay ** 2 * targets[0][name] + decay * targets[1][name]
            + targets[2][name])
        torch.testing.assert_close(ema_params()[name], closed, rtol=0,
                                   atol=1e-6)
    raw = model.weight.detach().clone()
    with ema.ema_weights(model, ema_params()):
        assert torch.equal(model.weight, ema_params()["weight"])
    assert torch.equal(model.weight, raw)


@pytest.fixture
def restore_rng_and_flags():
    states = (random.getstate(), np.random.get_state(),
              torch.get_rng_state(),
              torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.set_rng_state(states[2])
    torch.use_deterministic_algorithms(states[3])
    torch.backends.cudnn.deterministic = states[4]
    torch.backends.cudnn.benchmark = states[5]


def test_seeds_equal_jax(restore_rng_and_flags):
    assert seed_init.init_random_seed(17) == jseed.init_random_seed(17) == 17
    assert 0 <= seed_init.init_random_seed(None) < 2 ** 31
    jseed.set_random_seed(5)
    ref = (random.random(), np.random.rand())
    assert seed_init.set_random_seed(5, deterministic=True) == 5
    assert (random.random(), np.random.rand()) == ref
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    seed_init.set_random_seed(5)
    assert not torch.are_deterministic_algorithms_enabled()
    streams = {seed_init.derive_seed(5, k, e) for k in (1, 7) for e in (0, 1)}
    assert len(streams) == 4
    assert seed_init.derive_seed(5, 1, 0) == seed_init.derive_seed(5, 1, 0)


def test_path_helpers_equal_jax(tmp_path):
    names = {}
    for package, fn in (("jax", jpath.increment_path),
                        ("port", increment_path)):
        root = tmp_path / package
        names[package] = [fn(root, "train", "exp").name for _ in range(3)]
        assert fn(root, "train", "exp", exist_ok=True).name == "exp"
        assert not fn(root, "val", "exp", mkdir=False).exists()
    assert names["port"] == names["jax"] == ["exp", "exp2", "exp3"]
    mkdir_or_exist(tmp_path / "tree" / "a" / "b")
    mkdir_or_exist(tmp_path / "tree" / "a" / "b")
    for rel in ("x.png", "a/y.png", "a/b/z.jpg", "a/.hidden.png"):
        (tmp_path / "tree" / rel).write_text("")
    for suffix, recursive in ((".png", True), ([".png", ".jpg"], True),
                              (None, False)):
        assert list(scandir(tmp_path / "tree", suffix, recursive)) == list(
            jpath.scandir(tmp_path / "tree", suffix, recursive))


def test_environment_info_names_torch_not_jax():
    info = get_environment_info()
    assert info["torch"] == torch.__version__
    assert {"python", "platform", "argv", "cuda", "cudnn", "devices",
            "device_count"} <= set(info)
    assert not {"jax", "flax", "optax"} & set(info)
    pickle.dumps(info)
