"""The flagship's train-and-validate loop against the JAX package, on the CPU.

The flagship's structure (ResNetV1c-d8 + ASPP + FCN aux, ``tiny_flagship_cfg``
at depth 18, stage widths 8-64) with the flagship's own loss: sigmoid
cross-entropy in both heads, the aux head at weight 1.0; head dropout off
so both packages draw nothing.  Inputs come from a seed with numpy; labels
hold ignored pixels.

- Three ``make_train_step`` steps under the kvasir SGD with StepLR at
  step_size 1 (three rates): each step's loss dict (rtol 1e-5 / atol 1e-5,
  accuracy exactly), and after steps 1 and 3 every parameter and BatchNorm
  running statistic, read back through ``bridge.py``, at rtol 1e-4 / atol
  1e-5 (float32 sums in another order, through forward, backward and
  update); ``num_batches_tracked`` counts the steps (the JAX state keeps
  no such counter).  ``train_one_epoch`` over two batches: the mean log
  values and the state.
- ``make_eval_step`` for a two-channel head and a one-channel head at
  threshold 0.4, without and with ``rescale_size``: the per-head logits
  after ``binarize_channels`` (rtol 1e-4 / atol 1e-4) and the log values;
  ``validate_one_epoch`` over two batches: the evaluator's metrics.
- ``make_tta_step`` at 32² (scaled sides 24, 32, 40) and the segmentor's
  ``forward_test`` / ``batch_test`` / ``aug_test_logits``: probabilities at
  rtol 1e-4 / atol 1e-5; ``pth_metadata``: the same dict.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import (bridge, compile_quickly,  # noqa: E402,E501
                                init_jax, tiny_flagship_train_cfg, to_nchw,
                                to_nhwc)

from image_segmentation_lab_tpu import train_state as jtrain  # noqa: E402
from image_segmentation_lab_tpu.core import LR_SCHEDULER as JLR  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_from_cfg as jbuild_from_cfg  # noqa: E402
from image_segmentation_lab_tpu.core import \
    build_optimizer as jbuild_optimizer  # noqa: E402
from image_segmentation_lab_tpu.core.evaluation import \
    SegEvaluator as JSegEvaluator  # noqa: E402
from image_segmentation_lab_tpu.models.builder import \
    build_segmentor as jax_build  # noqa: E402
from image_segmentation_lab_tpu.utils import \
    train_utils as jtrain_utils  # noqa: E402
from image_segmentation_lab_tpu_torch import train_state  # noqa: E402
from image_segmentation_lab_tpu_torch.core.evaluation import \
    SegEvaluator  # noqa: E402
from image_segmentation_lab_tpu_torch.core.fileio import \
    load_python_config  # noqa: E402
from image_segmentation_lab_tpu_torch.data.pipeline import \
    Pipeline  # noqa: E402
from image_segmentation_lab_tpu_torch.models.builder import \
    build_segmentor  # noqa: E402
from image_segmentation_lab_tpu_torch.utils import train_utils  # noqa: E402

SCHEDULE = load_python_config("configs/schedule/kvasir_training_schedule.py")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROB_TOL = dict(rtol=1e-4, atol=1e-5)
IGNORE = 255
SIZE = 32


def jax_pair(network):
    jm = jax_build(network)
    variables = init_jax(jm, jnp.zeros((1, SIZE, SIZE, 3)),
                         jnp.zeros((1, SIZE, SIZE), jnp.int32),
                         method="forward_train", train=False)
    return jm, variables


def batch(seed, n=2, size=SIZE):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, size, size, 3).astype(np.float32)
    gt = rng.randint(0, 2, (n, size, size)).astype(np.int32)
    gt[rng.rand(n, size, size) < 0.1] = IGNORE
    return img, gt


class Loader(list):
    """A list of batches with the loaders' ``set_epoch``."""

    def set_epoch(self, epoch):
        pass


def assert_loss_dicts_equal(out, ref):
    assert sorted(out) == sorted(ref)
    for key in ref:
        tol = dict(rtol=1e-6, atol=0) if "acc" in key else LOSS_TOL
        np.testing.assert_allclose(out[key], ref[key], err_msg=key, **tol)


def assert_state_equal(model, jstate, what):
    """Parameters and BN running statistics against the JAX state's."""
    ref = bridge(build_segmentor(tiny_flagship_train_cfg()),
                 jstate.variables())
    out_state, ref_state = model.state_dict(), ref.state_dict()
    assert sorted(out_state) == sorted(ref_state)
    for key, value in ref_state.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(out_state[key].numpy(), value.numpy(),
                                       err_msg=f"{what}: {key}", **STATE_TOL)


def jax_state(variables, tx=None):
    params = variables["params"]
    return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             frozen_params={},
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(params) if tx else None)


@pytest.fixture(scope="module")
def flagship():
    """The network, the JAX module and variables, the kvasir SGD with
    StepLR at step_size 1, and the compiled JAX step."""
    network = tiny_flagship_train_cfg()
    jm, variables = jax_pair(network)
    lr_config = dict(SCHEDULE["lr_config"], step_size=1)
    schedule = jbuild_from_cfg(lr_config, JLR).schedule(
        SCHEDULE["optimizer"]["lr"], 1)
    tx = jbuild_optimizer({**SCHEDULE["optimizer"], "lr": schedule})
    jstep = compile_quickly(jtrain.make_train_step(jm, tx, donate=False),
                            jax_state(variables, tx), *batch(seed=0),
                            jax.random.PRNGKey(0))
    return dict(network=network, jm=jm, variables=variables, tx=tx,
                jstep=jstep, lr_config=lr_config)


def fresh_states(flagship):
    variables = flagship["variables"]
    jstate = jax_state(variables, flagship["tx"])
    model = bridge(build_segmentor(flagship["network"]), variables)
    state = train_state.create_train_state(model, SCHEDULE["optimizer"],
                                           flagship["lr_config"],
                                           steps_per_epoch=1)
    return jstate, state


def bn_counts(model):
    return {int(t) for k, t in model.state_dict().items()
            if k.endswith("num_batches_tracked")}


def test_deeplabv3_train_steps_match_jax(flagship):
    img, gt = batch(seed=21)
    jstate, state = fresh_states(flagship)
    step = train_state.make_train_step(state.model, state.optimizer,
                                       state.scheduler)
    generator = torch.Generator().manual_seed(0)
    x, y = to_nchw(img), torch.from_numpy(gt).long()
    for i in range(3):
        jstate, jlog = flagship["jstep"](jstate, img, gt,
                                         jax.random.PRNGKey(i))
        log = step(x, y, generator)
        assert sorted(log) == ["aux.acc_seg", "aux.loss_ce",
                               "decode.acc_seg", "decode.loss_ce", "loss"]
        assert_loss_dicts_equal({k: v.numpy() for k, v in log.items()},
                                {k: np.asarray(v) for k, v in jlog.items()})
        assert bn_counts(state.model) == {i + 1}
        if i in (0, 2):
            assert_state_equal(state.model, jstate, f"step {i + 1}")
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)


def test_train_one_epoch_matches_jax(flagship):
    batches = [batch(seed=s) for s in (22, 23)]
    jstate, state = fresh_states(flagship)
    jstate, jvars = jtrain_utils.train_one_epoch(
        0, flagship["jstep"], jstate, Loader((i, g, {}) for i, g in batches),
        log=False)
    state, port_vars = train_utils.train_one_epoch(
        0, train_state.make_train_step(state.model, state.optimizer,
                                       state.scheduler),
        state, Loader((to_nchw(i), g, {}) for i, g in batches),
        generator=torch.Generator().manual_seed(0))
    assert state.step == 2 and bn_counts(state.model) == {2}
    assert_loss_dicts_equal(port_vars, jvars)
    assert_state_equal(state.model, jstate, "after the epoch")


def test_train_loops_raise_on_a_pipeline(flagship):
    """A pipeline beside ``fused_aug`` (the step augments already) and a
    pipeline over batches that are not the loader's raw ``(N, H, W, C)``
    raise."""
    _, state = fresh_states(flagship)
    pipeline = Pipeline.from_yaml("configs/augmentation/"
                                  "kvasir_val_transform.yaml")
    with pytest.raises(ValueError, match="pipeline"):
        train_utils.train_one_epoch(0, None, state, Loader(),
                                    pipeline=pipeline, fused_aug=True)
    img, gt = batch(seed=30)
    with pytest.raises(ValueError, match="pipeline takes images"):
        train_utils.validate_one_epoch(0, None, state,
                                       Loader([(to_nchw(img), gt, {})]),
                                       None, pipeline=pipeline)


EVAL_CASES = {"two_channel": False, "one_channel": True}
RESCALE = {"none": None, "rescale": (40, 44)}
_jax_models, _jax_eval = {}, {}


def eval_pair(head, rescale):
    """(network, JAX variables, compiled JAX eval step), each built
    once."""
    if head not in _jax_models:
        network = tiny_flagship_train_cfg(one_channel=EVAL_CASES[head])
        _jax_models[head] = (network, *jax_pair(network))
    network, jm, variables = _jax_models[head]
    if (head, rescale) not in _jax_eval:
        _jax_eval[head, rescale] = compile_quickly(
            jtrain.make_eval_step(jm, RESCALE[rescale]), jax_state(variables),
            *batch(seed=0))
    return network, variables, _jax_eval[head, rescale]


@pytest.mark.parametrize("rescale", sorted(RESCALE))
@pytest.mark.parametrize("head", sorted(EVAL_CASES))
def test_eval_step_matches_jax(head, rescale):
    network, variables, jstep = eval_pair(head, rescale)
    img, gt = batch(seed=24)
    ref_logits, ref_vars = jstep(jax_state(variables), img, gt)
    model = bridge(build_segmentor(network), variables).train()
    logits, log_vars = train_state.make_eval_step(
        model, RESCALE[rescale])(to_nchw(img), torch.from_numpy(gt))
    assert not model.training
    size = RESCALE[rescale] or (SIZE, SIZE)
    assert sorted(logits) == sorted(ref_logits) == ["aux", "decode"]
    for name, ref in ref_logits.items():
        assert logits[name].shape == (2, 2, *size)  # one-channel: binarized
        np.testing.assert_allclose(to_nhwc(logits[name]), np.asarray(ref),
                                   err_msg=name, **LOGIT_TOL)
    assert_loss_dicts_equal({k: v.numpy() for k, v in log_vars.items()},
                            {k: np.asarray(v) for k, v in ref_vars.items()})


def new_evaluators():
    kw = dict(epoch=0, num_classes=2, class_names=["background", "object"],
              palette=[[0, 0, 0], [0, 63, 255]], show_result=False)
    return JSegEvaluator(**kw), SegEvaluator(**kw)


def test_validate_one_epoch_matches_jax():
    network, variables, jstep = eval_pair("two_channel", "none")
    jstate = jax_state(variables)
    batches = [batch(seed=s) for s in (25, 26)]
    jevaluator, evaluator = new_evaluators()
    ref_vars, ref_metrics = jtrain_utils.validate_one_epoch(
        0, jstep, jstate, Loader((i, g, {}) for i, g in batches), jevaluator,
        log=False)
    model = bridge(build_segmentor(network), variables)
    state = train_state.TrainState(model, optimizer=None)
    port_vars, metrics = train_utils.validate_one_epoch(
        0, train_state.make_eval_step(model), state,
        Loader((to_nchw(i), g, {}) for i, g in batches), evaluator)
    assert_loss_dicts_equal(port_vars, ref_vars)
    assert sorted(metrics) == sorted(ref_metrics) == ["aux", "decode"]
    for head, values in ref_metrics.items():
        assert sorted(metrics[head]) == sorted(values)
        for key, value in values.items():
            np.testing.assert_array_equal(metrics[head][key], value,
                                          err_msg=f"{head}.{key}")


@pytest.fixture(scope="module")
def served(flagship):
    model = bridge(build_segmentor(flagship["network"]),
                   flagship["variables"])
    return flagship["jm"], flagship["variables"], model


def test_tta_step_matches_jax(served):
    jm, variables, model = served
    img, _ = batch(seed=27)
    ref = compile_quickly(jtrain.make_tta_step(jm), variables, img)(
        variables, img)
    out = train_state.make_tta_step(model)(to_nchw(img))
    assert out.shape == (2, 2, SIZE, SIZE)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **PROB_TOL)
    torch.testing.assert_close(out.sum(1), torch.ones(2, SIZE, SIZE))


@pytest.fixture(scope="module")
def views(served):
    """Two views of one batch, the second at another size, each with its
    size for the rescale, and JAX's ``forward_test`` of them (two views go
    to ``batch_test``: one ``simple_test`` each)."""
    jm, variables, _ = served
    imgs = [batch(seed=28)[0], batch(seed=29, size=24)[0]]
    sizes = [(SIZE, SIZE)] * 2
    ref = compile_quickly(jax.jit(lambda v, i: jm.apply(
        v, i, {"ori_img_size_hw": sizes}, method="forward_test")),
        variables, imgs)(variables, imgs)
    return [to_nchw(i) for i in imgs], sizes, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("route", ["aug_test_logits", "batch_test",
                                   "simple_test"])
def test_test_routes_match_jax(served, views, route):
    """``forward_test`` of one view (-> ``simple_test``) against JAX's
    first, of two (-> ``batch_test``) against both, and
    ``aug_test_logits`` against their mean, as JAX's averages them."""
    _, _, model = served
    imgs, sizes, refs = views
    with torch.no_grad():
        if route == "simple_test":
            outs = [model.forward_test(imgs[:1],
                                       {"ori_img_size_hw": sizes[:1]})]
            refs = refs[:1]
        elif route == "batch_test":
            outs = model.forward_test(imgs, {"ori_img_size_hw": sizes})
            assert isinstance(outs, list) and len(outs) == 2
        else:
            outs = [model.aug_test_logits(imgs, sizes)]
            refs = [(refs[0] + refs[1]) / np.float32(2)]
    for out, ref in zip(outs, refs):
        assert out.shape == (2, 2, SIZE, SIZE)
        np.testing.assert_allclose(to_nhwc(out), ref, **PROB_TOL)


def test_pth_metadata_matches_jax():
    metrics = {"decode": {"aAcc": np.float64(91.5), "mIoU": 80.25,
                          "IoU": np.array([95.5, 65.0])}}
    args = ({"CLASSES": ("background", "object")}, 3, np.float32(0.75),
            {"loss": 0.5}, {"loss": np.float32(0.625)}, metrics)
    ref = jtrain_utils.pth_metadata(*args)
    out = train_utils.pth_metadata(*args)
    assert out == ref
    assert out["metric.decode.IoU"] == [95.5, 65.0]
