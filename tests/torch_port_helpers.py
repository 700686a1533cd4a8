"""Shared pieces of the PyTorch-port parity tests (``test_torch_port_*``).

Inputs and weights are made from a seed with numpy and handed to both
packages; JAX weights reach the port through ``bridge.py``.
"""

import contextlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import threadpoolctl
import torch

from image_segmentation_lab_tpu.core.initialize.checkpoint import \
    state_dict_from_variables
from image_segmentation_lab_tpu.core.mixed_precision import \
    policy as jpolicy
from image_segmentation_lab_tpu_torch.bridge import load_jax_state_dict
from image_segmentation_lab_tpu_torch.core.fileio import load_python_config

# the port is compared in float32; on a card cuDNN convs would default to
# TF32 (about three digits), which no tolerance below allows for
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
# the tiny CPU models here run no faster on more than one intra-op thread;
# a pool of a thread a core in each test process only spins, and takes CPU
# time from the other processes of a parallel run
torch.set_num_threads(1)
threadpoolctl.threadpool_limits(1, user_api="blas")  # numpy's BLAS too


def tiny_flagship_cfg(test_cfg=None, num_classes=2):
    """The flagship's structure (ResNetV1c-d8 + ASPP + FCN aux) at depth 18
    with narrow widths: stage widths 8/16/32/64."""
    norm = dict(type="SyncBatchNorm", requires_grad=True)
    return dict(
        type="EncoderDecoder",
        backbone=dict(type="ResNetV1c", depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=norm,
                      contract_dilation=True, stem_channels=8,
                      base_channels=8),
        decode_head=dict(type="ASPPHead", in_channels=64, in_index=3,
                         channels=16, dilations=(1, 12, 24, 36),
                         dropout_ratio=0.1, num_classes=num_classes,
                         norm_cfg=norm, align_corners=False,
                         loss_decode=dict(type="CrossEntropyLoss")),
        auxiliary_head=dict(type="FCNHead", in_channels=32, in_index=2,
                            channels=8, num_convs=1, concat_input=False,
                            dropout_ratio=0.1, num_classes=num_classes,
                            norm_cfg=norm, align_corners=False,
                            loss_decode=dict(type="CrossEntropyLoss",
                                             loss_weight=0.4)),
        train_cfg=dict(),
        test_cfg=test_cfg or dict(mode="whole"))


def tiny_flagship_train_cfg(one_channel=False):
    """``tiny_flagship_cfg`` with the flagship's own losses (sigmoid
    cross-entropy in both heads, the aux head at weight 1.0) and no head
    dropout, so that the packages draw nothing; ``one_channel``: both heads
    one-channel at threshold 0.4."""
    network = tiny_flagship_cfg()
    for head in ("decode_head", "auxiliary_head"):
        network[head].update(
            dropout_ratio=0.0,
            loss_decode=dict(type="CrossEntropyLoss", use_sigmoid=True,
                             loss_weight=1.0))
        if one_channel:
            network[head].update(out_channels=1, threshold=0.4)
    return network


# configs/network/setr/setr_pup_vit-s.py cut to 2 layers of width 32, 2
# heads, patch 8; on 40² images the position table (stored at a 3x3 grid)
# is resized to the 5x5 patch grid
TINY_VIT = dict(embed_dims=32, num_layers=2, num_heads=2, patch_size=8,
                pretrain_img_size=24, out_indices=(0, 1), final_norm=True)


def tiny_setr_network():
    """configs/network/setr/setr_pup_vit-s.py, cut to the tiny ViT."""
    network = load_python_config("configs/network/setr/"
                                 "setr_pup_vit-s.py")["model"]
    network["backbone"].update(TINY_VIT)
    for head in ("decode_head", "auxiliary_head"):
        network[head].update(in_channels=32, channels=8)
    return network


def randomize_variables(variables, seed):
    """Replace every leaf with seeded numpy values of its shape: conv and
    linear kernels N(0, 1/fan_in), norm weights and running variances in
    [0.5, 1.5], biases, running means and other tables (ViT's class token
    and position table) in [-0.2, 0.2].  Every weight then matters (no
    zero-initialised residual norm hides a block)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(x.shape)
        if len(shape) in (2, 4):  # linear (in, out), conv HWIO
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name in ("running_var", "weight"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.uniform(-0.2, 0.2, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def init_jax(module, *args, method=None, **kwargs):
    """Random variables of a JAX module: shapes by ``jax.eval_shape`` (no
    eager init, which costs tens of seconds on the CPU), values by
    ``randomize_variables``."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(
        lambda: module.init(keys, *args, method=method, **kwargs))
    return randomize_variables(shapes, seed=0)


def bridge(port_module, variables):
    """Load JAX variables into a port module through the bridge."""
    load_jax_state_dict(port_module, state_dict_from_variables(variables))
    return port_module.eval()


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def to_nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def assert_argmax_parity(jax_logits, port_logits, rtol=1e-3, atol=3e-3):
    """Logits within tolerance and identical hard predictions, excusing
    only genuine numerical ties (top-2 gap below the tolerance)."""
    jl, pl = np.asarray(jax_logits), np.asarray(port_logits)
    np.testing.assert_allclose(pl, jl, rtol=rtol, atol=atol)
    jp, pp = jl.argmax(-1), pl.argmax(-1)
    mism = jp != pp
    if mism.any():
        srt = np.sort(jl[mism], axis=-1)
        gaps = srt[:, -1] - srt[:, -2]
        assert mism.mean() < 1e-4 and gaps.max() < 2 * atol, (
            f"{mism.sum()} argmax mismatches, max top-2 gap {gaps.max()}")


def compile_quickly(jitted, *args):
    """``jitted`` (a ``jax.jit`` function) compiled for ``args`` with XLA's
    backend (LLVM) optimisation off: the same operations, in well under
    the compile time, which sets these small tests' time.  Its float32
    results may differ from the optimised program's in the last bit (other
    vectorised sum orders), far inside every tolerance here."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


class _Float64Numpy:
    """``jax.numpy`` with its ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_in_float64():
    """The JAX package's own rule run in float64, for the programs traced
    inside: 64-bit types on, a float64 dtype policy, and every
    ``jnp.float32`` that its modules name (BatchNorm's statistics, the
    float32 scores and softmaxes) read as ``float64``.  The caller passes
    float64 inputs and variables.  A few float32 tables remain (the
    resize weights), so its results sit within about 1e-7 relative of
    exact float64: a truth for float32 results that comes from the JAX
    package, where its own float32 program loses digits (the BatchNorm's
    one-pass variance ``E[x²] - E[x]²`` cancels on channels whose mean
    dwarfs their spread)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax.enable_x64(True))
        stack.enter_context(jpolicy.policy_scope(
            jpolicy.Policy(jnp.float64, jnp.float64, jnp.float64)))
        for name, module in list(sys.modules.items()):
            if (name.startswith("image_segmentation_lab_tpu.")
                    and getattr(module, "jnp", None) is jnp):
                stack.enter_context(mock.patch.object(module, "jnp",
                                                      _Float64Numpy()))
        yield


def as_float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def jax_apply(module, variables, *args, method=None, **kwargs):
    """``module.apply`` under ``jax.jit``, compiled by ``compile_quickly``:
    one quick compile instead of one per eager op."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a, method=method, **kwargs))
    return np.asarray(compile_quickly(fn, variables, *args)(variables,
                                                            *args))
