"""The port's attention against the JAX package, on the CPU.

On a CPU tensor ``flash_attention_forward`` and ``multihead_attention`` run
the plain version, held here to the JAX flash kernel in interpret mode and
to its einsum path.  Tolerances are those of ``tests/test_flash_attention``:
atol 2e-6 / rtol 1e-5 in float32 at unit-normal inputs (float32 reduction
order), 2e-2 / 2e-2 in bfloat16 (one bf16 rounding of the probabilities,
taken before or after the normalisation).
"""

import ast
import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from image_segmentation_lab_tpu.ops import attention as jattention  # noqa: E402,E501
from image_segmentation_lab_tpu.ops.pallas import \
    flash_attention as jflash  # noqa: E402
from image_segmentation_lab_tpu_torch.ops import (  # noqa: E402
    attention, flash_attention)

F32 = dict(atol=2e-6, rtol=1e-5)
# (B, Lq, Lk, d) of tests/test_flash_attention.py; the port's layout is
# (N, L, h, d), so B is split into N x h for the multi-head cases
SHAPES = {
    "exact_fit": ((2, 64, 64, 32), (1, 2)),
    "ragged": ((3, 130, 130, 64), (1, 3)),
    "lq_ne_lk": ((2, 100, 37, 64), (2, 1)),
    "multi_block_d48": ((1, 300, 300, 48), (1, 1)),
}


def qkv(B, Lq, Lk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Lq, d).astype(np.float32),
            rng.randn(B, Lk, d).astype(np.float32),
            rng.randn(B, Lk, d).astype(np.float32))


def as_heads(x):
    """(B, L, d) -> the port's (B, L, 1, d)."""
    return torch.from_numpy(x)[:, :, None, :]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_matches_the_jax_flash_kernel(name):
    (B, Lq, Lk, d), _ = SHAPES[name]
    q, k, v = qkv(B, Lq, Lk, d)
    scale = 1.0 / np.sqrt(d)
    ref_o = jflash.flash_attention(q, k, v, scale, 64, 64, True)
    _, ref_lse = jflash._flash_forward(q, k, v, scale, 64, 64, True)
    o, lse = flash_attention.flash_attention_forward(
        as_heads(q), as_heads(k), as_heads(v), scale)
    assert o.shape == (B, Lq, 1, d) and lse.shape == (B, 1, Lq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o[:, :, 0].numpy(), np.asarray(ref_o), **F32)
    np.testing.assert_allclose(lse[:, 0].numpy(),
                               np.asarray(ref_lse)[:, 0, :Lq], **F32)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_multihead_matches_the_jax_einsum_path(name):
    (B, Lq, Lk, d), (N, h) = SHAPES[name]
    q, k, v = (x.reshape(N, h, -1, d).transpose(0, 2, 1, 3)
               for x in qkv(B, Lq, Lk, d, seed=1))
    scale = 1.0 / np.sqrt(d)
    ref = jattention.multihead_attention(q, k, v, scale, force="einsum")
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(x))
                  for x in (q, k, v))
    out = attention.multihead_attention(tq, tk, tv, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_bf16_matches_the_jax_flash_kernel():
    B, L, d = 2, 96, 64
    rng = np.random.RandomState(2)
    q, k, v = (jnp.asarray(rng.randn(B, L, d), jnp.bfloat16)
               for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    ref = jflash.flash_attention(q, k, v, scale, 64, 64, True)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16)[:, :, None] for x in (q, k, v))
    o, _ = flash_attention.attention_plain(tq, tk, tv, scale)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o[:, :, 0].float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


BAD_INPUTS = {
    "float64": lambda q, k, v: (q.double(), k.double(), v.double()),
    "mixed_dtypes": lambda q, k, v: (q, k.bfloat16(), v),
    "k_v_shapes": lambda q, k, v: (q, k, v[:, :-1]),
    "head_dims": lambda q, k, v: (q, k[..., :-1], v[..., :-1]),
    "three_dims": lambda q, k, v: (q[:, :, 0], k[:, :, 0], v[:, :, 0]),
    "zero_keys": lambda q, k, v: (q, k[:, :0], v[:, :0]),
    "meta_device": lambda q, k, v: (q.to("meta"), k.to("meta"),
                                    v.to("meta")),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.zeros(2, 5, 3, 32) for _ in range(3))
    with pytest.raises((TypeError, ValueError)):
        flash_attention.flash_attention_forward(*BAD_INPUTS[bad](q, k, v),
                                                0.5)


def test_cpu_runs_the_plain_version_and_counts_nothing(monkeypatch):
    """A CPU tensor never builds or launches the kernel; the plain version
    keeps the gradient.  Grad is switched on here: other test modules turn
    it off for the whole process when they are imported."""
    monkeypatch.setattr(flash_attention, "launches", {"forward": 0})
    monkeypatch.setattr(flash_attention, "build_library",
                        lambda: pytest.fail("built the kernel for a CPU "
                                            "tensor"))
    q = torch.randn(1, 7, 2, 16, requires_grad=True)
    with torch.enable_grad():
        o, _ = flash_attention.flash_attention_forward(q, q, q, 0.25)
        o.sum().backward()
    assert q.grad is not None
    assert flash_attention.launches == {"forward": 0}
    with pytest.raises(ValueError, match="force"):
        attention.multihead_attention(q, q, q, 0.25, force="einsum")


def test_no_fallback_around_the_kernel():
    for module in (flash_attention, attention):
        tree = ast.parse(inspect.getsource(module))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
