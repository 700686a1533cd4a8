"""The port's attention against the JAX package, on the CPU.

On a CPU tensor ``flash_attention_forward`` and ``multihead_attention`` run
the plain version, held here to the JAX flash kernel in interpret mode and
to its einsum path; under grad they go through the ``FlashAttention``
Function, whose CPU backward is ``attention_backward_plain``, held to
``jax.vjp`` of the JAX flash kernel in interpret mode.  Tolerances are
those of ``tests/test_flash_attention``: atol 2e-6 / rtol 1e-5 (values)
and 2e-5 / 1e-4 (gradients) in float32 at unit-normal inputs (float32
reduction order), 2e-2 / 2e-2 in bfloat16 (one bf16 rounding of the
probabilities, taken before or after the normalisation).
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
    attention, flash_attention, resize_backward)
from image_segmentation_lab_tpu_torch.utils.ops import resize  # noqa: E402

# the JAX references run jitted with XLA's backend optimisation off, as
# ``torch_port_helpers.compile_quickly`` compiles: one quick compile per
# case, where the interpret-mode kernel run eagerly compiles every step
QUICK = dict(compiler_options={"xla_backend_optimization_level": 0})
F32 = dict(atol=2e-6, rtol=1e-5)
F32_GRAD = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
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
    ref_o, ref_lse = jax.jit(lambda q, k, v: (
        jflash.flash_attention(q, k, v, scale, 64, 64, True),
        jflash._flash_forward(q, k, v, scale, 64, 64, True)[1]),
        **QUICK)(q, k, v)
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
    ref = jax.jit(lambda q, k, v: jattention.multihead_attention(
        q, k, v, scale, force="einsum"), **QUICK)(q, k, v)
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
    ref = jax.jit(lambda q, k, v: jflash.flash_attention(
        q, k, v, scale, 64, 64, True), **QUICK)(q, k, v)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16)[:, :, None] for x in (q, k, v))
    o, _ = flash_attention.attention_plain(tq, tk, tv, scale)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o[:, :, 0].float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def jax_grads(q, k, v, do, scale):
    """``jax.vjp`` of the JAX flash kernel (interpret mode, 64-blocks)."""
    def grads(q, k, v, do):
        _, vjp = jax.vjp(lambda *a: jflash.flash_attention(
            *a, scale, 64, 64, True), q, k, v)
        return vjp(do)
    return jax.jit(grads, **QUICK)(q, k, v, do)


def to_port(x, N, h):
    """JAX's heads-major fold (h·N, L, d) -> the port's (N, L, h, d)."""
    B, L, d = x.shape
    return torch.from_numpy(
        np.asarray(x).reshape(h, N, L, d).transpose(1, 2, 0, 3).copy())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_matches_the_jax_flash_kernel(name):
    """``attention_backward_plain`` on the forward's o and lse, and the
    Function's backward through ``multihead_attention``, with the batch of
    the JAX kernel split into N x h as ``ops/attention.py`` folds heads."""
    (B, Lq, Lk, d), (N, h) = SHAPES[name]
    q, k, v = qkv(B, Lq, Lk, d, seed=3)
    do = np.random.RandomState(4).randn(B, Lq, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    refs = [to_port(g, N, h) for g in jax_grads(q, k, v, do, scale)]

    tq, tk, tv, tdo = (to_port(x, N, h) for x in (q, k, v, do))
    o, lse = flash_attention.flash_attention_forward(tq, tk, tv, scale)
    delta = flash_attention.backward_delta(o, tdo)
    assert delta.shape == lse.shape == (N, h, Lq)
    plain = flash_attention.attention_backward_plain(tq, tk, tv, tdo, lse,
                                                     delta, scale)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    with torch.enable_grad():
        out = attention.multihead_attention(*leaves, scale)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        grads = torch.autograd.grad(out, leaves, tdo)
    for what, got in (("plain", plain), ("function", grads)):
        for g, ref, name_ in zip(got, refs, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), ref.numpy(),
                                       err_msg=f"{what} {name_}", **F32_GRAD)


# (B, Lq, Lk, d) of the bf16 backward: equal lengths; Lq != Lk at d = 48;
# d = 32 with 63 of the last 64-key tile's keys masked
BF16_BWD_SHAPES = {
    "square_96": (2, 96, 96, 64),
    "lq_ne_lk_d48": (2, 70, 37, 48),
    "masked_tail_d32": (2, 63, 65, 32),
}


@pytest.mark.parametrize("name", sorted(BF16_BWD_SHAPES))
def test_bf16_backward_matches_the_jax_flash_kernel(name):
    B, Lq, Lk, d = BF16_BWD_SHAPES[name]
    rng = np.random.RandomState(5)
    q, k, v, do = (jnp.asarray(rng.randn(B, L, d), jnp.bfloat16)
                   for L in (Lq, Lk, Lk, Lq))
    scale = 1.0 / np.sqrt(d)
    refs = jax_grads(q, k, v, do, scale)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                       .to(torch.bfloat16)[:, :, None]
                       for x in (q, k, v, do))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    with torch.enable_grad():
        out, _ = flash_attention.flash_attention_forward(*leaves, scale)
        grads = torch.autograd.grad(out, leaves, tdo)
    for g, ref, name_ in zip(grads, refs, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g[:, :, 0].float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   err_msg=name_, **BF16)


def test_split_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 5, 3, 32)
    for bad in ((q, q, q, q[:, :4]), (q, q, q, q.double()),
                (*(q.bfloat16(),) * 3, q)):
        with pytest.raises(ValueError):
            flash_attention.split_bf16x3(*bad)


def test_backward_wrappers_reject_mismatched_rows():
    q = torch.zeros(2, 5, 3, 32)
    lse = torch.zeros(2, 3, 5)
    for bad in (dict(do=q[:, :4]), dict(lse=lse.transpose(1, 2)),
                dict(delta=lse.double())):
        args = {**dict(do=q, lse=lse, delta=lse), **bad}
        with pytest.raises(ValueError):
            flash_attention.flash_attention_backward_dq(
                q, q, q, args["do"], args["lse"], args["delta"], 0.5)
        with pytest.raises(ValueError):
            flash_attention.flash_attention_backward_dkv(
                q, q, q, args["do"], args["lse"], args["delta"], 0.5)


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
    """A CPU tensor never builds or launches a kernel, forward or backward
    (attention and the resize); the plain versions give the gradient.  Grad
    is switched on here: other test modules turn it off for the whole
    process when they are imported."""
    counts = dict.fromkeys(flash_attention.launches, 0)
    monkeypatch.setattr(flash_attention, "launches", dict(counts))
    monkeypatch.setattr(resize_backward, "launches", {"resize_backward": 0})
    for module, builder in ((flash_attention, "build_sm90_library"),
                            (flash_attention, "build_sm90_backward_library"),
                            (resize_backward, "build_library")):
        monkeypatch.setattr(module, builder,
                            lambda: pytest.fail("built a kernel for a CPU "
                                                "tensor"))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(1, 7, 2, 16, dtype=dtype, requires_grad=True)
        x = torch.randn(1, 2, 3, 4, dtype=dtype, requires_grad=True)
        with torch.enable_grad():
            o, _ = flash_attention.flash_attention_forward(q, q, q, 0.25)
            o.float().sum().backward()
            resize(x, (6, 8)).float().sum().backward()
        assert q.grad is not None and q.grad.dtype == dtype
        assert x.grad is not None and x.grad.dtype == dtype
    flash_attention.split_bf16x3(*(q.detach().float(),) * 4)
    flash_attention.split_bf16x3(*(q.detach().float(),) * 3)
    assert flash_attention.launches == counts
    assert resize_backward.launches == {"resize_backward": 0}
    with pytest.raises(ValueError, match="force"):
        attention.multihead_attention(q, q, q, 0.25, force="einsum")


def test_split_bf16x3_parts_sum_to_the_value():
    """hi + mid + lo == x exactly, over normal float32 values of many
    magnitudes, each part a bf16 rounding of what the parts before it
    leave."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy((rng.randn(4096) * 2.0 ** rng.uniform(-100, 100, 4096))
                         .astype(np.float32))
    parts = flash_attention.split_bf16x3_plain(x)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 4096)
    assert torch.equal(parts.double().sum(0), x.double())
    assert torch.equal(parts[0], x.to(torch.bfloat16))
    assert (parts[2] != 0).float().mean() > 0.9  # every part carries bits
    # what a part leaves is at most half a bf16 step of the part
    for hi, rest in ((parts[0], parts[1:]), (parts[1], parts[2:])):
        assert bool((rest.double().sum(0).abs()
                     <= hi.double().abs() * 2.0 ** -8).all())


def split_product(eq, a, b, parts=flash_attention.SPLIT_PARTS):
    """``einsum(eq, a, b)`` of float32 operands as the float32 backward
    kernels take it: the bf16-part products a_i b_j with i + j < parts,
    smallest first, each exact in float32 and summed in float32."""
    pa, pb = (flash_attention.split_bf16x3_plain(t).float() for t in (a, b))
    out = 0
    for s in range(parts - 1, -1, -1):
        for i in range(s, -1, -1):
            out = out + torch.einsum(eq, pa[i], pb[s - i])
    return out


def test_six_bf16_products_keep_float32_accuracy():
    """``attention_backward_plain``'s arithmetic with its five products
    taken as six bf16-part products each agrees with the same arithmetic in
    float64 within the card test's float32 tolerance, and with the plain
    version itself; one bf16 product (hi * hi) does not."""
    N, L, h, d = 1, 200, 2, 64
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rng.randn(N, L, h, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = flash_attention.attention_plain(q, k, v, scale)
    delta = flash_attention.backward_delta(o, do)

    def backward(product, dtype):
        qq, kk, vv, dd = (t.to(dtype) for t in (q, k, v, do))
        p = torch.exp(product("nlhd,nshd->nhls", qq, kk) * scale
                      - lse[..., None].to(dtype))
        dp = product("nlhd,nshd->nhls", dd, vv)
        ds = p * (dp - delta[..., None].to(dtype)) * scale
        return (product("nhls,nshd->nlhd", ds, kk),
                product("nhls,nlhd->nshd", ds, qq),
                product("nhls,nlhd->nshd", p, dd))

    exact = backward(torch.einsum, torch.float64)
    split = backward(split_product, torch.float32)
    plain = flash_attention.attention_backward_plain(q, k, v, do, lse, delta,
                                                     scale)
    one_pass = backward(lambda eq, a, b: split_product(eq, a, b, parts=1),
                        torch.float32)
    for got, ref, want in ((split, exact, True), (split, plain, True),
                           (plain, exact, True), (one_pass, exact, False)):
        close = [torch.allclose(g.double(), r.double(), **F32_GRAD)
                 for g, r in zip(got, ref)]
        assert all(close) if want else not any(close)


def tiled_forward(q, k, v, scale, product, tile=64):
    """``(o, lse)`` as the forward kernels take them: 64-key tiles, an
    online softmax (running max m and sum l per row, s·scale, exp), each
    tile's PV product summed from zero and then added to the rescaled
    accumulator, o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    n, lq, h, d = q.shape
    m = torch.full((n, h, lq), -1e30, dtype=q.dtype)
    l = torch.zeros((n, h, lq), dtype=q.dtype)
    acc = torch.zeros((n, h, lq, d), dtype=q.dtype)
    for k0 in range(0, k.shape[1], tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = product("nlhd,nshd->nhls", q, kt) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + product("nhls,nshd->nhld", p, vt)
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).transpose(1, 2), m + torch.log(l)


def test_six_bf16_products_keep_float32_forward_accuracy():
    """The forward kernels' arithmetic (``tiled_forward``) with S = Q·Kᵀ and
    each tile's P·V taken as six bf16-part products agrees with the same
    arithmetic in float64 at the card's float32 forward gate (o and lse,
    atol 2e-6 / rtol 1e-5), and so does ``attention_plain``; one bf16
    product (hi * hi) does not."""
    N, Lq, Lk, h, d = 2, 150, 200, 2, 64  # four key tiles, the last ragged
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(N, L, h, d).astype(np.float32))
               for L in (Lq, Lk, Lk))
    scale = d ** -0.5
    exact = tiled_forward(q.double(), k.double(), v.double(), scale,
                          torch.einsum)
    split = tiled_forward(q, k, v, scale, split_product)
    plain = flash_attention.attention_plain(q, k, v, scale)
    one_pass = tiled_forward(
        q, k, v, scale, lambda eq, a, b: split_product(eq, a, b, parts=1))
    for got, want in ((split, True), (plain, True), (one_pass, False)):
        close = [torch.allclose(g.double(), r, **F32)
                 for g, r in zip(got, exact)]
        assert all(close) if want else not any(close)


def test_no_fallback_around_the_kernel():
    for module in (flash_attention, attention, resize_backward):
        tree = ast.parse(inspect.getsource(module))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
