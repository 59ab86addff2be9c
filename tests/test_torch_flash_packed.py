"""The port's packed-layout flash attention (kernels K4-K6, [B, T, H·D])
against the JAX package's ``flash_attention(layout="packed")`` (Pallas in
interpret mode on the CPU, as tests/test_flash.py runs it): forward at
2e-5 and gradients at 5e-4, causal and not, aligned, ragged and
multi-tile T. Also: the packed output equals the port's own bh layout, the
wrappers take their plain versions for CPU tensors and launch nothing,
the CUDA checks refuse what the kernels do not take, Δ's wrappers
equal the JAX backward's Δ, and the ctypes signatures agree with the C
source. The kernels against their plain
versions on the card are in test_torch_flash_cuda.py."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads.flash_attention import (
    flash_attention as jax_flash,
)
from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.workloads import flash_attention as tfa
from kubeoperator_tpu_torch.workloads.ring_attention import reference_attention

torch.set_num_threads(2)

# (T, block): one tile-aligned q block; ragged (196 padded to 256, two
# 128-row q blocks); aligned with two q blocks
SHAPES = [(128, 128), (196, 128), (256, 128)]


def qkv(b=2, t=128, h=3, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def port_forward(arrays, causal, block, layout="packed"):
    q, k, v = (torch.from_numpy(x) for x in arrays)
    return tfa.flash_attention(q, k, v, causal=causal, block=block,
                               layout=layout).numpy()


def jax_forward(arrays, causal, block):
    q, k, v = (jnp.asarray(x) for x in arrays)
    return np.asarray(jax_flash(q, k, v, causal=causal, block=block,
                                layout="packed"))


def port_grads(arrays, causal, block, layout="packed"):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in arrays)
    out = tfa.flash_attention(q, k, v, causal=causal, block=block,
                              layout=layout)
    (out ** 2).sum().backward()
    return [x.grad.numpy() for x in (q, k, v)]


def jax_grads(arrays, causal, block):
    def loss(q, k, v):
        return (jax_flash(q, k, v, causal=causal, block=block,
                          layout="packed") ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in arrays))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", SHAPES)
def test_forward_matches_jax(causal, t, block):
    arrays = qkv(t=t, seed=t)
    got = port_forward(arrays, causal, block)
    np.testing.assert_allclose(got, jax_forward(arrays, causal, block),
                               atol=2e-5, rtol=2e-5)
    dense = reference_attention(*(torch.from_numpy(x) for x in arrays),
                                causal=causal).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", SHAPES)
def test_gradients_match_jax(causal, t, block):
    arrays = qkv(b=1, t=t, h=2, d=32, seed=t + 1)
    for name, a, b in zip("qkv", port_grads(arrays, causal, block),
                          jax_grads(arrays, causal, block)):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("causal", [True, False])
def test_packed_equals_the_bh_layout(causal):
    """The layout is plumbing, never math: packed and bh give the same
    output and gradients."""
    arrays = qkv(t=196, seed=7)
    np.testing.assert_allclose(port_forward(arrays, causal, 128),
                               port_forward(arrays, causal, 128, "bh"),
                               atol=1e-6, rtol=1e-6)
    for a, b in zip(port_grads(arrays, causal, 128),
                    port_grads(arrays, causal, 128, "bh")):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def test_plain_packed_versions_are_the_bh_ones_per_head():
    """K4-K6's specs on [B, T, H·D] equal K1-K3's on the [B·H, T, D]
    transpose, with LSE and Δ laid out [B, H, T]."""
    b, t, h, d = 2, 128, 3, 16
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, t, h * d))
                                    .astype(np.float32)) for _ in range(4))

    def bh(x):
        return x.reshape(b, t, h, d).transpose(1, 2).reshape(b * h, t, d)

    args = (0.25, True, 100)
    o, lse = tfa.flash_fwd_packed_plain(q, k, v, h, *args)
    o_bh, lse_bh = tfa.flash_fwd_plain(bh(q), bh(k), bh(v), *args)
    assert o.shape == (b, t, h * d) and lse.shape == (b, h, t)
    torch.testing.assert_close(bh(o), o_bh, atol=0, rtol=0)
    torch.testing.assert_close(lse.reshape(b * h, t), lse_bh, atol=0, rtol=0)
    delta = torch.from_numpy(rng.standard_normal((b, h, t)).astype(np.float32))
    rows = (lse_bh, delta.reshape(b * h, t))
    dq = tfa.flash_bwd_dq_packed_plain(q, k, v, do, lse, delta, h, *args)
    torch.testing.assert_close(
        bh(dq), tfa.flash_bwd_dq_plain(bh(q), bh(k), bh(v), bh(do), *rows,
                                       *args), atol=0, rtol=0)
    dk, dv = tfa.flash_bwd_dkv_packed_plain(q, k, v, do, lse, delta, h, *args)
    dk_bh, dv_bh = tfa.flash_bwd_dkv_plain(bh(q), bh(k), bh(v), bh(do), *rows,
                                           *args)
    torch.testing.assert_close(bh(dk), dk_bh, atol=0, rtol=0)
    torch.testing.assert_close(bh(dv), dv_bh, atol=0, rtol=0)


def test_packed_delta_is_the_bh_delta_per_head():
    """Δ of the packed backward, [B, H, T] f32, equals the bh layout's
    [B·H, T] Δ on the transposed tensors, and rowsum(dO ∘ O) per head."""
    b, t, h, d = 2, 64, 3, 16
    rng = np.random.default_rng(5)
    do, o = (torch.from_numpy(rng.standard_normal((b, t, h * d))
                              .astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))

    def bh(x):
        return x.reshape(b, t, h, d).transpose(1, 2).reshape(b * h, t, d)

    delta = tfa.packed_delta(do, o, h)
    assert delta.shape == (b, h, t) and delta.dtype == torch.float32
    assert delta.is_contiguous()
    torch.testing.assert_close(delta.reshape(b * h, t),
                               tfa.bh_delta(bh(do), bh(o)), atol=0, rtol=0)
    want = np.einsum("bthd,bthd->bht",
                     do.float().numpy().reshape(b, t, h, d),
                     o.float().numpy().reshape(b, t, h, d))
    np.testing.assert_allclose(delta.numpy(), want, atol=1e-5, rtol=1e-5)


def _jax_delta(do: np.ndarray, o: np.ndarray, heads: int | None,
               fn=jnp.sum):
    """Δ as the JAX package's backward computes it: ``_bwd``'s
    jnp.sum(dO·O, -1) on [BH, T, D], or ``_bwd_packed``'s per-head sum of
    [B, T, H·D], transposed to [B, H, T] (without the TPU's sublane
    broadcast). ``fn`` of the products in place of the sum gives the
    same layout of another row statistic."""
    prod = jnp.asarray(do).astype(jnp.float32) * jnp.asarray(o).astype(
        jnp.float32)
    if heads is None:
        return np.asarray(fn(prod, axis=-1))
    b, t, hd = do.shape
    return np.asarray(fn(prod.reshape(b, t, heads, hd // heads),
                         axis=-1).transpose(0, 2, 1))


@pytest.mark.parametrize("layout,shape,heads", [
    ("bh", (6, 196, 64), None), ("bh", (4, 256, 128), None),
    ("packed", (2, 196, 3 * 64), 3), ("packed", (2, 256, 2 * 128), 2)])
def test_delta_wrappers_take_the_plain_versions_and_match_jax(layout, shape,
                                                              heads):
    """``bh_delta`` and ``packed_delta`` on CPU tensors run their plain
    versions, launch nothing, and equal the JAX backward's Δ on the same
    numpy-seeded bf16 inputs. Both sum the same exact f32 products in
    other orders, so they differ by f32 rounding of the sum: within 1e-6
    of the products' absolute sum (an order of the sum is off by up to
    D·2⁻²⁴ of it; a missing product, by about 1/D of it)."""
    rng = np.random.default_rng(sum(shape))
    do, o = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    tfa.reset_launches()
    if layout == "bh":
        got, plain = tfa.bh_delta(do, o), tfa.bh_delta_plain(do, o)
    else:
        got = tfa.packed_delta(do, o, heads)
        plain = tfa.packed_delta_plain(do, o, heads)
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)
    assert torch.equal(got, plain) and got.dtype == torch.float32
    arrays = do.float().numpy(), o.float().numpy()
    want = _jax_delta(*arrays, heads)
    assert got.shape == want.shape
    scale = _jax_delta(*arrays, heads,
                       fn=lambda x, axis: jnp.sum(jnp.abs(x), axis=axis))
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * scale)


@pytest.mark.parametrize("shape,heads,dtype,match", [
    ((2, 64, 192), 5, torch.bfloat16, "multiple of 5 heads"),
    ((2, 64, 96), 3, torch.bfloat16, "head dim 32"),
    ((2, 64, 128), 2, torch.bfloat16, "no kernel for device cpu"),
])
def test_delta_kernel_refuses_what_it_does_not_take(shape, heads, dtype,
                                                     match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tfa._delta_kernel(x, x, shape[0], shape[1], heads)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    tfa.reset_launches()
    port_grads(qkv(b=1, t=128, h=2, d=64), False, 128)
    assert set(tfa.LAUNCHES) >= {"flash_fwd_packed", "flash_bwd_dq_packed",
                                 "flash_bwd_dkv_packed", "flash_delta"}
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)


def test_packed_op_saves_lse_per_head():
    """The op's second output is LSE [B, H, Tp] f32: the [B·H, Tp] rows
    the kernels index, with no TPU sublane broadcast."""
    q = torch.zeros(2, 128, 3 * 64)
    o, lse = tfa.FLASH_PACKED_OP(q, q, q, 3, 0.125, False, 100)
    assert o.shape == q.shape and lse.shape == (2, 3, 128)
    assert lse.dtype == torch.float32


@pytest.mark.parametrize("shape,heads,dtype,match", [
    ((1, 128, 192), 5, torch.bfloat16, "multiple of 5 heads"),
    ((1, 128, 96), 3, torch.bfloat16, "head dim 32"),
    ((1, 100, 128), 2, torch.bfloat16, "multiple of the 64-row tile"),
    ((1, 128, 128), 2, torch.bfloat16, "no kernel for device cpu"),
])
def test_cuda_checks_refuse_what_the_kernels_do_not_take(shape, heads, dtype,
                                                         match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tfa._check_cuda_packed("flash_fwd_packed", heads, (x, x, x))


def test_unknown_layout_raises():
    q, k, v = (torch.from_numpy(x) for x in qkv(b=1, t=128))
    with pytest.raises(ValueError, match="unknown layout"):
        tfa.flash_attention(q, k, v, layout="bhd")


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


def test_ctypes_signatures_match_the_c_source():
    """Every entry point of ``kernels.SIGNATURES`` is declared in the
    ``extern "C"`` block of its source with the same argument types, in
    order: a mismatch would pass garbage to a kernel on the card."""
    for lib, fns in kernels.SIGNATURES.items():
        src = (kernels.CSRC / f"{lib}.cu").read_text()
        exported = src[src.index('extern "C" {'):]
        for fn, argtypes in fns.items():
            m = re.search(rf"int {fn}\(([^)]*)\)", exported)
            assert m, f"{fn} not exported by {lib}.cu"
            params = [" ".join(p.split()) for p in m.group(1).split(",")]
            c_types = [_C_TYPES[p.rsplit(" ", 1)[0].replace(" *", "*")]
                       for p in params]
            assert c_types == argtypes, fn
