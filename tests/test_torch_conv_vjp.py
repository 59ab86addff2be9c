"""The port's conv with a custom backward against the JAX package's
(``workloads/conv_vjp.py``), on the CPU in f32: K7's plain version against
the Pallas kernel run as the JAX tests run it (interpret mode), and
``make_conv`` in modes ``dot``, ``pallas`` and ``dot2`` over the kernel
and stride cases ResNet uses, forward and both gradients. Padding follows XLA's SAME
rule, asymmetric at odd sizes and strides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kubeoperator_tpu.workloads import conv_vjp as jcv
from kubeoperator_tpu_torch.workloads import conv_vjp as tcv

torch.set_num_threads(2)

CASES = [  # (kernel, strides, h, cin, cout), as tests/test_conv_vjp.py
    ((1, 1), (1, 1), 8, 6, 10),
    ((1, 1), (2, 2), 8, 6, 10),
    ((3, 3), (1, 1), 8, 6, 10),
    ((3, 3), (2, 2), 9, 6, 10),      # odd spatial → asymmetric SAME pads
    ((4, 4), (1, 1), 8, 12, 16),
    ((7, 7), (2, 2), 14, 3, 8),
]


def arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("b,h,ci,co", [(2, 8, 8, 16), (8, 8, 24, 8)])
def test_k7_plain_matches_pallas_kernel(b, h, ci, co):
    """N = 128 (one row chunk) and 512 (several), Ci ≠ Co."""
    x, g, w = arrays((b, h, h, ci), (b, h, h, co), (ci, co))
    dx_j, dw_j = jcv.conv1x1_bwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(w))
    n = b * h * h
    dx, dw = tcv.conv1x1_bwd(torch.from_numpy(x).reshape(n, ci),
                             torch.from_numpy(g).reshape(n, co),
                             torch.from_numpy(w))
    np.testing.assert_allclose(dx.reshape(x.shape).numpy(), np.asarray(dx_j),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=2e-4,
                               rtol=2e-4)
    assert dw.dtype == torch.float32


def conv_pair(mode, kernel, strides, b, h, cin, cout, seed=0):
    """(JAX, port) forward, dx and dw of ``make_conv`` under a cotangent."""
    x, w, ct = arrays((b, h, h, cin), (*kernel, cin, cout),
                      (b, -(-h // strides[0]), -(-h // strides[1]), cout),
                      seed=seed)
    w *= 0.3
    fn = jcv.make_conv(tuple(strides), "SAME", mode)
    y_j, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tcv.make_conv(tuple(strides), "SAME", mode)(xt, wt)
    y.backward(torch.from_numpy(ct))
    return ((np.asarray(y_j), np.asarray(dx_j), np.asarray(dw_j)),
            (y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()))


@pytest.mark.parametrize("mode", ["dot", "pallas", "dot2"])
@pytest.mark.parametrize("kernel,strides,h,cin,cout", CASES)
def test_make_conv_matches_jax(mode, kernel, strides, h, cin, cout):
    want, got = conv_pair(mode, kernel, strides, 2, h, cin, cout)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,h,takes_k7", [(2, 8, True), (8, 8, True),
                                          (2, 9, False)])
def test_pallas_mode_takes_k7_where_jax_does(monkeypatch, b, h, takes_k7):
    """1×1 stride 1 with N % 128 == 0 goes to K7 (N = 128, 512); N = 162
    takes the dot path, on the CPU as on the card."""
    calls = []
    real = tcv.conv1x1_bwd
    monkeypatch.setattr(tcv, "conv1x1_bwd",
                        lambda *a: calls.append(a) or real(*a))
    want, got = conv_pair("pallas", (1, 1), (1, 1), b, h, 16, 24, seed=3)
    assert len(calls) == int(takes_k7)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, atol=1e-4, rtol=1e-4)


def test_dw_is_rounded_to_the_kernel_dtype():
    x, w, ct = arrays((2, 8, 8, 8), (1, 1, 8, 8), (2, 8, 8, 8))
    for mode in ("dot", "pallas", "dot2"):
        wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
        xt = torch.from_numpy(x).to(torch.bfloat16)
        y = tcv.make_conv((1, 1), "SAME", mode)(xt, wt)
        y.backward(torch.from_numpy(ct).to(torch.bfloat16))
        assert wt.grad.dtype == torch.bfloat16


def test_dot2_is_not_ported_and_unknown_modes_raise(monkeypatch):
    """``dot2`` is ported (this test pinned its refusal before): a 1×1
    stride-1 conv takes both gradients as products, with no K7 launch
    and no transposed conv, and matches the JAX mode at 2e-5 in f32.
    Unknown modes still raise."""
    calls = []
    monkeypatch.setattr(tcv, "conv1x1_bwd", lambda *a: calls.append(a))
    monkeypatch.setattr(tcv, "_dx_transposed", lambda *a: calls.append(a))
    want, got = conv_pair("dot2", (1, 1), (1, 1), 2, 8, 16, 24, seed=5)
    assert calls == []
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="unknown"):
        tcv.make_conv((1, 1), "SAME", "fast")


@pytest.mark.parametrize("kernel,strides,h,takes_dots", [
    ((1, 1), (1, 1), 9, True),       # N = 162: no multiple-of-128 rule
    ((1, 1), (2, 2), 8, False), ((3, 3), (1, 1), 8, False)])
def test_dot2_takes_products_only_for_1x1_stride_1(monkeypatch, kernel,
                                                   strides, h, takes_dots):
    """dot2 gives both 1×1 stride-1 gradients as products, at any N;
    every other shape falls through to the dot path (the transposed conv
    for dx), as the JAX mode does; f32 within 2e-5 of JAX's."""
    calls = []
    real = tcv._dx_transposed
    monkeypatch.setattr(tcv, "_dx_transposed",
                        lambda *a: calls.append(a) or real(*a))
    want, got = conv_pair("dot2", kernel, strides, 2, h, 8, 16, seed=6)
    assert len(calls) == int(not takes_dots)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, atol=2e-5, rtol=2e-5)


def test_dot2_in_bf16_matches_jax():
    """bf16 operands, as the model runs them: dx and dW are f32-accumulated
    products rounded once to bf16 on both sides, so they differ by a bf16
    step at most (2⁻⁸ relative) where the two sums round differently."""
    x, w, ct = arrays((2, 8, 8, 64), (1, 1, 64, 32), (2, 8, 8, 32), seed=7)
    bf = jnp.bfloat16
    fn = jcv.make_conv((1, 1), "SAME", "dot2")
    _, vjp = jax.vjp(fn, jnp.asarray(x, bf), jnp.asarray(w * 0.3, bf))
    want = [np.asarray(a.astype(jnp.float32)) for a in vjp(jnp.asarray(ct, bf))]
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = (torch.from_numpy(w * 0.3).to(torch.bfloat16)).requires_grad_()
    tcv.make_conv((1, 1), "SAME", "dot2")(xt, wt).backward(
        torch.from_numpy(ct).to(torch.bfloat16))
    for got, w_ in zip((xt.grad, wt.grad), want):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), w_, rtol=2 ** -7,
                                   atol=1e-2)


@pytest.mark.parametrize("size,k,s", [(224, 7, 2), (112, 4, 1), (112, 3, 2),
                                      (56, 3, 2), (9, 3, 2), (7, 1, 2),
                                      (33, 7, 2), (13, 4, 1)])
def test_same_pads_are_xla_s(size, k, s):
    want = lax.padtype_to_pads((size, size), (k, k), (s, s), "SAME")
    assert tcv.same_pads((size, size), (k, k), (s, s)) == tuple(
        tuple(p) for p in want)


def test_k7_wrapper_refuses_what_it_does_not_take():
    """A CPU tensor runs the plain version; the CUDA checks refuse a CPU
    tensor handed to them and channels that are not multiples of 64."""
    with pytest.raises(ValueError, match="no kernel"):
        tcv.check_cuda("k7", (torch.zeros(2, 2), (2, 2), torch.float32))
    with pytest.raises(ValueError, match="multiples of 64"):
        tcv.check_channels("k7", 64, 48)
    assert tcv.k8_dw_chunks(401408, 64, 256) == (3072, 131)
    rows, chunks = tcv.k8_dw_chunks(1000, 64, 128)
    assert rows % 64 == 0 and rows * (chunks - 1) < 1000 <= rows * chunks
