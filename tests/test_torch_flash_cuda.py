"""Each CUDA flash-attention kernel (K1-K3 on [BH, T, D], K4-K6 on the
packed [B, T, H·D], and Δ on both) against its plain PyTorch version, on
the card; the packed kernels against the bh ones bit for bit; and K8's dW
(same bits twice, beside the flash backward's). Imports no JAX, so it runs
where the kernels build:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_cuda.py

Without a card every test skips."""

import pytest
import torch

from kubeoperator_tpu_torch.workloads import flash_attention as tfa

torch.set_num_threads(2)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d,causal,kv_len", [
    (8, 256, 128, True, 256), (8, 256, 64, False, 196)])
def test_cuda_kernels_match_plain(bh, t, d, causal, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd(q, k, v, scale, causal, kv_len)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, scale, causal, kv_len)
    delta = tfa.bh_delta(do, o)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, kv_len)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, kv_len)
    dq_p = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal, kv_len)
    dk_p, dv_p = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale,
                                         causal, kv_len)
    torch.cuda.synchronize()
    # bf16 outputs; the kernels round P and dS to bf16 before their
    # products. The limits of chip_smoke.py: elementwise, and a relative
    # norm that an output 10% wrong on half its rows does not meet
    for got, want in ((o, o_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
        got, want = got[:, :kv_len].float(), want[:, :kv_len].float()
        torch.testing.assert_close(got, want, atol=1e-2, rtol=2e-2)
        assert float((got - want).norm() / want.norm()) <= 1e-2
    torch.testing.assert_close(lse[:, :kv_len], lse_p[:, :kv_len],
                               atol=1e-4, rtol=1e-5)


# K1 tiles queries by 128 and keys by 64: T = 192 ends in a half query tile
# (rows past T arrive as zeros and are not stored), and kv_len < T masks
# inside and past a key tile
@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d,causal,kv_len", [
    (4, 192, 64, True, 192), (4, 192, 128, True, 192),
    (4, 192, 64, False, 150), (4, 192, 128, False, 192),
    (3, 320, 128, True, 300), (2, 384, 64, False, 100)])
def test_cuda_fwd_tile_edges_match_plain(bh, t, d, causal, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd(q, k, v, scale, causal, kv_len)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, scale, causal, kv_len)
    torch.cuda.synchronize()
    # the limits of chip_smoke.py's TOL and LSE_TOL, over every row
    got, want = o.float(), o_p.float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=2e-2)
    assert float((got - want).norm() / want.norm()) <= 1e-2
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)


def _bwd_inputs(bh, t, d, causal, kv_len, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = tfa.flash_fwd(q, k, v, scale, causal, kv_len)
    return (q, k, v, do, lse, tfa.bh_delta(do, o), scale, causal, kv_len)


# K2 and K3 tile by 128 rows (queries for K2, keys for K3) and stream
# 64-row tiles of the other side: the forward's tile-edge shapes end in a
# half 128-row tile, and kv_len < T masks inside and past a 64-row tile
@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d,causal,kv_len", [
    (4, 192, 64, True, 192), (4, 192, 128, True, 192),
    (4, 192, 64, False, 150), (4, 192, 128, False, 192),
    (3, 320, 128, True, 300), (2, 384, 64, False, 100)])
def test_cuda_bwd_tile_edges_match_plain(bh, t, d, causal, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    args = _bwd_inputs(bh, t, d, causal, kv_len, seed=3)
    dq = tfa.flash_bwd_dq(*args)
    dk, dv = tfa.flash_bwd_dkv(*args)
    dq_p = tfa.flash_bwd_dq_plain(*args)
    dk_p, dv_p = tfa.flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    # the limits of chip_smoke.py's TOL, over every row (keys at or past
    # kv_len get zero dK and dV in both)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, atol=1e-2, rtol=2e-2)
        assert float((got - want).norm() / want.norm()) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,d,causal,kv_len", [
    (8, 512, 128, True, 512), (4, 320, 64, False, 300)])
def test_cuda_bwd_same_bits_twice(bh, t, d, causal, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    args = _bwd_inputs(bh, t, d, causal, kv_len, seed=4)
    first = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    second = (tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    # no block reduces across another: no atomics, no run-to-run order
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,causal,kv_len", [
    (128, 12, 256, 64, False, 196),     # ViT-B/16: 196 patches padded to 256
    (2, 4, 512, 128, True, 512)])
def test_cuda_packed_kernels_match_plain(b, h, t, d, causal, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    args = (h, d ** -0.5, causal, kv_len)
    o, lse = tfa.flash_fwd_packed(q, k, v, *args)
    o_p, lse_p = tfa.flash_fwd_packed_plain(q, k, v, *args)
    delta = tfa.packed_delta(do, o, h)
    dq = tfa.flash_bwd_dq_packed(q, k, v, do, lse, delta, *args)
    dk, dv = tfa.flash_bwd_dkv_packed(q, k, v, do, lse, delta, *args)
    dq_p = tfa.flash_bwd_dq_packed_plain(q, k, v, do, lse, delta, *args)
    dk_p, dv_p = tfa.flash_bwd_dkv_packed_plain(q, k, v, do, lse, delta,
                                                *args)
    torch.cuda.synchronize()
    for got, want in ((o, o_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
        got, want = got[:, :kv_len].float(), want[:, :kv_len].float()
        torch.testing.assert_close(got, want, atol=1e-2, rtol=2e-2)
        assert float((got - want).norm() / want.norm()) <= 1e-2
    torch.testing.assert_close(lse[..., :kv_len], lse_p[..., :kv_len],
                               atol=1e-4, rtol=1e-5)


# K4 runs K1's wgmma forward through a tensor map over [B, T, H·D]: T of
# one and two 64-key tiles under a 128-row query tile, kv_len inside the
# last key tile, D 64 and 128, one head and twelve. Every row below T,
# padded ones included, gets O and a finite lse (K5 and K6 read lse there).
@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,causal,kv_len", [
    (3, 1, 64, 64, False, 50), (3, 12, 64, 128, True, 64),
    (2, 12, 128, 64, False, 100), (2, 1, 128, 128, True, 128),
    (2, 12, 128, 128, False, 70), (4, 12, 256, 64, False, 196)])
def test_cuda_packed_fwd_tile_edges_match_plain(b, h, t, d, causal, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(b, t, h * d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    args = (h, d ** -0.5, causal, kv_len)
    o, lse = tfa.flash_fwd_packed(q, k, v, *args)
    o_p, lse_p = tfa.flash_fwd_packed_plain(q, k, v, *args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(lse).all())
    got, want = o.float(), o_p.float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=2e-2)
    assert float((got - want).norm() / want.norm()) <= 1e-2
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d,causal", [(64, False), (128, True)])
def test_cuda_packed_fwd_is_the_bh_forward(d, causal):
    """K4 and K1 are one kernel: the packed output equals the bh output on
    the transposed input bit for bit, and a second run gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    b, h, t, kv_len = 3, 4, 256, 200
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(b, t, h * d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    args = (d ** -0.5, causal, kv_len)
    o, lse = tfa.flash_fwd_packed(q, k, v, h, *args)
    o2, lse2 = tfa.flash_fwd_packed(q, k, v, h, *args)

    def bh(x):
        return (x.view(b, t, h, d).transpose(1, 2).reshape(b * h, t, d)
                .contiguous())

    o_bh, lse_bh = tfa.flash_fwd(bh(q), bh(k), bh(v), *args)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(bh(o), o_bh)
    assert torch.equal(lse.reshape(b * h, t), lse_bh)


def _to_bh(x, b, h, d):
    """[B, T, H·D] -> [B·H, T, D], contiguous"""
    t = x.shape[1]
    return x.view(b, t, h, d).transpose(1, 2).reshape(b * h, t, d).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,causal,kv_len", [
    (2, 4, 256, 64, False, 196),        # ViT's D and padding, 4 heads
    (2, 4, 512, 128, True, 512)])
def test_cuda_packed_bwd_is_the_bh_backward(b, h, t, d, causal, kv_len):
    """K5 and K6 run K2's and K3's kernels through the packed tensor map:
    on the same inputs their dQ, dK and dV equal the bh kernels' on the
    transposed tensors bit for bit, and a second run gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    args = (d ** -0.5, causal, kv_len)
    o, lse = tfa.flash_fwd_packed(q, k, v, h, *args)
    delta = tfa.packed_delta(do, o, h)
    packed = (tfa.flash_bwd_dq_packed(q, k, v, do, lse, delta, h, *args),
              *tfa.flash_bwd_dkv_packed(q, k, v, do, lse, delta, h, *args))
    again = (tfa.flash_bwd_dq_packed(q, k, v, do, lse, delta, h, *args),
             *tfa.flash_bwd_dkv_packed(q, k, v, do, lse, delta, h, *args))
    bh = [_to_bh(x, b, h, d) for x in (q, k, v, do)]
    rows = (lse.reshape(b * h, t), delta.reshape(b * h, t))
    want = (tfa.flash_bwd_dq(*bh, *rows, *args),
            *tfa.flash_bwd_dkv(*bh, *rows, *args))
    torch.cuda.synchronize()
    for name, got, twice, ref in zip(("dq", "dk", "dv"), packed, again, want):
        assert torch.equal(got, twice), name
        assert torch.equal(_to_bh(got, b, h, d), ref), name


# Δ: f32 sums of exact bf16 products, so the kernel and its plain version
# differ only in the order of the sum (chip_smoke.py's DELTA_TOL); T need
# not be a multiple of the tile, and a block's rows may span two batch rows
@pytest.mark.gpu
@pytest.mark.parametrize("layout,shape,heads", [
    ("bh", (6, 196, 64), 1), ("bh", (4, 2048, 128), 1),
    ("bh", (3, 33, 128), 1), ("packed", (2, 196, 12 * 64), 12),
    ("packed", (3, 100, 4 * 128), 4), ("packed", (5, 7, 2 * 64), 2)])
def test_cuda_delta_matches_plain(layout, shape, heads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(9)
    do, o = (torch.randn(shape, device="cuda", generator=gen)
             .to(torch.bfloat16) for _ in range(2))
    if layout == "bh":
        got, want = tfa.bh_delta(do, o), tfa.bh_delta_plain(do, o)
        again = tfa.bh_delta(do, o)
    else:
        got = tfa.packed_delta(do, o, heads)
        want = tfa.packed_delta_plain(do, o, heads)
        again = tfa.packed_delta(do, o, heads)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert float((got - want).norm() / want.norm()) <= 1e-5
    # one thread order, no atomics: the same bits every run
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ci,co,relu", [(401408, 64, 256, False),
                                          (100352, 128, 512, False),
                                          (6300, 256, 64, True)])
def test_cuda_k8_dw_same_bits_twice(n, ci, co, relu):
    """K8's dW is row-chunk partials added in a fixed order (no float
    atomics): two runs give the same bits, at a path site and off it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from kubeoperator_tpu_torch.workloads import bn_fused as tbn
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, g = (torch.randn(n, c, device="cuda", generator=gen)
            .to(torch.bfloat16) for c in (ci, co))
    y = (torch.randn(n, co, device="cuda", generator=gen) * 2 + 0.5
         ).to(torch.bfloat16)
    yf = y.float()
    mu = yf.mean(0)
    inv = torch.rsqrt((yf * yf).mean(0) - mu * mu + 1e-5)
    vecs = (torch.linspace(0.5, 1.5, co, device="cuda"),
            torch.linspace(-0.3, 0.3, co, device="cuda"), mu, inv)
    sums = tbn.bn_bwd_stats(g, y, *vecs, relu)
    first = tbn.bn_bwd_dw(x, g, y, *vecs, sums, relu)
    second = tbn.bn_bwd_dw(x, g, y, *vecs, sums, relu)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
