"""K7 (1×1 conv backward), K8 (conv → BN → relu backward) and K9
(per-channel sum) against their plain PyTorch versions, on the card, at
small shapes and at ragged ones (N not a multiple of the kernels' row
tiles or of their row chunks, channels not a multiple of K7's 128-wide
tile). Imports no JAX, so it runs where the kernels build:

    python -m pytest --noconftest -m gpu tests/test_torch_conv_cuda.py

Without a card every test skips."""

import pytest
import torch

from kubeoperator_tpu_torch import bitcast_probe as tbp
from kubeoperator_tpu_torch.workloads import bn_fused as tbn
from kubeoperator_tpu_torch.workloads import conv_vjp as tcv

torch.set_num_threads(2)

# dx is bf16: a right kernel and its plain version round the same f32 sums
# (taken in another order) to bf16, so they differ by a bf16 step here and
# there. dW and the channel sums are f32 sums of up to N products. The
# relative-norm limits reject an output 10% wrong on half its rows (about
# 0.07 off in norm).
DX_TOL = {"atol": 1e-2, "rtol": 2e-2, "rel_norm": 1e-2}
F32_TOL = {"atol": 1e-3, "rtol": 1e-3, "rel_norm": 1e-4}


def close(got, want, tol, what):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert bool(torch.isfinite(got).all()), what
    assert float((diff - tol["rtol"] * want.abs()).max()) <= tol["atol"], what
    rel = float(diff.norm() / want.norm().clamp_min(1e-30))
    assert rel <= tol["rel_norm"], f"{what}: rel norm {rel}"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen)
            * scale).to(torch.bfloat16)


# K7's wgmma kernels tile 128 x 128 with 64-deep k-steps and split dW's rows
# by k7_dw_chunks: N off the 128-row tile and off the chunks (1000, 777,
# 4000, 6300), 64- and 192-channel tails under a 128-wide tile, and one
# stage-3 site of ResNet-50 (6,272 rows 512 -> 2048)
@pytest.mark.gpu
@pytest.mark.parametrize("n,ci,co", [(128, 64, 128), (1000, 128, 64),
                                     (6272, 256, 192), (300, 64, 64),
                                     (777, 64, 192), (4000, 192, 64),
                                     (6300, 192, 192), (6272, 512, 2048)])
def test_conv1x1_bwd_matches_plain(n, ci, co):
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, g, w = randn(gen, n, ci), randn(gen, n, co), randn(gen, ci, co,
                                                            scale=0.05)
    dx, dw = tcv.conv1x1_bwd(x, g, w)
    dx_p, dw_p = tcv.conv1x1_bwd_plain(x, g, w)
    torch.cuda.synchronize()
    close(dx, dx_p, DX_TOL, "dx")
    close(dw, dw_p, F32_TOL, "dw")
    again = tcv.conv1x1_bwd(x, g, w)[1]
    assert torch.equal(dw, again), "dW is not the same bits run to run"


def bn_inputs(gen, n, ci, co):
    """x, g, y, w and the [co] f32 vectors (γ, β, μ, inv) of a fused unit
    with batch statistics."""
    x, g, w = randn(gen, n, ci), randn(gen, n, co), randn(gen, ci, co,
                                                            scale=0.1)
    y = (x.float() @ w.float()).to(torch.bfloat16)
    yf = y.float()
    mu = yf.mean(0)
    inv = torch.rsqrt((yf * yf).mean(0) - mu * mu + 1e-5)
    gamma = torch.linspace(0.5, 1.5, co, device="cuda")
    beta = torch.linspace(-0.3, 0.3, co, device="cuda")
    return x, g, y, w, (gamma, beta, mu, inv)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ci,co,relu", [(128, 64, 128, True),
                                          (512, 128, 64, False),
                                          (1000, 64, 256, True),
                                          (4100, 192, 128, False)])
def test_conv_bn_relu_bwd_matches_plain(n, ci, co, relu):
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, g, y, w, vecs = bn_inputs(gen, n, ci, co)
    got = tbn.conv_bn_relu_bwd(x, g, y, w, *vecs, relu)
    want = tbn.conv_bn_relu_bwd_plain(x, g, y, w, *vecs, relu)
    torch.cuda.synchronize()
    close(got[0], want[0], DX_TOL, "dx")
    for what, a, b in zip(("dw", "dgamma", "dbeta"), got[1:], want[1:]):
        close(a, b, F32_TOL, what)


# K8's wgmma products tile dx by 128 rows (x 64 or 128 ci) and dW by its
# k8_dw_tile, over 64-row k-steps: N off the row tile, off the k-step and
# off the chunks (1000, 777, 4100, 6300) at every (ci, co) pair of its
# ResNet-50 sites, with relu and without. Phase 1 is held against its
# plain version on the same sums, as chip_smoke.py holds it: with sums of
# another order a few dy flip a bf16 step, which at these sizes moves dW
# by more than F32_TOL's atol. Phase 0 is held on its own.
@pytest.mark.gpu
@pytest.mark.parametrize("n,ci,co,relu", [
    (1000, 64, 64, True), (777, 64, 64, False), (1000, 256, 64, True),
    (6300, 256, 64, False), (777, 64, 256, False), (6300, 64, 256, True),
    (4100, 256, 128, True), (1000, 256, 128, False), (777, 128, 512, False),
    (4100, 128, 512, True)])
def test_k8_phases_match_plain_at_the_site_channels(n, ci, co, relu):
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, g, y, w, vecs = bn_inputs(gen, n, ci, co)
    sums_p = tbn.bn_bwd_stats_plain(g, y, *vecs, relu)
    sums = tbn.bn_bwd_stats(g, y, *vecs, relu)
    dx = tbn.bn_bwd_dx(g, y, w, *vecs, sums_p, relu)
    dw = tbn.bn_bwd_dw(x, g, y, *vecs, sums_p, relu)
    again = tbn.bn_bwd_dw(x, g, y, *vecs, sums_p, relu)
    torch.cuda.synchronize()
    close(sums.t(), sums_p.t(), F32_TOL, "sums")
    close(dx, tbn.bn_bwd_dx_plain(g, y, w, *vecs, sums_p, relu), DX_TOL,
          "dx")
    close(dw, tbn.bn_bwd_dw_plain(x, g, y, *vecs, sums_p, relu), F32_TOL,
          "dw")
    assert torch.equal(dw, again), "dW is not the same bits run to run"


# K8 as two data ranks run it: the rows in two halves, phase 0 on each and
# the sums added (the all-reduce), phase 1 on each half with n_total = N,
# dx concatenated and the halves' dW added, against the plain version on
# all N rows with its own sums; one stage-0 and one stage-1 site of
# ResNet-50 at a rank's share of a batch of 16, and a ragged N. Phase 1
# runs on the split's own sums, so a few dy may flip a bf16 step against
# the plain ones: dW is held at DX_TOL, as chip_smoke.py holds it at its
# CONV_TOL
@pytest.mark.gpu
@pytest.mark.parametrize("n,ci,co,relu", [(50176, 256, 64, True),
                                          (12544, 128, 512, False),
                                          (2000, 64, 256, True)])
def test_k8_split_rows_take_the_global_row_count(n, ci, co, relu):
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, g, y, w, vecs = bn_inputs(gen, n, ci, co)
    halves = (slice(0, n // 2), slice(n // 2, n))

    def split():
        sums = sum(tbn.bn_bwd_stats(g[h], y[h], *vecs, relu) for h in halves)
        dx = torch.cat([tbn.bn_bwd_dx(g[h], y[h], w, *vecs, sums, relu, n)
                        for h in halves])
        dw = sum(tbn.bn_bwd_dw(x[h], g[h], y[h], *vecs, sums, relu, n)
                 for h in halves)
        return sums, dx, dw

    sums, dx, dw = split()
    again = split()
    torch.cuda.synchronize()
    sums_p = tbn.bn_bwd_stats_plain(g, y, *vecs, relu)
    close(sums.t(), sums_p.t(), F32_TOL, "sums")
    close(dx, tbn.bn_bwd_dx_plain(g, y, w, *vecs, sums_p, relu), DX_TOL,
          "dx")
    close(dw, tbn.bn_bwd_dw_plain(x, g, y, *vecs, sums_p, relu), DX_TOL,
          "dw")
    for a, b in zip((sums, dx, dw), again):
        assert torch.equal(a, b), "the split is not the same bits run to run"
    with pytest.raises(ValueError, match="n_total"):
        tbn.bn_bwd_dx(g, y, w, *vecs, sums, relu, n - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", [(128, 256), (1000, 64), (50000, 200)])
def test_channel_sum_matches_plain(n, c):
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    y = randn(gen, n, c)
    got = tbp.channel_sum(y)
    torch.cuda.synchronize()
    close(got, tbp.channel_sum_plain(y), F32_TOL, "sum")


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    need_card()
    x = torch.zeros(128, 48, device="cuda", dtype=torch.bfloat16)
    g = torch.zeros(128, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 64"):
        tcv.conv1x1_bwd(x, g, torch.zeros(48, 64, device="cuda",
                                          dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="expected"):
        tcv.conv1x1_bwd(g.float(), g, torch.zeros(64, 64, device="cuda"))
