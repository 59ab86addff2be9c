"""BatchNorm's kernels (``csrc/batch_norm.cu``: the forward sums and
statistics, the normalize + relu, the backward sums and dx) against their
plain PyTorch versions on the card, at ragged row counts (1, 511, 513,
4,097: off the kernels' row chunks and four-row unroll) and channel counts
(8: one group of eight; 200: a block's 25 groups, not a power of two;
2048: eight blocks of 256), and at ResNet-50's stage-0 shape at batch 256
(802,816 rows × 64); then ``BatchNormTrain``'s gradients against autograd
of the f32 op chain it replaces. Imports no JAX, so it runs where the
kernels build:

    python -m pytest --noconftest -m gpu tests/test_torch_bn_cuda.py

Without a card every test skips."""

import pytest
import torch

from kubeoperator_tpu_torch.workloads import batch_norm as tbk

torch.set_num_threads(2)

# the statistics and the backward sums: f32 sums over up to 802,816 rows,
# taken in another order than the plain version's (and inv a correctly
# rounded 1/sqrt against torch.rsqrt): a few ulps relative, far under
# these limits; an output 10% off on half its entries is 0.07 off in norm
F32_TOL = {"atol": 1e-3, "rtol": 1e-3, "rel_norm": 1e-4}
# the Function against the op chain: out and dx are bf16 roundings of f32
# values whose statistics were summed in another order (and, for dx, by
# the closed form instead of autograd's chain), so an element may land a
# bf16 step (2^-8 relative) away; dγ and dβ are f32 sums of the same
# products in another order
BF16_TOL = {"atol": 2e-2, "rtol": 1e-2, "rel_norm": 1e-2}
GRAD_TOL = {"atol": 1e-2, "rtol": 1e-3, "rel_norm": 1e-4}
SHAPES = [(n, c) for n in (1, 511, 513, 4097) for c in (8, 64, 200, 2048)]


def close(got, want, tol, what):
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    assert bool(torch.isfinite(got).all()), what
    assert float((diff - tol["rtol"] * want.abs()).max()) <= tol["atol"], what
    rel = float(diff.norm() / want.norm().clamp_min(1e-30))
    assert rel <= tol["rel_norm"], f"{what}: rel norm {rel}"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def inputs(n, c, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, c, device="cuda", generator=gen) * 2
         + 0.5).to(torch.bfloat16)
    g = torch.randn(n, c, device="cuda", generator=gen).to(torch.bfloat16)
    gamma = 1 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    return x, g, gamma, beta


def running(c):
    return torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")


def check_kernels(n, c, relu, clip):
    x, g, gamma, beta = inputs(n, c)
    got_run, want_run = running(c), running(c)
    got = tbk.bn_fwd_sums(x, *got_run, 0.9, 1e-5, clip)
    mean, var, inv = tbk.bn_fwd_sums_plain(x, *want_run, 0.9, 1e-5, clip)
    for a, b, what in zip((*got, *got_run), (mean, var, inv, *want_run),
                          ("mean", "var", "inv", "run_mean", "run_var")):
        close(a, b, F32_TOL, what)
    again = tbk.bn_fwd_sums(x, *running(c), 0.9, 1e-5, clip)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "twice"
    # the apply and dx on the plain version's statistics and sums: one f32
    # operation at a time in the same order, so the same bits
    out = tbk.bn_fwd_apply(x, mean, gamma, inv, beta, relu)
    out_p = tbk.bn_fwd_apply_plain(x, mean, gamma, inv, beta, relu)
    assert torch.equal(out, out_p), "apply"
    sums = tbk.bn_bwd_sums(x, g, out_p, mean, inv, relu)
    sums_p = tbk.bn_bwd_sums_plain(x, g, out_p, mean, inv, relu)
    close(sums, sums_p, F32_TOL, "bwd sums")
    assert torch.equal(sums, tbk.bn_bwd_sums(x, g, out_p, mean, inv, relu))
    dx = tbk.bn_bwd_dx(x, g, out_p, mean, inv, gamma, sums_p, relu)
    dx_p = tbk.bn_bwd_dx_plain(x, g, out_p, mean, inv, gamma, sums_p, relu)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx_p), "dx"


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", SHAPES)
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_kernels_match_plain(n, c, relu):
    need_card()
    check_kernels(n, c, relu, clip=relu)


@pytest.mark.gpu
def test_kernels_match_plain_at_resnet50_stage0():
    need_card()
    check_kernels(802816, 64, True, True)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [True, False])
def test_data_groups_route_gives_the_same_statistics(clip):
    """Under data groups the forward's sums leave the first launch, are
    all-reduced and come back to the finisher; over a group of one rank
    (``None``: the all-reduce is the identity) the statistics and the
    running update are the same bits as without groups."""
    need_card()
    x = inputs(4097, 200)[0]
    want_run, got_run = running(200), running(200)
    want = tbk.bn_fwd_sums(x, *want_run, 0.9, 1e-5, clip)
    got = tbk.bn_fwd_sums(x, *got_run, 0.9, 1e-5, clip, (None,))
    torch.cuda.synchronize()
    for a, b in zip((*got, *got_run), (*want, *want_run)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_n_total_and_data_rows():
    """dx over half the rows with N the whole batch's (a data rank's
    share) equals that half of dx over all the rows."""
    need_card()
    x, g, gamma, beta = inputs(4097, 64)
    mean, _, inv = tbk.bn_fwd_sums_plain(x, *running(64), 0.9, 1e-5, True)
    out = tbk.bn_fwd_apply_plain(x, mean, gamma, inv, beta, True)
    sums = tbk.bn_bwd_sums_plain(x, g, out, mean, inv, True)
    whole = tbk.bn_bwd_dx(x, g, out, mean, inv, gamma, sums, True)
    half = tbk.bn_bwd_dx(x[:2048], g[:2048], out[:2048], mean, inv, gamma,
                         sums, True, n_total=4097)
    assert torch.equal(half, whole[:2048])
    with pytest.raises(ValueError, match="n_total"):
        tbk.bn_bwd_dx(x, g, out, mean, inv, gamma, sums, True, n_total=4)


def chain(x, gamma, beta, relu):
    """The f32 op chain the kernels replace (``resnet.BatchNorm``'s plain
    ops)."""
    xf = x.float()
    mean, msq = xf.mean((0, 1, 2)), (xf * xf).mean((0, 1, 2))
    var = torch.maximum(msq - mean * mean, xf.new_zeros(()))
    y = ((xf - mean) * (torch.rsqrt(var + 1e-5) * gamma) + beta).to(x.dtype)
    return torch.relu(y) if relu else y


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", [(513, 200), (4097, 64), (200704, 128)])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_function_gradients_match_the_op_chain(n, c, relu):
    need_card()
    x, g, gamma, beta = inputs(n, c, seed=1)
    x4, g4 = x.view(n, 1, 1, c), g.view(n, 1, 1, c)
    grads = []
    for f in ("function", "chain"):
        xr = x4.clone().requires_grad_()
        gr, br = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        out = (tbk.BatchNormTrain.apply(xr, gr, br, running(c), 0.9, 1e-5,
                                        relu, True, ())
               if f == "function" else chain(xr, gr, br, relu))
        grads.append((out, *torch.autograd.grad(out, (xr, gr, br), g4)))
    (out, dx, dg, db), (out_c, dx_c, dg_c, db_c) = grads
    close(out, out_c, BF16_TOL, "out")
    close(dx, dx_c, BF16_TOL, "dx")
    close(dg, dg_c, GRAD_TOL, "dgamma")
    close(db, db_c, GRAD_TOL, "dbeta")
