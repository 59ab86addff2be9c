"""``batch_norm.BatchNormTrain`` (the training-mode BatchNorm that runs on
the kernels of ``csrc/batch_norm.cu`` on the card) on its plain versions,
on the CPU, against the formulation it replaces under autograd: the
module's (``resnet.BatchNorm``, var clipped at 0) and the K8 unit's primal
(``bn_fused.forward_math``, not clipped). Then the dispatch, with
``kernels.runs_plain`` patched to say "card" and the kernels' wrappers
stubbed by their counted plain versions: which inputs take the kernels,
which the plain ops (counted under ``bn_plain``), and a ResNet-50 step's
launches, one of each forward wrapper at each of its 53 BatchNorm sites
and one of each backward wrapper where no K8 unit takes the backward."""

import pytest
import torch

from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.workloads import batch_norm as tbk
from kubeoperator_tpu_torch.workloads import bn_fused as tbn
from kubeoperator_tpu_torch.workloads import conv_vjp as tcv
from kubeoperator_tpu_torch.workloads import resnet as trn

torch.set_num_threads(2)

# f32: the same formula, the sums over rows taken in another order (Σx
# and Σx² against the mean of x and of x²; the closed-form gradient
# against autograd's chain): a few f32 ulps of the largest value. bf16:
# out and dx are rounded to bf16 from f32 values that differ by those
# ulps, so an element may land one bf16 step (2^-8 relative) away.
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
F32_TOL = dict(atol=2e-5, rtol=2e-5)        # μ, var, the running stats,
                                            # dγ and dβ: f32 in both
MOMENTUM, EPS = 0.9, 1e-5


def inputs(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen).to(dtype)
    gamma = 1 + 0.2 * torch.randn(c, generator=gen)
    beta = 0.1 * torch.randn(c, generator=gen)
    return x, g, gamma, beta


def reference(x, g, gamma, beta, relu, clip):
    """The replaced formulation under autograd: out, μ, var, the running
    statistics after one step from (0, 1), and the gradients of x, γ, β
    of Σ out·g."""
    x = x.clone().requires_grad_()
    gamma = gamma.clone().requires_grad_()
    beta = beta.clone().requires_grad_()
    c = x.shape[-1]
    if clip:
        m = trn.BatchNorm(c, dtype=x.dtype, relu=relu)
        with torch.no_grad():
            m.scale.copy_(gamma)
            m.bias.copy_(beta)
        out = m(x)
        xf = x.detach().float()
        mean, msq = tbn.batch_moments(xf)
        var = torch.clamp_min(msq - mean * mean, 0.0)
        running = (m.mean, m.var)
        gamma, beta = m.scale, m.bias
    else:
        eye = torch.eye(c, dtype=x.dtype)[None, None]   # the conv is x
        out, mean, var, _, _ = tbn.forward_math(x, eye, gamma, beta, EPS,
                                                relu)
        running = (torch.zeros(c), torch.ones(c))
        tbk.update_running(running, MOMENTUM, mean.detach(), var.detach())
    (out.float() * g.float()).sum().backward()
    return {"out": out.detach(), "mean": mean.detach(), "var": var.detach(),
            "run_mean": running[0], "run_var": running[1], "dx": x.grad,
            "dgamma": gamma.grad, "dbeta": beta.grad}


def function(x, g, gamma, beta, relu, clip):
    x = x.clone().requires_grad_()
    gamma = gamma.clone().requires_grad_()
    beta = beta.clone().requires_grad_()
    c = x.shape[-1]
    running = (torch.zeros(c), torch.ones(c))
    out = tbk.BatchNormTrain.apply(x, gamma, beta, running, MOMENTUM, EPS,
                                   relu, clip, ())
    (out.float() * g.float()).sum().backward()
    mean, var, _ = tbk.bn_fwd_sums(x.detach().view(-1, c), torch.zeros(c),
                                   torch.ones(c), MOMENTUM, EPS, clip)
    return {"out": out.detach(), "mean": mean, "var": var,
            "run_mean": running[0], "run_var": running[1], "dx": x.grad,
            "dgamma": gamma.grad, "dbeta": beta.grad}


# N = 105 and 64·7 = 448 rows: off any power of two
@pytest.mark.parametrize("shape", [(3, 5, 7, 16), (2, 4, 56, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("clip", [True, False], ids=["module", "k8_primal"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_function_matches_the_replaced_formulation(shape, dtype, clip, relu):
    x, g, gamma, beta = inputs(shape, dtype)
    got = function(x, g, gamma, beta, relu, clip)
    want = reference(x, g, gamma, beta, relu, clip)
    assert got["out"].dtype == got["dx"].dtype == dtype
    for k in ("out", "dx"):
        torch.testing.assert_close(got[k].float(), want[k].float(),
                                   **TOL[dtype], msg=k)
    for k in ("mean", "var", "run_mean", "run_var", "dgamma", "dbeta"):
        torch.testing.assert_close(got[k], want[k], **F32_TOL, msg=k)


def test_relu_gate_is_the_forward_output():
    """Where the output is exactly 0 (β = 0 and x at the mean) the gate
    closes: the gradient there is the closed form's with g′ = 0."""
    x = torch.tensor([[-1.0, 2.0], [1.0, -2.0], [0.0, 0.0]])[:, None, None]
    g = torch.ones_like(x)
    gamma, beta = torch.ones(2), torch.zeros(2)
    got = function(x, g, gamma, beta, True, True)
    want = reference(x, g, gamma, beta, True, True)
    assert float(got["out"][2].abs().max()) == 0.0
    torch.testing.assert_close(got["dx"], want["dx"], **F32_TOL)
    torch.testing.assert_close(got["dbeta"], torch.tensor([1.0, 1.0]))


def test_plan_covers_the_rows_in_one_wave():
    for n, c in ((1, 8), (511, 64), (513, 200), (4097, 2048),
                 (802816, 64), (802816, 256), (12544, 2048)):
        rows, chunks = tbk.plan(n, c)
        assert rows * chunks >= n > rows * (chunks - 1)
        col_blocks = -(-c // (min(c // 8, 32) * 8))
        assert col_blocks * chunks <= tbk.BLOCKS + col_blocks
        assert rows >= min(n, tbk.MIN_ROWS)


# ---------------------------------------------------------------------------
# dispatch: "the card" faked, the wrappers stubbed by their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """kernels.runs_plain says "card"; each BatchNorm wrapper runs its
    plain version and counts a launch; K7 and K8 run their plain
    versions. Yields the launch counts, reset."""
    monkeypatch.setattr(kernels, "runs_plain", lambda x: False)

    def stub(name, plain):
        def run(*args, **kw):
            tbk.LAUNCHES[name] += 1
            return plain(*args, **kw)
        monkeypatch.setattr(tbk, name, run)

    for name in ("bn_fwd_sums", "bn_fwd_apply", "bn_bwd_sums", "bn_bwd_dx"):
        stub(name, getattr(tbk, f"{name}_plain"))
    monkeypatch.setattr(tcv, "conv1x1_bwd", tcv.conv1x1_bwd_plain)
    monkeypatch.setattr(
        tbn, "conv_bn_relu_bwd",
        lambda *a: tbn.conv_bn_relu_bwd_plain(*a[:9]))
    tbk.reset_launches()
    yield tbk.LAUNCHES
    tbk.reset_launches()


def step(module, shape, dtype=torch.bfloat16):
    x, g, _, _ = inputs(shape, dtype)
    x.requires_grad_()
    (module(x).float() * g.float()).sum().backward()
    return x.grad


def counts(fwd_sums=0, fwd_apply=0, bwd_sums=0, bwd_dx=0, plain=0):
    return {"bn_fwd_sums": fwd_sums, "bn_fwd_apply": fwd_apply,
            "bn_bwd_sums": bwd_sums, "bn_bwd_dx": bwd_dx, "bn_plain": plain}


def test_batch_norm_on_the_card_launches_each_kernel_once(card):
    m = trn.BatchNorm(16, relu=True)
    m.reset_parameters(None)
    step(m, (2, 4, 4, 16))
    assert card == counts(1, 1, 1, 1)
    m.eval()
    with torch.no_grad():
        m(inputs((2, 4, 4, 16), torch.bfloat16)[0])
    assert card == counts(1, 2, 1, 1)


def test_fused_unit_on_the_card_takes_the_forward_kernels(card):
    """The K8 unit (N = 128) takes the forward's sums and apply; its
    backward stays K8's."""
    m = tbn.FusedConvBN(16, 16, relu=True)
    m.reset_parameters(torch.Generator().manual_seed(0))
    step(m, (2, 8, 8, 16))
    assert card == counts(1, 1)


@pytest.mark.parametrize("shape,dtype,plain", [
    ((2, 4, 4, 12), torch.bfloat16, 1),     # channels not a multiple of 8
    ((2, 4, 4, 16), torch.float32, 1),      # not bf16
])
def test_other_card_inputs_take_the_plain_ops_and_count(card, shape, dtype,
                                                         plain):
    m = trn.BatchNorm(shape[-1], dtype=dtype, relu=True)
    m.reset_parameters(None)
    step(m, shape, dtype)
    assert card == counts(plain=plain)


def test_cpu_inputs_take_the_plain_ops_uncounted():
    tbk.reset_launches()
    m = trn.BatchNorm(16, relu=True)
    m.reset_parameters(None)
    step(m, (2, 4, 4, 16))
    assert tbk.LAUNCHES == counts()


@pytest.mark.parametrize("path,want", [
    # 44 plain BatchNorms take the closed-form backward; 9 K8 units K8's
    ("k7k8", counts(53, 53, 44, 44)),
    ("job", counts(53, 53, 53, 53)),
])
def test_resnet50_step_launches_each_site_once(card, path, want):
    """One training step of ResNet-50 at 224² (width 8, batch 8: every
    fused unit's rows a multiple of 128, as at batch 256): the launches
    the benchmark's two one-card ResNet paths make."""
    modes = {"k7k8": dict(stem="space_to_depth", dw_dot_max_k=1,
                          conv_bwd="pallas", fused_bn=True),
             "job": dict(stem="space_to_depth")}[path]
    model = trn.ResNet(num_classes=10, depth=50, width=8, **modes)
    model.reset_parameters(0)
    x = inputs((8, 224, 224, 3), torch.float32)[0]
    model(x).float().sum().backward()
    assert card == want
