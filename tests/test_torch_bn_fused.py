"""The port's fused (1×1 conv → BN → relu) unit against the JAX package's
(``workloads/bn_fused.py``), on the CPU in f32: K8's plain version against
the two-phase Pallas kernel run as the JAX tests run it (interpret mode),
at one row chunk and several, relu on and off, Ci ≠ Co; and the
``FusedConvBN`` module's output, gradients and running statistics, on the
fused path and on the N % 128 ≠ 0 fallback, and in eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kubeoperator_tpu.workloads import bn_fused as jbn
from kubeoperator_tpu_torch.workloads import bn_fused as tbn

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=2e-4)        # as tests/test_bn_fused.py


def unit_inputs(b, h, ci, co, seed=0):
    """x, g [B, H, H, ·], w [Ci, Co], γ, β, and the conv output y with its
    batch μ and inv = rsqrt(var + ε), all f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    g = rng.standard_normal((b, h, h, co)).astype(np.float32)
    w = (0.3 * rng.standard_normal((ci, co))).astype(np.float32)
    gamma = np.linspace(0.5, 1.5, co, dtype=np.float32)
    beta = np.linspace(-0.3, 0.3, co, dtype=np.float32)
    y = np.array(lax.conv_general_dilated(
        x, w[None, None], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    mu = y.mean((0, 1, 2))
    inv = (1.0 / np.sqrt((y * y).mean((0, 1, 2)) - mu * mu + 1e-5)
           ).astype(np.float32)
    return x, g, w, gamma, beta, y, mu.astype(np.float32), inv


@pytest.mark.parametrize("b,h,ci,co", [(2, 8, 8, 16), (8, 8, 16, 8)])
@pytest.mark.parametrize("relu", [True, False])
def test_k8_plain_matches_pallas_kernel(b, h, ci, co, relu):
    """N = 128 (one row chunk) and 512 (several)."""
    x, g, w, gamma, beta, y, mu, inv = unit_inputs(b, h, ci, co)
    want = jbn.conv_bn_relu_bwd(*map(jnp.asarray, (x, g, y, w, gamma, beta,
                                                   mu, inv)), relu)
    n = b * h * h
    t = torch.from_numpy
    got = tbn.conv_bn_relu_bwd(t(x).reshape(n, ci), t(g).reshape(n, co),
                               t(y).reshape(n, co), t(w), t(gamma), t(beta),
                               t(mu), t(inv), relu)
    for name, a, b_ in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.reshape(b_.shape).numpy(),
                                   np.asarray(b_), err_msg=name, **TOL)


def test_forward_math_matches_jax():
    x, _, w, gamma, beta, *_ = unit_inputs(2, 8, 8, 16, seed=1)
    t = torch.from_numpy
    for relu in (True, False):
        want = jbn._forward_math(jnp.asarray(x), jnp.asarray(w)[None, None],
                                 jnp.asarray(gamma), jnp.asarray(beta), 1e-5,
                                 relu)
        got = tbn.forward_math(t(x), t(w)[None, None], t(gamma), t(beta),
                               1e-5, relu)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


def module_pair(b, h, ci, co, relu, train, seed=2):
    """One forward (and backward under a random cotangent) of the JAX
    ``FusedConvBN`` and of the port's on the same params."""
    x, g, *_ = unit_inputs(b, h, ci, co, seed=seed)
    rng = np.random.default_rng(seed + 1)
    mod = jbn.FusedConvBN(co, relu=relu, use_running_average=not train,
                          dtype=jnp.float32)
    v = mod.init(jax.random.key(0), jnp.asarray(x))
    params = {"kernel": np.asarray(v["params"]["kernel"]),
              "scale": (1 + 0.2 * rng.standard_normal(co)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(co)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(co)).astype(np.float32),
             "var": (1 + 0.1 * rng.random(co)).astype(np.float32)}

    def loss(p, xx):
        out, upd = mod.apply({"params": p, "batch_stats": stats}, xx,
                             mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd)

    (_, (out, upd)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    m = tbn.FusedConvBN(ci, co, relu=relu, dtype=torch.float32)
    m.load_state_dict({k: torch.tensor(v) for k, v in
                       {**params, **stats}.items()})
    m.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(g)).sum().backward()
    want = {"out": out, "dx": gx, **{f"d{k}": gp[k] for k in params},
            **upd["batch_stats"]}
    got = {"out": y.detach(), "dx": xt.grad,
           **{f"d{k}": getattr(m, k).grad for k in params},
           "mean": m.mean, "var": m.var}
    return got, want


@pytest.mark.parametrize("b,h", [(2, 8), (3, 5)])     # N = 128, N = 75
@pytest.mark.parametrize("relu", [True, False])
def test_module_matches_jax_in_training(b, h, relu):
    got, want = module_pair(b, h, 8, 16, relu, train=True)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   err_msg=name, **TOL)


def test_module_matches_jax_in_eval_mode():
    got, want = module_pair(2, 8, 8, 16, True, train=False)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]),
                               atol=1e-5, rtol=1e-5)


def test_fused_path_runs_k8_only_at_n_multiple_of_128(monkeypatch):
    calls = []
    real = tbn.conv_bn_relu_bwd
    monkeypatch.setattr(tbn, "conv_bn_relu_bwd",
                        lambda *a: calls.append(a) or real(*a))
    for (b, h), runs in (((2, 8), 1), ((3, 5), 0)):
        calls.clear()
        m = tbn.FusedConvBN(8, 16, dtype=torch.float32)
        m.reset_parameters(torch.Generator().manual_seed(0))
        m(torch.randn(b, h, h, 8, requires_grad=True)).sum().backward()
        assert len(calls) == runs


def test_seeded_init_mirrors_flax():
    m = tbn.FusedConvBN(8, 16, relu=False, zero_scale=True)
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert not m.scale.any() and not m.bias.any()
    assert torch.equal(m.mean, torch.zeros(16))
    assert torch.equal(m.var, torch.ones(16))
    assert tuple(m.kernel.shape) == (1, 1, 8, 16)
