"""GPipe of the port on 4 gloo ranks, (dp 2, pp 2) with 4 microbatches and
pp 4 with 2 (fewer microbatches than stages), against the serial loss and
the JAX package's gpipe_loss_fn at the same degrees (tests/test_pipeline.py
pins the same: the loss to 1e-6, the gradients to 1e-5), and its raise on
a batch that the microbatches do not divide; the scan-over-stages stance,
the bubble formulas and the bridge of the jobs' stage trees in this
process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import pipeline as jpl
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu.workloads.sharding import build_mesh as jbuild_mesh
from kubeoperator_tpu_torch.bridge import stage_params_from_jax
from kubeoperator_tpu_torch.workloads import pipeline as pl
from torch_dist_cases import spawn_group

torch.set_num_threads(2)

D, VOCAB, CLASSES, BATCH = 16, 8, 5, 16
# case → (its problem, the JAX mesh, microbatches)
CASES = {"gpipe_dp2_pp2": ("pp2", JMeshSpec(dp=2, pp=2), 4),
         "gpipe_pp4_uneven": ("pp4", JMeshSpec(pp=4), 2)}

JAX_FNS = dict(
    embed_fn=lambda p, x: p[x],
    stage_fn=lambda p, h: jnp.tanh(h @ p["w"]) + h,
    head_fn=lambda p, h: h @ p,
    loss_fn=lambda out, y: -jax.nn.log_softmax(out)[jnp.arange(y.shape[0]),
                                                    y])


def problem(n_stages: int, seed: int) -> dict:
    """The reference test's GPipe problem, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return {"embed": f(VOCAB, D), "stages": {"w": f(n_stages, D, D)},
            "head": f(D, CLASSES),
            "x": rng.integers(0, VOCAB, BATCH).astype(np.int32),
            "y": rng.integers(0, CLASSES, BATCH).astype(np.int32)}


def jax_serial(params, x, y):
    h = JAX_FNS["embed_fn"](params["embed"], x)
    for i in range(params["stages"]["w"].shape[0]):
        h = JAX_FNS["stage_fn"]({"w": params["stages"]["w"][i]}, h)
    return JAX_FNS["loss_fn"](JAX_FNS["head_fn"](params["head"], h), y).mean()


def jparams(p: dict) -> dict:
    return {k: jax.tree.map(jnp.asarray, p[k])
            for k in ("embed", "stages", "head")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    problems = {"pp2": problem(2, 0), "pp4": problem(4, 1)}
    inputs = {}
    for key, p in problems.items():
        tree = stage_params_from_jax(p)
        inputs[key] = {"embed": tree["embed"], "head": tree["head"],
                       "w": torch.stack([s["w"] for s in tree["stages"]]),
                       "x": torch.as_tensor(p["x"], dtype=torch.long),
                       "y": torch.as_tensor(p["y"], dtype=torch.long)}
    res = spawn_group("pipeline", 4, tmp_path_factory.mktemp("pipeline"),
                      inputs)
    return problems, res


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_serial_and_jax_gpipe(ranks, name):
    problems, res = ranks
    key, spec, n_micro = CASES[name]
    p = problems[key]
    x, y = jnp.asarray(p["x"]), jnp.asarray(p["y"])
    serial = float(jax_serial(jparams(p), x, y))
    piped = jpl.gpipe_loss_fn(jbuild_mesh(spec, jax.devices()[:4]),
                              n_micro=n_micro, **JAX_FNS)
    jax_gpipe = float(jax.jit(piped)(jparams(p), x, y))
    for r in res:
        np.testing.assert_allclose(r[name]["loss"], serial, atol=1e-6)
        np.testing.assert_allclose(r[name]["loss"], jax_gpipe, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_serial(ranks, name):
    """Each rank's stage gradient is its stage's; embed and head are the
    whole step's on every rank."""
    problems, res = ranks
    p = problems[CASES[name][0]]
    g = jax.grad(jax_serial)(jparams(p), jnp.asarray(p["x"]),
                             jnp.asarray(p["y"]))
    for r in res:
        got = r[name]
        stage = got["coords"]["pp"]
        for k, want in (("embed", g["embed"]), ("head", g["head"]),
                        ("w", g["stages"]["w"][stage])):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5, err_msg=k)


def test_gpipe_refuses_an_indivisible_batch(ranks):
    assert {r["gpipe_indivisible"]["error"] for r in ranks[1]} == {
        "batch 16 not divisible by n_micro 3"}


def mlp_stage(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def jax_mlp_stage(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def stages_np(n: int, d: int = 16) -> list:
    rng = np.random.default_rng(5)
    return [{"w1": (rng.standard_normal((d, d)) * 0.1).astype(np.float32),
             "b1": np.zeros(d, np.float32),
             "w2": (rng.standard_normal((d, d)) * 0.1).astype(np.float32),
             "b2": np.zeros(d, np.float32)} for _ in range(n)]


@pytest.mark.parametrize("remat", [True, False])
def test_scan_stages_matches_jax(remat):
    st = stages_np(4)
    x = np.random.default_rng(6).standard_normal((8, 16)).astype(np.float32)
    want = jpl.scan_stages(jax_mlp_stage, jpl.stack_stages(
        [jax.tree.map(jnp.asarray, s) for s in st]), jnp.asarray(x),
        remat=remat)
    stacked = pl.stack_stages([{k: torch.from_numpy(v) for k, v in s.items()}
                               for s in st])
    got = pl.scan_stages(mlp_stage, stacked, torch.from_numpy(x), remat=remat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_stack_unstack_roundtrip_and_three_phase_forward():
    st = [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages_np(3)]
    back = pl.unstack_stages(pl.stack_stages(st))
    for a, b in zip(st, back):
        assert all(torch.equal(a[k], b[k]) for k in a)
    params = {"embed": torch.randn(32, 16), "stages": pl.stack_stages(st),
              "head": torch.randn(16, 32)}
    logits = pl.pipeline_forward(lambda e, t: e[t], mlp_stage,
                                 lambda h, a: a @ h, params,
                                 torch.tensor([[1, 2, 3], [4, 5, 6]]))
    assert logits.shape == (2, 3, 32)


@pytest.mark.parametrize("pp,micro", [(1, 1), (2, 4), (4, 2), (8, 8)])
def test_bubble_fraction_is_the_reference_s(pp, micro):
    assert pl.bubble_fraction(pp, micro) == jpl.bubble_fraction(pp, micro)


def test_bubble_from_timings_is_the_reference_s():
    for args in ((1.0, 4, 1.5, 8, 4), (2.0, 2, 2.0, 4, 2), (1.0, 4, 0.5, 8, 4)):
        assert pl.bubble_from_timings(*args) == jpl.bubble_from_timings(*args)
    with pytest.raises(ValueError, match="distinct"):
        pl.bubble_from_timings(1.0, 4, 2.0, 4, 2)
    with pytest.raises(ValueError, match="must be >= 1"):
        pl.bubble_fraction(0, 4)
