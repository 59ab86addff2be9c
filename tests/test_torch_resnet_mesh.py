"""The port's ResNet over a mesh of 2 gloo ranks against the JAX package,
in f32 on the CPU:

- ``FusedConvBN`` at dp 2 (K8's plain version, its phase-0 sums
  all-reduced between the phases, phase 1 over the global row count)
  against the JAX ``fused_conv_bn`` (its Pallas kernel in interpret mode)
  on the whole batch, at K8's CPU tolerance 2e-4: out, running statistics
  and the gradients of x, the kernel, γ and β. At 128 rows the ranks hold
  64 each and take the autograd fallback while the reference's whole batch
  takes the kernel: the two paths compute one function.
- The plain ``BatchNorm`` at dp 2 against flax's on the whole batch, at
  1e-5, and the same step through ``batch_norm.BatchNormTrain`` (the
  card's route: sums all-reduced before the statistics and before dx, on
  its plain versions here).
- Three ``Trainer`` steps (ResNet-18 at 32², the custom-backward 1×1 convs
  of tests/test_torch_resnet.py's ``three_steps``) at dp 2 and at fsdp 2
  against the JAX ``Trainer`` at the same ``MeshSpec`` on 2 virtual CPU
  devices: losses, params and batch statistics at 1e-5.

The reference runs BatchNorm with ``axis_name=None`` under GSPMD, which
computes its statistics over the global array, so a whole-batch run on
one device is its semantics; the unit tests take that run, the trainer
test the meshed one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeoperator_tpu.workloads import bn_fused as jbn
from kubeoperator_tpu.workloads import train as jtrain
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu_torch.bridge import resnet_params_from_jax
from kubeoperator_tpu_torch.workloads import train as ttrain
from torch_dist_cases import spawn_group

torch.set_num_threads(2)

K8_TOL = dict(atol=2e-4, rtol=2e-4)          # as tests/test_bn_fused.py
# (batch, size, Ci, Co, relu) of the FusedConvBN cases: 256 and 128 rows
FUSED = {"fused_n256": (4, 8, 8, 16, True),
         "fused_n128_split": (2, 8, 8, 16, True),
         "fused_n256_norelu": (4, 8, 16, 8, False)}
FIELDS = dict(batch_size=4, image_size=32, num_classes=10, depth=18,
              warmup_steps=2, total_steps=10, dw_dot_max_k=1,
              conv_bwd="pallas")
TRAINERS = {"trainer_dp2": JMeshSpec(dp=2), "trainer_fsdp2": JMeshSpec(fsdp=2)}


def unit_params(co: int, rng) -> dict:
    return {"scale": (1 + 0.2 * rng.standard_normal(co)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(co)).astype(np.float32),
            "mean": (0.1 * rng.standard_normal(co)).astype(np.float32),
            "var": (1 + 0.1 * rng.random(co)).astype(np.float32)}


def jax_unit(module, params: dict, stats: dict, x, g) -> dict:
    """out, running stats and the gradients of Σ out·g on the whole
    batch."""
    def loss(p, xx):
        out, upd = module.apply({"params": p, "batch_stats": stats}, xx,
                                mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd["batch_stats"])

    (_, (out, upd)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return {"out": out, "dx": gx, **{f"d{k}": v for k, v in gp.items()},
            **upd}


def fused_case(b, h, ci, co, relu, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    g = rng.standard_normal((b, h, h, co)).astype(np.float32)
    vals = unit_params(co, rng)
    kernel = (0.3 * rng.standard_normal((1, 1, ci, co))).astype(np.float32)
    mod = jbn.FusedConvBN(co, relu=relu, dtype=jnp.float32)
    want = jax_unit(mod, {"kernel": kernel, "scale": vals["scale"],
                          "bias": vals["bias"]},
                    {"mean": vals["mean"], "var": vals["var"]}, x, g)
    t = torch.from_numpy
    return ({"x": t(x), "g": t(g), "kernel": t(kernel), "relu": relu,
             **{k: t(v) for k, v in vals.items()}}, want)


def bn_case(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 4, 4, 16)).astype(np.float32)
    g = rng.standard_normal((4, 4, 4, 16)).astype(np.float32)
    vals = unit_params(16, rng)
    mod = nn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32, axis_name=None)
    want = jax_unit(mod, {"scale": vals["scale"], "bias": vals["bias"]},
                    {"mean": vals["mean"], "var": vals["var"]}, x, g)
    t = torch.from_numpy
    return {"x": t(x), "g": t(g), **{k: t(v) for k, v in vals.items()}}, want


def jax_trainer(spec: JMeshSpec, x, y) -> dict:
    jt = jtrain.Trainer(jtrain.TrainConfig(dtype=jnp.float32, **FIELDS),
                        spec, devices=jax.devices()[:2])
    state = jt.init_state(jax.random.key(0))
    start = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    losses = []
    for _ in range(3):
        state, metrics = jt.train_step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(metrics["loss"]))
    end = jax.tree.map(np.asarray, {"params": state.params,
                                    "batch_stats": state.batch_stats})
    split = sorted(tuple(x.shape) for x, s in zip(
        jax.tree.leaves(state.params),
        jax.tree.leaves(jt.state_shardings.params)) if "fsdp" in s.spec)
    return {"start": start, "losses": losses, "end": end, "split": split}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    fused = {name: fused_case(*args) for name, args in FUSED.items()}
    bn_in, bn_want = bn_case()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = np.array([1, 3, 5, 7], np.int32)
    trainers = {name: jax_trainer(spec, x, y)
                for name, spec in TRAINERS.items()}
    cfg = ttrain.TrainConfig(dtype=torch.float32, **FIELDS)
    # both JAX runs start from one seed's variables
    params = resnet_params_from_jax(trainers["trainer_dp2"]["start"], cfg)
    inputs = {"units": {**{k: v[0] for k, v in fused.items()},
                        "bn_dp2": bn_in},
              "trainer": {"cfg": cfg, "params": params,
                          "x": torch.from_numpy(x),
                          "y": torch.from_numpy(y).long()}}
    ranks = spawn_group("resnet", 2, tmp_path_factory.mktemp("resnet"),
                        inputs)
    want = {**{k: v[1] for k, v in fused.items()}, "bn_dp2": bn_want}
    return ranks, want, trainers, cfg


def joined(ranks, case: str) -> dict:
    """Each rank's rows concatenated, its gradient shares summed; the
    running statistics, which every rank must hold alike, as rank 0's."""
    a, b = ranks[0][case], ranks[1][case]
    for k in ("mean", "var"):
        assert torch.equal(a[k], b[k]), k
    return {k: (torch.cat([a[k], b[k]]) if k in ("out", "dx")
                else a[k] + b[k] if k.startswith("d") else a[k])
            for k in a if k != "rows"}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_unit_at_dp2_matches_the_whole_batch(runs, case):
    ranks, want, _, _ = runs
    b, h = FUSED[case][:2]
    rows = ranks[0][case]["rows"]
    assert rows == b * h * h // 2
    # the split case: the ranks' 64 rows take the fallback, the whole
    # batch's 128 the kernel
    assert (rows % 128 != 0) == (case == "fused_n128_split")
    got = joined(ranks, case)
    assert set(got) == set(want[case])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[case][k]),
                                   err_msg=k, **K8_TOL)


def test_batch_norm_at_dp2_matches_flax_on_the_whole_batch(runs):
    ranks, want, _, _ = runs
    got = joined(ranks, "bn_dp2")
    assert set(got) == set(want["bn_dp2"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want["bn_dp2"][k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_batch_norm_function_at_dp2_matches_flax_on_the_whole_batch(runs):
    ranks, want, _, _ = runs
    got = joined(ranks, "bn_function_dp2")
    assert set(got) == set(want["bn_dp2"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want["bn_dp2"][k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(TRAINERS))
def test_trainer_losses_match_jax(runs, case):
    ranks, _, trainers, _ = runs
    for r in ranks:                       # every rank reports the global loss
        np.testing.assert_allclose(r[case]["losses"],
                                   trainers[case]["losses"], rtol=1e-5)
        assert r[case]["step"] == 3


@pytest.mark.parametrize("case", list(TRAINERS))
def test_trainer_params_and_batch_stats_match_jax(runs, case):
    ranks, _, trainers, cfg = runs
    want = resnet_params_from_jax(trainers[case]["end"], cfg)
    for r in ranks:
        got = {**r[case]["params"], **r[case]["buffers"]}
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", list(TRAINERS))
def test_placement_by_shape_splits_what_the_reference_splits(runs, case):
    """The parameters each mesh splits over fsdp (none at dp 2), by
    their whole shapes, against the reference's state shardings."""
    ranks, _, trainers, _ = runs
    got = sorted(tuple(ranks[0][case]["params"][name].shape)
                 for name, dims in ranks[0][case]["placements"].items()
                 if "fsdp" in dims)
    assert got == trainers[case]["split"]
    assert bool(got) == (case == "trainer_fsdp2")
