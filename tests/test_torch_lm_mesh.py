"""One f32 LMTrainer step of the port on 4 gloo ranks at (dp 2, sp 2) with
ring attention, (fsdp 2, tp 2) with remat, (tp 2, sp 2) with Ulysses and
(dp 2, tp 2) over two virtual slices, against the JAX LMTrainer at the same degrees on the 4 virtual CPU
devices, on its own weights bridged to the port: the loss, the gradients
and the parameters after one AdamW step to 1e-5, the tolerance of the
one-device step (tests/test_torch_lm.py). Also the reference's
sp-equals-dp check (tests/test_lm.py) and a DTensor handed to each kernel
wrapper, which must raise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeoperator_tpu.workloads.lm import LMTrainer as JaxLMTrainer
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu.workloads.sharding import with_virtual_slices
from kubeoperator_tpu_torch.bridge import params_from_jax
from test_torch_bridge import JAX_TINY, port_cfg, tokens
from torch_dist_cases import spawn_group

torch.set_num_threads(2)

# case → (the JAX mesh, config changes); the port runs the same degrees.
# The multislice case puts dp across two virtual slices of two devices
# (ranks), tp inside each: the reference's build_mesh on
# with_virtual_slices(devices, 2), the port's on with_virtual_slices(4, 2)
CASES = {
    "dp2_sp2_ring": (JMeshSpec(dp=2, sp=2), {}),
    "fsdp2_tp2": (JMeshSpec(fsdp=2, tp=2), {}),
    "tp2_sp2_ulysses": (JMeshSpec(tp=2, sp=2), {"sp_attention": "ulysses"}),
    "dp2_tp2_multislice": (JMeshSpec(dp=2, tp=2), {}),
}
WRAPPERS = ("flash_fwd", "flash_bwd_dq", "flash_fwd_packed", "conv1x1_bwd_dx",
            "bn_bwd_stats", "channel_sum")


def jax_step(name: str, toks: np.ndarray) -> dict:
    spec, changes = CASES[name]
    jcfg = dataclasses.replace(JAX_TINY, **changes)
    devices = jax.devices()[:4]
    if name.endswith("multislice"):
        devices = with_virtual_slices(devices, 2)
    jt = JaxLMTrainer(jcfg, spec, devices=devices)
    state = jt.init_state(jax.random.key(11))
    params = jax.tree.map(np.asarray, state["params"])

    def loss_fn(p):
        logits = jt.model.apply({"params": p}, jnp.asarray(toks))
        t = toks.shape[1]
        mask = (jnp.arange(t) < t - 1).astype(jnp.float32)[None, :]
        losses = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(jnp.asarray(toks), -1, axis=1))
        return (losses * mask).sum() / mask.sum()

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(
        state["params"]))
    new_state, metrics = jt.train_step(state, jnp.asarray(toks))
    return {"cfg": jcfg, "params": params, "loss": float(metrics["loss"]),
            "grads": grads,
            "new": jax.tree.map(np.asarray, new_state["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    toks = tokens(4, 32, JAX_TINY.vocab_size, seed=9)
    jax_runs = {name: jax_step(name, toks) for name in CASES}
    inputs = {"cfg": port_cfg(JAX_TINY),
              "params": {name: params_from_jax(r["params"], r["cfg"])
                         for name, r in jax_runs.items()},
              "tokens": torch.as_tensor(toks, dtype=torch.long)}
    ranks = spawn_group("lm", 4, tmp_path_factory.mktemp("lm"), inputs)
    return jax_runs, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(runs, name):
    jax_runs, ranks = runs
    losses = [r[name]["loss"] for r in ranks]
    assert losses == [losses[0]] * 4          # every rank reports the global loss
    np.testing.assert_allclose(losses[0], jax_runs[name]["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(runs, name):
    jax_runs, ranks = runs
    want = params_from_jax(jax_runs[name]["grads"], jax_runs[name]["cfg"])
    got = ranks[0][name]["grads"]
    assert set(got) == set(want)
    for key, g in got.items():
        torch.testing.assert_close(g, want[key], atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{key}: {m}")


@pytest.mark.parametrize("name", list(CASES))
def test_adamw_step_matches_jax(runs, name):
    jax_runs, ranks = runs
    want = params_from_jax(jax_runs[name]["new"], jax_runs[name]["cfg"])
    for r in ranks:                           # every rank holds the same model
        for key, p in r[name]["params"].items():
            torch.testing.assert_close(p, want[key], atol=1e-5, rtol=1e-5,
                                       msg=lambda m: f"{key}: {m}")


def test_sp_matches_dp_loss(runs):
    """Splitting the sequence must not change the numbers: (dp 2, sp 2)
    and dp 4 on the same weights and batch."""
    ranks = runs[1]
    np.testing.assert_allclose(ranks[0]["dp2_sp2_ring"]["loss"],
                               ranks[0]["dp4"]["loss"], rtol=1e-6)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_dtensor_to_a_kernel_wrapper_raises(runs, wrapper):
    """A DTensor on the CPU must not reach a kernel's plain version."""
    assert runs[1][0]["dtensor_to_kernels"][wrapper] == (
        "the port's kernels take plain tensors, not DTensor: call them on "
        "local blocks")
