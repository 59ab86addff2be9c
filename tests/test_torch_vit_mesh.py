"""One f32 ``ViTTrainer`` step of the port on gloo ranks at dp 2, fsdp 2,
tp 2 and sp 2 (2 ranks) and at (fsdp 2, tp 2) (4 ranks), against the JAX
``ViTTrainer`` at the same degrees on as many virtual CPU devices, on its
own weights bridged to the port: the loss, the gradients and the
parameters after one AdamW step at 1e-5, the tolerance of the one-device
step (tests/test_torch_vit.py). The reference's ViT attends over the whole
sequence, so its sp ranks compute the step alike, and so do the port's.
A pipeline axis raises: the ViT has no stages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeoperator_tpu.workloads import vit as jvit
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu_torch.bridge import vit_params_from_jax
from test_torch_vit import TINY, images, vit_port_cfg
from torch_dist_cases import VIT_MESHES, spawn_group

torch.set_num_threads(2)

JCFG = dataclasses.replace(TINY, encoder=dataclasses.replace(
    TINY.encoder, attention="dense"))
BATCH = 4


def jax_step(name: str, x: np.ndarray, y: np.ndarray) -> dict:
    spec = JMeshSpec(**VIT_MESHES[name])
    jt = jvit.ViTTrainer(JCFG, spec, devices=jax.devices()[:spec.n_devices])
    state = jt.init_state(jax.random.key(7))
    params = jax.tree.map(np.asarray, state["params"])

    def loss_fn(p):
        logits = jt.model.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(
        state["params"]))
    new_state, metrics = jt.train_step(state, jnp.asarray(x), jnp.asarray(y))
    return {"params": params, "loss": float(metrics["loss"]),
            "grads": grads,
            "new": jax.tree.map(np.asarray, new_state["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x = images(BATCH, seed=3)
    y = np.array([1, 4, 7, 2], np.int32)
    jax_runs = {name: jax_step(name, x, y) for name in VIT_MESHES}
    inputs = {"cfg": vit_port_cfg(JCFG),
              "params": {name: vit_params_from_jax(r["params"], JCFG)
                         for name, r in jax_runs.items()},
              "x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    ranks = {}
    for world in (2, 4):
        out = spawn_group(f"vit{world}", world,
                          tmp_path_factory.mktemp(f"vit{world}"), inputs)
        for name in out[0]:
            ranks[name] = [r[name] for r in out]
    return jax_runs, ranks


@pytest.mark.parametrize("name", list(VIT_MESHES))
def test_loss_matches_jax(runs, name):
    jax_runs, ranks = runs
    losses = [r["loss"] for r in ranks[name]]
    assert losses == [losses[0]] * len(losses)   # the global loss everywhere
    np.testing.assert_allclose(losses[0], jax_runs[name]["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", list(VIT_MESHES))
def test_gradients_match_jax(runs, name):
    jax_runs, ranks = runs
    want = vit_params_from_jax(jax_runs[name]["grads"], JCFG)
    got = ranks[name][0]["grads"]
    assert set(got) == set(want)
    for key, g in got.items():
        torch.testing.assert_close(g, want[key], atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{key}: {m}")


@pytest.mark.parametrize("name", list(VIT_MESHES))
def test_adamw_step_matches_jax(runs, name):
    jax_runs, ranks = runs
    want = vit_params_from_jax(jax_runs[name]["new"], JCFG)
    for r in ranks[name]:                     # every rank holds the same model
        for key, p in r["params"].items():
            torch.testing.assert_close(p, want[key], atol=1e-5, rtol=1e-5,
                                       msg=lambda m: f"{key}: {m}")


def test_a_pipeline_axis_is_refused(runs):
    for r in runs[1]["pp_refused"]:
        assert r["error"].startswith("mesh axis pp=2: the ViT has no "
                                     "experts and no pipeline stages")
