"""One f32 MoE ``LMTrainer`` step of the port (4 experts, top-2, 2
layers) on gloo ranks at ep 2 (2 ranks) and at (dp 2, ep 2), (ep 2, tp 2),
(fsdp 2, ep 2) and (dp 2, sp 2) (4 ranks), against the unrolled JAX
``LMTrainer`` (``scan_layers=False``: its scanned model drops the sown aux,
ROADMAP queue 3) at the same degrees on the virtual CPU devices, on its
own weights bridged to the port: the loss with the aux loss, the aux
itself, the gradients and the parameters after one AdamW step to 1e-5,
the tolerance of the one-device MoE step (tests/test_torch_moe.py). Also
the aux at dp 2 against the whole batch's on one device (1e-6), and a
checkpoint saved at (ep 2, tp 2) restored at dp 4 and on one device, bit
for bit."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeoperator_tpu.workloads.lm import LMTrainer as JaxLMTrainer
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu_torch.bridge import params_from_jax
from kubeoperator_tpu_torch.workloads import checkpoint
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads.checkpoint import WorkloadCheckpointer
from kubeoperator_tpu_torch.workloads.moe import MoEMlp
from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
from test_torch_bridge import JAX_TINY, port_cfg, tokens
from test_torch_checkpoint_mesh import assert_same
from torch_dist_cases import MOE_MESHES, spawn_group

torch.set_num_threads(2)

JCFG = dataclasses.replace(JAX_TINY, moe_experts=4, scan_layers=False)
TOL = {"atol": 1e-5, "rtol": 1e-5}


def jax_step(spec: JMeshSpec, toks: np.ndarray) -> dict:
    """The JAX trainer's init, loss with aux, aux, gradients and AdamW
    step at ``spec``."""
    jt = JaxLMTrainer(JCFG, spec, devices=jax.devices()[:spec.n_devices])
    state = jt.init_state(jax.random.key(11))
    params = jax.tree.map(np.asarray, state["params"])

    def loss_fn(p):
        logits, inter = jt.model.apply({"params": p}, jnp.asarray(toks),
                                       mutable=["intermediates"])
        aux = sum(jnp.sum(jnp.stack(v)) for v in jax.tree.leaves(
            inter["intermediates"], is_leaf=lambda v: isinstance(v, tuple)))
        t = toks.shape[1]
        mask = (jnp.arange(t) < t - 1).astype(jnp.float32)[None, :]
        losses = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(jnp.asarray(toks), -1, axis=1))
        return (losses * mask).sum() / mask.sum() + aux, aux

    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state["params"])
    new_state, metrics = jt.train_step(state, jnp.asarray(toks))
    return {"params": params, "loss": float(metrics["loss"]),
            "aux": float(aux), "grads": jax.tree.map(np.asarray, grads),
            "new": jax.tree.map(np.asarray, new_state["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    toks = tokens(4, 32, JCFG.vocab_size, seed=9)
    jax_runs = {name: jax_step(JMeshSpec(**d), toks)
                for name, d in MOE_MESHES.items()}
    workdir = tmp_path_factory.mktemp("moe")
    inputs = {"cfg": port_cfg(JCFG), "workdir": str(workdir),
              "params": {name: params_from_jax(r["params"], JCFG)
                         for name, r in jax_runs.items()},
              "tokens": torch.as_tensor(toks, dtype=torch.long)}
    inputs["params"]["moe"] = inputs["params"]["ep2"]
    ranks = {}
    for world in (2, 4):
        out = spawn_group(f"moe{world}", world,
                          tmp_path_factory.mktemp(f"moe{world}"), inputs)
        for name in out[0]:
            ranks[name] = [r[name] for r in out]
    return jax_runs, ranks, inputs


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_loss_with_aux_matches_jax(runs, name):
    jax_runs, ranks, _ = runs
    losses = [r["loss"] for r in ranks[name]]
    assert losses == [losses[0]] * len(losses)   # the global loss everywhere
    np.testing.assert_allclose(losses[0], jax_runs[name]["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_aux_is_the_global_batch_s(runs, name):
    jax_runs, ranks, _ = runs
    for r in ranks[name]:
        np.testing.assert_allclose(r["aux"], jax_runs[name]["aux"], **TOL)
    assert ranks[name][0]["aux"] > 0


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_gradients_match_jax(runs, name):
    jax_runs, ranks, _ = runs
    want = params_from_jax(jax_runs[name]["grads"], JCFG)
    for r in ranks[name]:
        got = r["grads"]
        assert set(got) == set(want)
        assert any(".moe.router" in k for k in got)
        for key, g in got.items():
            torch.testing.assert_close(g, want[key], **TOL,
                                       msg=lambda m: f"{key}: {m}")


def optax_step(params: dict, grads: dict) -> dict:
    """optax.adamw(3e-4, weight_decay=0.01), the JAX trainer's optimizer,
    one step from ``params`` on ``grads`` ({name: tensor})."""
    tx = optax.adamw(3e-4, weight_decay=0.01)
    p = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    g = {k: jnp.asarray(grads[k].numpy()) for k in params}
    updates, _ = tx.update(g, tx.init(p), p)
    return {k: torch.from_numpy(np.array(v))
            for k, v in optax.apply_updates(p, updates).items()}


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_adamw_step_matches_jax(runs, name):
    """The parameters after the step: optax's AdamW on the port's own
    gradients everywhere, and the JAX trainer's parameters wherever its
    gradient is at least 1e-6, all to 1e-5. The first AdamW step moves a
    parameter by lr·g/(|g| + 1e-8), whose slope at g = 0 is lr/1e-8 =
    3e4: a gradient element of ~1e-8, which the gradients' tolerance
    (1e-5) does not resolve, moves by up to lr = 3e-4 under another
    summation order, on either side."""
    jax_runs, ranks, inputs = runs
    want = params_from_jax(jax_runs[name]["new"], JCFG)
    jgrads = params_from_jax(jax_runs[name]["grads"], JCFG)
    start = inputs["params"][name]
    for r in ranks[name]:                     # every rank holds the same model
        mine = optax_step(start, r["grads"])
        for key, p in r["params"].items():
            torch.testing.assert_close(p, mine[key], **TOL,
                                       msg=lambda m: f"{key}: {m}")
            sure = jgrads[key].abs() >= 1e-6
            torch.testing.assert_close(p[sure], want[key][sure], **TOL,
                                       msg=lambda m: f"{key}: {m}")


def test_aux_at_dp2_is_the_whole_batch_s(runs):
    """Each dp rank sees half the batch, yet every rank's aux is the one
    of the whole batch on one device (1e-6), and the ranks' loss shares
    sum to the one-device objective."""
    _, ranks, inputs = runs
    lt = tlm.LMTrainer(inputs["cfg"], device="cpu")
    model = lt.init_state(params=inputs["params"]["moe"])["model"]
    with torch.no_grad():
        loss, aux = lt.objective(model, inputs["tokens"])
    for r in ranks["aux_dp2"]:
        np.testing.assert_allclose(r["aux"], float(aux), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(sum(r["share"] for r in ranks["aux_dp2"]),
                               float(loss), rtol=1e-6)


def test_ep_checkpoint_restores_at_dp4_bit_for_bit(runs):
    _, ranks, inputs = runs
    want = torch.load(f"{inputs['workdir']}/moe_ckpt/step_1.pt",
                      weights_only=True)
    assert want["step"] == 1 and want["format"] == checkpoint.FORMAT
    assert want["model"]["layers.0.moe.w_gate"].shape == (4, 64, 128)
    for saved_state in ranks["save_ep2_tp2"]:
        assert_same(saved_state, want)
    for r in ranks["restore_dp4"]:
        assert_same(r, want)


def test_ep_checkpoint_restores_on_one_device_bit_for_bit(runs):
    _, _, inputs = runs
    want = torch.load(f"{inputs['workdir']}/moe_ckpt/step_1.pt",
                      weights_only=True)
    trainer = tlm.LMTrainer(inputs["cfg"], device="cpu")
    state = WorkloadCheckpointer(f"{inputs['workdir']}/moe_ckpt").restore(
        trainer.init_state(seed=3))
    assert_same(checkpoint.layout_free(state["step"], state, {}, None), want)


@pytest.mark.parametrize("mesh", ["dp2_ep2", "ep2_tp2"])
def test_llm_job_with_experts_over_the_mesh(runs, mesh, capsys):
    """``llm --experts 4 --mesh dp:2,ep:2`` and ``ep:2,tp:2`` on 4 ranks:
    the one-device job's losses (the records round to 4 places), only
    rank 0 printing."""
    from kubeoperator_tpu_torch.train import jobs
    from torch_dist_cases import LLM_TINY

    _, ranks, _ = runs
    assert jobs.main(["llm", *LLM_TINY, "--experts", "4"]) == 0
    one = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    got = ranks[f"job_{mesh}"]
    assert all(r["rc"] == 0 for r in got)
    assert all(r["records"] == [] for r in got[1:])
    losses = [[r["loss"] for r in run if "loss" in r and "step" in r]
              for run in (got[0]["records"], one)]
    np.testing.assert_allclose(losses[0], losses[1], atol=1.5e-4)
    done = got[0]["records"][-1]
    assert done["chips"] == 4 and done["mesh"]["ep"] == 2


def test_experts_must_split_evenly_over_ep():
    with pytest.raises(ValueError, match=r"moe_experts \(4\) must be "
                                         r"divisible by ep \(3\)"):
        MoEMlp(16, 32, 4, mesh=_FakeMesh(ep=3))


class _FakeMesh:
    """A mesh object with only the ep axis, enough for the layer's
    bookkeeping (no process group is touched for a refusal)."""

    def __init__(self, ep: int):
        self.mesh_dim_names = ("ep",)
        self._ep = ep

    def size(self, dim: int) -> int:
        return self._ep

    def get_local_rank(self, axis: str) -> int:
        return 0

    def get_group(self, axis: str):
        return object()


def test_mesh_spec_sizes_match_the_reference():
    for d in MOE_MESHES.values():
        assert MeshSpec(**d).sizes() == JMeshSpec(**d).sizes()
