"""One LM train step in the port against the JAX LMTrainer on one CPU
device, same params and tokens, f32: the loss to 1e-5 relative, the
gradients against jax.grad of the same loss, and the params after one
AdamW step against optax's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeoperator_tpu.workloads.lm import LMTrainer as JaxLMTrainer
from kubeoperator_tpu_torch.bridge import params_from_jax
from kubeoperator_tpu_torch.workloads import lm as tlm
from test_torch_bridge import JAX_TINY, port_cfg, tokens

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=[False, True], ids=["noremat", "remat"])
def step_pair(request):
    jcfg = dataclasses.replace(JAX_TINY, remat=request.param)
    toks = tokens(2, 32, jcfg.vocab_size, seed=9)
    jt = JaxLMTrainer(jcfg, devices=jax.devices()[:1])
    state = jt.init_state(jax.random.key(11))
    params = jax.tree.map(np.asarray, state["params"])

    def loss_fn(p):
        logits = jt.model.apply({"params": p}, jnp.asarray(toks))
        t = toks.shape[1]
        mask = (jnp.arange(t) < t - 1).astype(jnp.float32)[None, :]
        losses = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(jnp.asarray(toks), -1, axis=1))
        return (losses * mask).sum() / mask.sum()

    jgrads = jax.tree.map(np.asarray, jax.grad(loss_fn)(state["params"]))
    new_state, metrics = jt.train_step(state, jnp.asarray(toks))
    jnew = jax.tree.map(np.asarray, new_state["params"])

    pt = tlm.LMTrainer(port_cfg(jcfg), device="cpu")
    pstate = pt.init_state(params=params_from_jax(params, jcfg))
    model = pstate["model"]
    ptoks = torch.as_tensor(toks, dtype=torch.long)
    ploss = pt.loss(model, ptoks)
    ploss.backward()
    pgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    pstate, pmetrics = pt.train_step(pstate, ptoks)
    return dict(jcfg=jcfg, jloss=float(metrics["loss"]),
                jloss_fn=float(loss_fn(params)), jgrads=jgrads, jnew=jnew,
                ploss=float(pmetrics["loss"]), pgrads=pgrads,
                pnew=model.state_dict(), pstep=pstate["step"])


def test_loss_matches_jax(step_pair):
    np.testing.assert_allclose(step_pair["ploss"], step_pair["jloss"], rtol=1e-5)
    np.testing.assert_allclose(step_pair["jloss_fn"], step_pair["jloss"], rtol=1e-6)


def test_gradients_match_jax(step_pair):
    want = params_from_jax(step_pair["jgrads"], step_pair["jcfg"])
    for name, g in step_pair["pgrads"].items():
        torch.testing.assert_close(g, want[name], atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


def test_adamw_step_matches_optax(step_pair):
    want = params_from_jax(step_pair["jnew"], step_pair["jcfg"])
    for name, p in step_pair["pnew"].items():
        torch.testing.assert_close(p, want[name], atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
    assert step_pair["pstep"] == 1


def test_loss_is_masked_next_token_cross_entropy():
    logits = torch.randn(2, 5, 7)
    toks = torch.randint(0, 7, (2, 5))
    logp = torch.log_softmax(logits, -1)
    want = -sum(logp[b, t, toks[b, t + 1]] for b in range(2) for t in range(4)) / 4
    torch.testing.assert_close(tlm.lm_loss(logits, toks), want)


def test_mesh_beyond_one_device_is_refused():
    with pytest.raises(NotImplementedError, match="multi-device"):
        tlm.LMTrainer(port_cfg(JAX_TINY), spec=tlm.MeshSpec(dp=2), device="cpu")


def test_synthetic_batch_is_seeded_and_in_vocab():
    pt = tlm.LMTrainer(port_cfg(JAX_TINY), device="cpu")
    a, b = pt.synthetic_batch(3, 16, seed=1), pt.synthetic_batch(3, 16, seed=1)
    assert torch.equal(a, b) and a.shape == (3, 16)
    assert int(a.min()) >= 0 and int(a.max()) < JAX_TINY.vocab_size
    assert not torch.equal(a, pt.synthetic_batch(3, 16, seed=2))


def test_seeded_init_is_deterministic_and_flax_shaped():
    pt = tlm.LMTrainer(port_cfg(JAX_TINY), device="cpu")
    a = pt.init_state(seed=3)["model"].state_dict()
    b = pt.init_state(seed=3)["model"].state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    emb = a["embedding"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    q = a["layers.0.attn.q"]
    assert float(q.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(a["ln_f.scale"], torch.ones(64))


def test_measure_needs_the_card():
    pt = tlm.LMTrainer(port_cfg(JAX_TINY), device="cpu")
    with pytest.raises(ValueError, match="no published peak"):
        pt.measure(batch=1, seq_len=8, steps=1, warmup=1, repeats=1)
