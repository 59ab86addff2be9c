"""The port's MoE (``workloads/moe.py`` and what serves it) against the JAX
package on the CPU, f32: ``MoEMlp`` on bridged params (output, aux, the
decode form's load, routing and the dropped set with a non-binding and a
binding capacity, grads of all four weights), one MoE ``LMTrainer`` step
with remat off and on, greedy MoE ``generate()``, and the MoE slot pool
(tokens against the port's solo ``generate()`` and the JAX engine,
``expert_load()`` exactly the JAX engine's) behind the port's
``ContinuousBatcher``."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from kubeoperator_tpu.workloads import decode_loop as jdl
from kubeoperator_tpu.workloads.generate import generate as jax_generate
from kubeoperator_tpu.workloads.lm import LMTrainer as JaxLMTrainer
from kubeoperator_tpu.workloads.moe import MoEMlp as JaxMoEMlp
from kubeoperator_tpu.workloads.transformer import TransformerConfig
from kubeoperator_tpu_torch.bridge import params_from_jax
from kubeoperator_tpu_torch.workloads import decode_loop as tdl
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads import serving as tserving
from kubeoperator_tpu_torch.workloads.generate import generate
from kubeoperator_tpu_torch.workloads.moe import MoEMlp
from test_torch_bridge import JAX_TINY, jax_params, port_cfg, port_model, tokens

torch.set_num_threads(2)

E, D, FF = 4, 16, 32
TOL = {"atol": 1e-5, "rtol": 1e-5}

# tests/test_continuous.py's MOE_CFG and its init key
JCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq_len=24, dtype=jnp.float32,
                         remat=False, attention="dense", moe_experts=4,
                         moe_top_k=2)
CFG = port_cfg(JCFG)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def layer_pair(cf: float, seed: int = 0):
    """JAX ``MoEMlp`` params from a seed, the port's layer loaded with
    them, and an input [2, 12, D]."""
    jm = JaxMoEMlp(D, FF, E, capacity_factor=cf, dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 12, D)).astype(
        np.float32)
    p = jax.tree.map(np.array, nn.unbox(
        jm.init(jax.random.key(seed + 1), jnp.asarray(x))["params"]))
    m = MoEMlp(D, FF, E, capacity_factor=cf, dtype=torch.float32)
    m.load_state_dict({"router": torch.as_tensor(p["router"]["kernel"]),
                       **{k: torch.as_tensor(p[k])
                          for k in ("w_gate", "w_up", "w_down")}})
    return jm, p, m, x


def jax_apply(jm, p, x):
    y, inter = jm.apply({"params": p}, jnp.asarray(x),
                        mutable=["intermediates"])
    return y, inter["intermediates"]["moe_aux"][0]


def gshard_kept(gate_idx: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """moe.py:58-69's cumulative-priority rule in numpy: kept[b, t, k] is
    whether the token's k-th choice got a capacity slot of its expert."""
    b, t, k_top = gate_idx.shape
    kept = np.zeros((b, t, k_top), bool)
    for row in range(b):
        depth = np.zeros(n_experts, int)
        for k in range(k_top):
            for tok in range(t):
                e = gate_idx[row, tok, k]
                kept[row, tok, k] = depth[e] < cap
                depth[e] += 1
    return kept


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["roomy", "binding"])
def test_layer_matches_jax(cf):
    """Output and aux within 1e-5; the router's top-k equal to JAX's
    ``lax.top_k``; the kept assignments equal to the GShard rule on JAX's
    choices (at cf 0.5 tokens drop, at cf 8 none does)."""
    jm, p, m, x = layer_pair(cf)
    y, aux = jax_apply(jm, p, x)
    got_y, got_aux = m(torch.as_tensor(x))
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(got_aux.detach()), float(aux), **TOL)

    _, inter = jm.apply({"params": p}, jnp.asarray(x),
                        capture_intermediates=True)
    logits = inter["intermediates"]["router"]["__call__"][0]
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    _, gate_idx, _, dispatch = m.route(torch.as_tensor(x))
    np.testing.assert_array_equal(gate_idx.numpy(), np.asarray(jidx))

    cap = m.capacity(x.shape[1])
    want = gshard_kept(np.asarray(jidx), E, cap)
    per_expert = dispatch.sum(-1).numpy() > 0                 # [B, T, E]
    got = np.take_along_axis(per_expert, gate_idx.numpy(), axis=-1)
    np.testing.assert_array_equal(got, want)
    assert want.all() if cf == 8.0 else not want.all()


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["roomy", "binding"])
def test_serve_form_matches_jax_engine_tail(cf):
    """The decode form (``serve``) gives the JAX engine's ``_moe_tail``
    output and per-expert load."""
    _, p, m, x = layer_pair(cf, seed=3)
    eng = types.SimpleNamespace(_decode_cfg=types.SimpleNamespace(
        moe_experts=E, moe_top_k=2, moe_capacity_factor=cf,
        dtype=jnp.float32))
    y, load = jdl.SlotPoolEngine._moe_tail(eng, jax.tree.map(jnp.asarray, p),
                                           jnp.asarray(x))
    with torch.no_grad():
        got_y, got_load = m.serve(torch.as_tensor(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **TOL)
    np.testing.assert_array_equal(got_load.numpy(), np.asarray(load))


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["roomy", "binding"])
def test_layer_grads_match_jax(cf):
    """Grads of sum(y · r) + aux for the router and the three expert
    stacks within 1e-5 of jax.grad's."""
    jm, p, m, x = layer_pair(cf, seed=5)
    r = np.random.default_rng(6).standard_normal((2, 12, D)).astype(
        np.float32)

    def f(params):
        y, aux = jax_apply(jm, params, x)
        return jnp.sum(y * r) + aux

    jg = jax.grad(f)(jax.tree.map(jnp.asarray, p))
    y, aux = m(torch.as_tensor(x))
    (torch.sum(y * torch.as_tensor(r)) + aux).backward()
    np.testing.assert_allclose(m.router.grad.numpy(),
                               np.asarray(jg["router"]["kernel"]), **TOL)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(m, name).grad.numpy(),
                                   np.asarray(jg[name]), **TOL,
                                   err_msg=name)
    assert float(m.router.grad.abs().max()) > 0


def test_capacity_is_the_reference_s():
    m = MoEMlp(D, FF, 8)
    assert [m.capacity(t) for t in (1, 4, 16, 2048)] == [
        max(1, int(1.25 * 2 * t / 8)) for t in (1, 4, 16, 2048)]
    assert m.capacity(1) == 1


# ---------------------------------------------------------------------------
# MoE LM training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["noremat", "remat"])
def step_pair(request):
    """One MoE LMTrainer step (4 experts, top-2) on both sides from the
    JAX trainer's init; the JAX grads of its own loss, aux included. The
    JAX model is unrolled (``scan_layers=False``): its ``nn.scan`` drops
    the sown aux (``test_scanned_reference_drops_the_aux``)."""
    jcfg = dataclasses.replace(JAX_TINY, remat=request.param, moe_experts=4,
                               scan_layers=False)
    toks = tokens(2, 32, jcfg.vocab_size, seed=9)
    jt = JaxLMTrainer(jcfg, devices=jax.devices()[:1])
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

    (jloss_fn, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        state["params"])
    jgrads = jax.tree.map(np.asarray, jgrads)
    new_state, metrics = jt.train_step(state, jnp.asarray(toks))
    jnew = jax.tree.map(np.asarray, new_state["params"])

    pt = tlm.LMTrainer(port_cfg(jcfg), device="cpu")
    pstate = pt.init_state(params=params_from_jax(params, jcfg))
    model = pstate["model"]
    ptoks = torch.as_tensor(toks, dtype=torch.long)
    pt.loss(model, ptoks).backward()
    pgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    pstate, pmetrics = pt.train_step(pstate, ptoks)
    return dict(jcfg=jcfg, jloss=float(metrics["loss"]),
                jloss_fn=float(jloss_fn), jaux=float(jaux), jgrads=jgrads,
                jnew=jnew, ploss=float(pmetrics["loss"]),
                paux=float(pmetrics["aux"]), pgrads=pgrads,
                pnew=model.state_dict())


def test_moe_loss_with_aux_matches_jax(step_pair):
    np.testing.assert_allclose(step_pair["ploss"], step_pair["jloss"],
                               rtol=1e-5)
    np.testing.assert_allclose(step_pair["jloss_fn"], step_pair["jloss"],
                               rtol=1e-6)
    np.testing.assert_allclose(step_pair["paux"], step_pair["jaux"], **TOL)
    assert step_pair["paux"] > 0


def test_moe_grads_match_jax(step_pair):
    """Every param's grad within 1e-5, the router's included: the aux
    reaches them through the checkpointed blocks too."""
    want = params_from_jax(step_pair["jgrads"], step_pair["jcfg"])
    assert any(".moe.router" in n for n in step_pair["pgrads"])
    for name, g in step_pair["pgrads"].items():
        torch.testing.assert_close(g, want[name], **TOL,
                                   msg=lambda m: f"{name}: {m}")


def test_moe_adamw_step_matches_optax(step_pair):
    want = params_from_jax(step_pair["jnew"], step_pair["jcfg"])
    for name, p in step_pair["pnew"].items():
        torch.testing.assert_close(p, want[name], **TOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
def test_aux_reaches_the_router_grad(remat):
    """The router's grad of the trainer's loss is that of the next-token
    loss plus that of the aux, with and without checkpointing: the aux
    leaves the blocks and joins the objective."""
    cfg = dataclasses.replace(port_cfg(JAX_TINY), moe_experts=4, remat=remat)
    pt = tlm.LMTrainer(cfg, device="cpu")
    model = pt.init_state(seed=2)["model"]
    toks = torch.as_tensor(tokens(2, 16, cfg.vocab_size, seed=3),
                           dtype=torch.long)
    router = [blk.moe.router for blk in model.layers]

    def grads(part):
        logits, aux = model(toks, return_aux=True)
        loss = {"lm": tlm.lm_loss(logits, toks), "aux": aux,
                "all": pt.loss(model, toks)}[part]
        return torch.autograd.grad(loss, router)

    lm, aux, both = grads("lm"), grads("aux"), grads("all")
    for g_lm, g_aux, g in zip(lm, aux, both):
        assert float(g_aux.abs().max()) > 0
        torch.testing.assert_close(g, g_lm + g_aux, atol=1e-6, rtol=1e-5)


def test_scanned_reference_drops_the_aux():
    """A divergence the port does not copy (ROADMAP queue 3): the JAX
    model's ``nn.scan`` carries only the params and cache collections, so
    with ``scan_layers=True`` (its default) the sown aux never reaches
    lm.py's sum and the reference trains on the next-token loss alone.
    The port adds the aux in every layout: its loss is the JAX trainer's
    plus the port's aux."""
    jcfg = dataclasses.replace(JAX_TINY, moe_experts=4)
    assert jcfg.scan_layers
    toks = tokens(2, 32, jcfg.vocab_size, seed=9)
    jt = JaxLMTrainer(jcfg, devices=jax.devices()[:1])
    state = jt.init_state(jax.random.key(11))
    params = jax.tree.map(np.asarray, state["params"])
    _, inter = jt.model.apply({"params": state["params"]}, jnp.asarray(toks),
                              mutable=["intermediates"])
    assert "intermediates" not in inter
    _, metrics = jt.train_step(state, jnp.asarray(toks))
    pt = tlm.LMTrainer(port_cfg(jcfg), device="cpu")
    model = pt.init_state(params=params_from_jax(params, jcfg))["model"]
    with torch.no_grad():
        loss, aux = pt.objective(model, torch.as_tensor(toks,
                                                        dtype=torch.long))
    assert float(aux) > 0
    np.testing.assert_allclose(float(loss) - float(aux),
                               float(metrics["loss"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# decode: generate() and the slot pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return jax_params(JCFG, seed=11)


@pytest.fixture(scope="module")
def model(params):
    return port_model(JCFG, params)


def solo(model, prompt, mt):
    return generate(CFG, model, [prompt], mt, device="cpu")[0].tolist()


@pytest.mark.parametrize("prompt,lens,mt", [
    ([[1, 2, 3, 4, 5, 6, 7, 8]], None, 6),
    ([[9, 10, 11, 12], [40, 3, 3, 17]], None, 8),
    ([[3, 11, 5, 22, 7], [9, 2, 0, 0, 0]], [5, 2], 6)])
def test_greedy_generate_matches_jax(params, model, prompt, lens, mt):
    """Greedy MoE tokens equal the flax token loop's, uniform batches and
    right-padded mixed lengths alike."""
    kw = {} if lens is None else {"prompt_lens": lens}
    want = np.asarray(jax_generate(
        JCFG, jax.tree.map(jnp.asarray, params), jnp.asarray(prompt, jnp.int32),
        mt, **({} if lens is None else
               {"prompt_lens": jnp.asarray(lens, jnp.int32)})))
    got = generate(CFG, model, prompt, mt, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, want)


def drain(eng, track):
    for _ in range(200):
        if all(p >= last for p, last in track.values()):
            break
        eng.run_segment()
        for s, (p, last) in track.items():
            track[s] = (min(p + eng.segment, last), last)
    buf, _ = eng.poll()
    return np.asarray(buf)


def moe_script(eng):
    """test_continuous.py's two MoE pool scripts back to back on one
    engine: two pow2 prompts admitted together, then (after release) one
    admitted alone, a segment, and a second admitted mid-flight. Returns
    (rows, expert_load after each phase)."""
    rows, loads = {}, []
    track = {}
    pos = eng.admit([(0, [1, 2, 3, 4, 5, 6, 7, 8], 6, 0.0, 0),
                     (1, [9, 10, 11, 12], 8, 0.0, 1)])
    loads.append(eng.expert_load().copy())           # prefill not counted
    track = {0: (pos[0], 13), 1: (pos[1], 11)}
    buf = drain(eng, track)
    rows["a0"], rows["a1"] = buf[0][:14].tolist(), buf[1][:12].tolist()
    loads.append(eng.expert_load().copy())
    eng.release([0, 1])
    pos = eng.admit([(0, [5, 6, 7, 8], 8, 0.0, 0)])
    track = {0: (pos[0], 11)}
    eng.run_segment()
    track[0] = (min(track[0][0] + eng.segment, 11), 11)
    pos = eng.admit([(1, [11, 12, 13, 14, 15, 16, 17, 18], 6, 0.0, 0)])
    track[1] = (pos[1], 13)
    buf = drain(eng, track)
    rows["b0"], rows["b1"] = buf[0][:12].tolist(), buf[1][:14].tolist()
    loads.append(eng.expert_load().copy())
    return rows, loads


@pytest.fixture(scope="module")
def jax_script(params):
    eng = jdl.SlotPoolEngine(JCFG, jax.tree.map(jnp.asarray, params),
                             slots=2, segment=2, compile_cache=None)
    return moe_script(eng)


def test_moe_pool_matches_solo_and_jax_engine(model, jax_script):
    """pow2 prompts, one admitted mid-flight: the pool's greedy rows are
    the port's solo generate()'s and the JAX engine's, and its
    expert_load() the JAX engine's exactly after every phase (zeros after
    the first admission: prefill loads are not counted)."""
    eng = tdl.SlotPoolEngine(CFG, model, slots=2, segment=2, device="cpu")
    assert not eng.expert_load().any()
    rows, loads = moe_script(eng)
    want_rows, want_loads = jax_script
    assert rows == want_rows
    assert rows["a0"] == solo(model, [1, 2, 3, 4, 5, 6, 7, 8], 6)
    assert rows["a1"] == solo(model, [9, 10, 11, 12], 8)
    assert rows["b0"] == solo(model, [5, 6, 7, 8], 8)
    assert rows["b1"] == solo(model, [11, 12, 13, 14, 15, 16, 17, 18], 6)
    assert not loads[0].any()
    for got, want in zip(loads, want_loads):
        assert got.dtype == np.float32 and got.shape == (4,)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_expert_load_counts_every_row_of_every_micro_step(model):
    """At one token a step the capacity is 1 and the top-2 experts are
    distinct, so nothing drops: each micro-step adds slots × top_k per
    layer, empty slots included (the dense dispatch routes every row)."""
    eng = tdl.SlotPoolEngine(CFG, model, slots=3, segment=2, device="cpu")
    eng.admit([(0, [4, 5, 6, 7], 9, 0.0, 0)])
    for _ in range(3):
        eng.run_segment()
    assert float(eng.expert_load().sum()) == 3 * 2 * CFG.n_layers * 3 * 2


def test_moe_pool_behind_the_continuous_batcher(model):
    """The batcher fetches the engine's load once per retirement wave into
    ``ko_serve_moe_expert_load``, one sample per expert."""
    eng = tdl.SlotPoolEngine(CFG, model, slots=2, segment=2, device="cpu")
    cb = tserving.ContinuousBatcher(eng)
    out = cb.submit([9, 10, 11, 12], 8, timeout=120.0)
    assert out == solo(model, [9, 10, 11, 12], 8)
    samples = {line.split()[0]: float(line.split()[1])
               for line in cb.stats.prometheus().splitlines()
               if line.startswith("ko_serve_moe_expert_load{")}
    load = eng.expert_load()
    assert samples == {f'ko_serve_moe_expert_load{{expert="{e}"}}':
                       float(load[e]) for e in range(4)}
    assert float(load.sum()) > 0
