"""Speculative decoding on the port's slot pool (``spec_k``,
``draft_layers``) on the CPU at a tiny f32 size, against the JAX
package's engine running the same script and the port's own solo
``generate()`` and non-speculative engine: the K-token lookahead in
``pages_for`` and its release, the reference's validation errors, greedy
mixed shapes (tokens and the draft/accept counters), mid-flight admission
with a sampled row, prefix hits (full, cover, partial) under
speculation, the stale-mirror refusal, and the ``ContinuousBatcher``
feeding ``ko_serve_spec_*``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import decode_loop as jdl
from kubeoperator_tpu_torch.workloads import decode_loop as tdl
from kubeoperator_tpu_torch.workloads import serving as tserving
from test_torch_bridge import jax_params, port_model
from test_torch_decode_loop import (  # noqa: F401 (model, params: fixtures)
    CFG, JCFG, MIXED, drain, engine, jax_engine, model, params, solo,
)
from test_torch_prefix_cache import PRE, page_accounting_exact

torch.set_num_threads(2)

SPEC = dict(spec_k=3, draft_layers=1)


def spec_drain(eng, lasts):
    """Rounds until every row in ``lasts`` reached its last index; the
    positions come from ``poll_spec`` after each round (the advance
    depends on the data)."""
    for _ in range(300):
        eng.run_segment()
        pos, _d, _a = eng.poll_spec()
        if all(pos[s] >= last for s, last in lasts.items()):
            break
    buf, _ = eng.poll()
    return np.asarray(buf)


def test_pages_for_reserves_the_lookahead(model):
    """test_continuous.py::test_spec_pages_reserve_speculative_lookahead:
    (12, 4) at page 8 is 2 pages plainly, 6 under spec_k 4 (extent 16 +
    4 lookahead -> 3 pages, mirrored for the draft); admission takes
    exactly that; the boundary-crossing row equals solo; release restores
    free plus evictable and points the draft table back at trash."""
    assert engine(model, slots=2, segment=2, page=8).pages_for(12, 4) == 2
    eng = engine(model, slots=2, segment=2, page=8, spec_k=4,
                 draft_layers=1)
    assert eng.pages_for(12, 4) == 6
    assert eng.pages_for(20, 4) == 2 * 3          # clamped at the context
    free0 = eng.free_pages()
    eng.admit([(0, PRE[:12], 4, 0.0, 0)])
    assert free0 - eng.free_pages() == eng.pages_for(12, 4)
    assert len(set(eng._dbt_np[0, :3]) & set(eng._bt_np[0, :3])) == 0
    buf = spec_drain(eng, {0: 15})
    assert buf[0][:16].tolist() == solo(model, PRE[:12], 4)
    eng.release([0])
    assert eng.free_pages() + eng.evictable_pages() == free0
    assert (eng._dbt_np[0] == eng._shards[0].trash).all()
    assert torch.equal(eng._dbt.cpu(), torch.as_tensor(eng._dbt_np))
    page_accounting_exact(eng)


@pytest.fixture(scope="module")
def moe_pair():
    jcfg = dataclasses.replace(JCFG, moe_experts=4)
    p = jax_params(jcfg, seed=11)
    return jcfg, p, port_model(jcfg, p)


@pytest.mark.parametrize("kw", [
    dict(spec_k=2), dict(spec_k=2, draft_layers=2), dict(draft_layers=1),
    dict(spec_k=2, draft_layers=1, moe=True)],
    ids=["no-draft", "draft-is-all", "draft-without-k", "moe"])
def test_spec_validation(model, params, moe_pair, kw):
    """The reference's ValueErrors, word for word: a draft must be a
    strict non-empty prefix, a draft needs spec_k, and MoE is served
    without speculation."""
    kw = dict(kw)
    if kw.pop("moe", False):
        jcfg, p, m = moe_pair
        with pytest.raises(ValueError) as want:
            jdl.SlotPoolEngine(jcfg, jax.tree.map(jnp.asarray, p),
                               compile_cache=None, **kw)
        with pytest.raises(ValueError, match="MoE") as got:
            tdl.SlotPoolEngine(dataclasses.replace(CFG, moe_experts=4), m,
                               device="cpu", **kw)
    else:
        with pytest.raises(ValueError) as want:
            jax_engine(params, **kw)
        with pytest.raises(ValueError) as got:
            engine(model, **kw)
    assert str(got.value) == str(want.value)


def mixed_spec(eng):
    eng.admit([(s, p, mt, 0.0, 0) for s, (p, mt) in MIXED.items()])
    buf = spec_drain(eng, {s: len(p) + mt - 1 for s, (p, mt) in MIXED.items()})
    return {s: buf[s][:len(p) + mt].tolist() for s, (p, mt) in MIXED.items()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_greedy_mixed_shapes_match_solo_and_jax(model, params, kv_dtype):
    """Greedy rows under speculation are the JAX engine's, and so are the
    draft and accept counts (rows sit at different frontiers every round
    and rewind on their own); with model-dtype pages they are solo
    generate()'s too. On int8 pages the draft is seeded with raw codes
    and scales."""
    eng = engine(model, slots=4, segment=2, pages=28, kv_dtype=kv_dtype,
                 **SPEC)
    jeng = jax_engine(params, slots=4, segment=2, pages=28,
                      kv_dtype=kv_dtype, **SPEC)
    got, want = mixed_spec(eng), mixed_spec(jeng)
    assert got == want
    for s, (prompt, mt) in MIXED.items():
        if kv_dtype == "bf16":
            assert got[s] == solo(model, prompt, mt), f"slot {s}"
    assert (eng.spec_draft_tokens, eng.spec_accepted_tokens) == (
        jeng.spec_draft_tokens, jeng.spec_accepted_tokens)
    assert 0 < eng.spec_accepted_tokens <= eng.spec_draft_tokens


def test_mid_flight_admission_and_sampling(model, params):
    """A newcomer admitted mid-flight and the row in flight stay their
    solo selves, and the sampled row equals the port's non-speculative
    engine's stream exactly: a round draws its K noise vectors once and
    both phases pick with them."""
    eng = engine(model, slots=4, segment=2, pages=28, **SPEC)
    eng.admit([(0, [5, 6, 7, 8, 9, 10], 10, 0.0, 0),
               (1, [2, 4, 6, 8], 8, 0.7, 123)])
    eng.run_segment()
    eng.poll_spec()
    eng.admit([(2, [11, 12, 13], 8, 0.0, 0)])
    buf = spec_drain(eng, {0: 15, 1: 11, 2: 10})
    assert buf[0][:16].tolist() == solo(model, [5, 6, 7, 8, 9, 10], 10)
    assert buf[2][:11].tolist() == solo(model, [11, 12, 13], 8)
    ref = engine(model, slots=4, segment=2)
    ref.admit([(1, [2, 4, 6, 8], 8, 0.7, 123)])
    rbuf = drain(ref, {1: (4, 11)})
    assert buf[1][:12].tolist() == rbuf[1][:12].tolist()
    # greedy rows of the same script on the JAX engine
    jeng = jax_engine(params, slots=4, segment=2, pages=28, **SPEC)
    jeng.admit([(0, [5, 6, 7, 8, 9, 10], 10, 0.0, 0)])
    jeng.run_segment()
    jeng.poll_spec()
    jeng.admit([(2, [11, 12, 13], 8, 0.0, 0)])
    jbuf = spec_drain(jeng, {0: 15, 2: 10})
    assert jbuf[0][:16].tolist() == buf[0][:16].tolist()
    assert jbuf[2][:11].tolist() == buf[2][:11].tolist()


def prefix_script(eng):
    """PRE[:8] decoded and released (its two pages cached), then one wave
    of a full hit (the same prompt), a cover hit (2 more tokens) and a
    partial hit (9 more: bucket 16 over a hit of 8)."""
    eng.admit([(0, PRE[:8], 4, 0.0, 0)])
    spec_drain(eng, {0: 11})
    eng.release([0])
    wave = {0: (PRE[:8], 6), 1: (PRE[:8] + [20, 21], 5),
            2: (PRE[:8] + [30, 31, 32, 33, 34, 35, 36, 37, 38], 5)}
    eng.admit([(s, p, mt, 0.0, 0) for s, (p, mt) in wave.items()])
    kinds = {s: eng.last_plans[s]["hit_kind"] for s in wave}
    buf = spec_drain(eng, {s: len(p) + mt - 1 for s, (p, mt) in wave.items()})
    rows = {s: buf[s][:len(p) + mt].tolist() for s, (p, mt) in wave.items()}
    return wave, kinds, rows


def test_prefix_hits_under_speculation(model, params):
    """Full, cover and partial hits on a speculative engine equal solo
    generate() and the JAX engine's rows, with its hit and copy-on-write
    counters; the draft pages are seeded from the target's, never
    shared."""
    eng = engine(model, slots=3, segment=2, page=4, pages=64, spec_k=2,
                 draft_layers=1)
    jeng = jax_engine(params, slots=3, segment=2, page=4, pages=64, spec_k=2,
                      draft_layers=1)
    wave, kinds, rows = prefix_script(eng)
    _, jkinds, jrows = prefix_script(jeng)
    assert kinds == jkinds == {0: "full", 1: "cover", 2: "partial"}
    assert rows == jrows
    for s, (prompt, mt) in wave.items():
        assert rows[s] == solo(model, prompt, mt), f"slot {s}"
    for name in ("prefix_hits", "prefix_pages_reused", "cow_copies",
                 "spec_draft_tokens", "spec_accepted_tokens"):
        assert getattr(eng, name) == getattr(jeng, name), name
    cached = {pg for _t, pgs in eng._shards[0].prefix.values() for pg in pgs}
    assert not cached & set(eng._dbt_np.ravel()) - {eng._shards[0].trash}
    page_accounting_exact(eng)


def test_stale_mirror_raises_before_the_round(model):
    """The sampled draws are keyed by positions only ``poll_spec`` knows
    after a round: a second round without it raises before any device
    work while a sampled row is live. Greedy-only pools may run rounds
    back to back; ``poll_spec`` then sums their counts."""
    eng = engine(model, slots=2, segment=2, **SPEC)
    eng.admit([(0, [2, 4, 6, 8], 8, 0.7, 123)])
    eng.run_segment()
    buf_before = eng._buf.clone()
    with pytest.raises(RuntimeError, match="poll_spec"):
        eng.run_segment()
    assert torch.equal(eng._buf, buf_before)
    eng.poll_spec()
    eng.run_segment()                      # refreshed: runs

    greedy = engine(model, slots=2, segment=2, **SPEC)
    # a 6-token prompt starts at 4: position 5 is the prompt's own token,
    # which draft and target both emit, so the first round accepts it
    greedy.admit([(0, [1, 2, 3, 4, 5, 6], 12, 0.0, 0)])
    greedy.run_segment()
    greedy.run_segment()
    _, drafted, accepted = greedy.poll_spec()
    assert drafted == 2 * 3 and 0 < accepted <= drafted
    assert (greedy.spec_draft_tokens, greedy.spec_accepted_tokens) == (
        drafted, accepted)


def test_continuous_batcher_over_a_spec_engine(model):
    """The batcher mirrors the true positions through poll_spec after
    every dispatch: greedy and sampled replies equal the non-speculative
    ones, TTFT stamps, and the spec counters reach ``BatcherStats`` and
    the Prometheus text ``/metrics`` serves."""
    eng = engine(model, slots=2, segment=2, **SPEC)
    cb = tserving.ContinuousBatcher(eng)
    out = cb.submit([1, 2, 3, 4, 5, 6], 6, timeout=120.0)
    assert out == solo(model, [1, 2, 3, 4, 5, 6], 6)
    sampled = cb.submit([2, 4, 6, 8], 8, temperature=0.7, seed=123,
                        timeout=120.0)
    ref = tserving.ContinuousBatcher(engine(model, slots=2, segment=2))
    assert sampled == ref.submit([2, 4, 6, 8], 8, temperature=0.7, seed=123,
                                 timeout=120.0)
    s = cb.stats.snapshot()
    assert s["spec_draft_tokens_total"] == eng.spec_draft_tokens > 0
    assert 0 < s["spec_accepted_tokens_total"] == eng.spec_accepted_tokens
    assert s["spec_acceptance_ratio"] == round(
        eng.spec_accepted_tokens / eng.spec_draft_tokens, 4)
    assert s["requests_total"] == 2 and s["errors_total"] == 0
    assert s["ttft_count"] == 2
    prom = cb.stats.prometheus()
    assert (f"ko_serve_spec_draft_tokens_total "
            f"{eng.spec_draft_tokens}") in prom
    assert "ko_serve_spec_acceptance_ratio" in prom
