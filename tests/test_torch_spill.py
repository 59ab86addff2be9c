"""The port's host spill tier on the CPU at a tiny f32 size, against the
JAX package's engine running the same script: demotion past the host
bound, promotion that itself demotes, copy-on-write on a promoted page, a
release while the prefix also lives host-side, a failed promotion that
restores its entry, and the batcher's admission over a spilling int8
engine. Counters, LRU and spill entries equal the JAX engine's after
every step, tokens equal its and the port's solo ``generate()``, and a
demote→promote round trip is bit-exact."""

import threading

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.workloads import serving as tserving
from test_torch_decode_loop import (  # noqa: F401 (model, params: fixtures)
    drain, engine, jax_engine, model, params, solo,
)
from test_torch_prefix_cache import (
    PRE, PROMPT_B, PROMPT_C, PROMPT_D, page_accounting_exact, same_state,
)

torch.set_num_threads(2)

SPILL = dict(slots=4, segment=4, page=8, pages=9)


def both(model, params, **kw):
    return engine(model, **SPILL, **kw), jax_engine(params, **SPILL, **kw)


def admit(engs, *entries):
    for e in engs:
        e.admit(list(entries))
    same_state(*engs)


def release(engs, *slots):
    for e in engs:
        e.release(list(slots))
    same_state(*engs)


def finish(engs, slot, total):
    """Decode ``slot`` to its end in each engine; its rows, equal."""
    rows = [np.asarray(drain(e, {slot: (0, total - 1)}))[slot][:total]
            for e in engs]
    assert rows[0].tolist() == rows[1].tolist()
    return rows[0].tolist()


def test_spill_demote_then_evict_host(model, params):
    """tests/test_continuous.py::test_spill_demote_then_evict_host: the
    host LRU is bounded, so demoting past it evicts the oldest host
    entry, and a prompt whose prefix was host-evicted is a clean miss."""
    engs = both(model, params, spill_pages=2)
    admit(engs, (0, PRE, 4, 0.0, 0))
    finish(engs, 0, 20)
    release(engs, 0)
    for slot, prompt in ((1, PROMPT_B), (2, PROMPT_C)):
        admit(engs, (slot, prompt, 4, 0.0, 0))
        release(engs, slot)
    admit(engs, (3, PROMPT_D, 4, 0.0, 0))
    eng = engs[0]
    assert eng.demotions == 2 and eng.spill_pages_used() == 2
    assert [n for _t, _p, n in eng._shards[0].spill.values()] == [2]
    release(engs, 3)
    hits0 = eng.prefix_hits
    admit(engs, (0, PRE[:8] + [9, 9, 9], 4, 0.0, 0))
    assert eng.prefix_hits == hits0 and eng.promoted_hits == 0
    assert finish(engs, 0, 15) == solo(model, PRE[:8] + [9, 9, 9], 4)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_spill_promote_while_demoting(model, params, kv):
    """tests/test_continuous.py::test_spill_promote_while_demoting: a
    promotion whose allocation must itself evict and demote other entries
    pops its own entry first, so the demotion cannot evict it."""
    engs = both(model, params, kv_dtype=kv, spill_pages=4)
    admit(engs, (0, PRE, 4, 0.0, 0))
    finish(engs, 0, 20)
    release(engs, 0)
    for slot, prompt in ((1, PROMPT_B), (2, PROMPT_C)):
        admit(engs, (slot, prompt, 4, 0.0, 0))
        release(engs, slot)
    admit(engs, (3, PROMPT_D, 4, 0.0, 0))           # demotes PRE
    eng = engs[0]
    assert eng.demotions == 2 and eng.spill_pages_used() == 3
    admit(engs, (0, PRE + [7, 7], 4, 0.0, 0))
    assert eng.promoted_hits == 1 and eng.demotions == 4
    assert eng.spill_pages_used() == 4
    assert finish(engs, 0, 22) == solo(model, PRE + [7, 7], 4)
    page_accounting_exact(eng)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_spill_cow_on_promoted_page(model, params, kv):
    """tests/test_continuous.py::test_spill_cow_on_promoted_page: a full
    hit on a promoted entry copies its boundary page like any device
    hit; the promoted pages stay as promoted and tokens equal solo."""
    engs = both(model, params, kv_dtype=kv, spill_pages=4)
    admit(engs, (0, PRE, 4, 0.0, 0))
    finish(engs, 0, 20)
    release(engs, 0)
    admit(engs, (1, PROMPT_B[:11], 4, 0.0, 0))
    release(engs, 1)
    admit(engs, (2, PROMPT_C, 4, 0.0, 0))
    release(engs, 2)
    admit(engs, (1, PROMPT_D, 4, 0.0, 0))
    admit(engs, (3, PROMPT_B[:8] + [3, 3, 3], 4, 0.0, 0))   # demotes PRE
    eng = engs[0]
    assert eng.demotions == 2 and eng.spill_pages_used() == 3
    release(engs, 1, 3)
    cow0 = eng.cow_copies
    admit(engs, (0, PRE, 4, 0.0, 0))                # full promoted hit
    assert eng.promoted_hits == 1 and eng.cow_copies == cow0 + 1
    assert eng.last_plans[0]["hit_kind"] == "full"
    pgs = eng._shards[0].prefix[hash(tuple(PRE))][1]
    idx = torch.as_tensor(pgs)
    before = [b[idx].clone() for entry in eng._pools for b in entry]
    assert finish(engs, 0, 20) == solo(model, PRE, 4)
    after = [b[idx] for entry in eng._pools for b in entry]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_spill_release_slot_with_host_side_prefix(model, params):
    """tests/test_continuous.py::test_spill_release_slot_with_host_side_
    prefix: a promotion that cannot fit restores its spill entry and
    raises the engine's error; releasing a slot whose prefix also lives
    host-side returns only its own pages; a full drain returns every
    page."""
    engs = both(model, params, spill_pages=4)
    admit(engs, (0, PRE, 4, 0.0, 0))
    finish(engs, 0, 20)
    release(engs, 0)
    admit(engs, (1, PROMPT_B, 4, 0.0, 0))
    admit(engs, (3, PROMPT_C[:11], 4, 0.0, 0))
    admit(engs, (2, PROMPT_D, 4, 0.0, 0))           # demotes PRE
    eng = engs[0]
    assert eng.demotions == 2 and eng.spill_pages_used() == 3
    for e in engs:
        with pytest.raises(RuntimeError, match="page pool exhausted"):
            e.admit([(0, PRE + [7, 7], 4, 0.0, 0)])
    same_state(*engs)
    assert eng.promoted_hits == 0 and eng.spill_pages_used() == 3
    release(engs, 1, 3)
    admit(engs, (0, PRE + [7, 7], 4, 0.0, 0))
    assert eng.promoted_hits == 1
    assert finish(engs, 0, 22) == solo(model, PRE + [7, 7], 4)
    release(engs, 0, 2)
    for e in engs:
        sh = e._shards[0]
        e._ensure_free(sh, sh.span - 1)
    same_state(*engs)
    assert eng.free_pages() == eng.pages - 1


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_demote_promote_round_trip_is_bit_exact(model, kv):
    """The pages a demotion copies to the host are the pool's stored bits
    (codes and scales, or model-dtype values), and promotion lands exactly
    those bits in fresh pages."""
    eng = engine(model, kv_dtype=kv, spill_pages=4, **SPILL)
    eng.admit([(0, PRE, 4, 0.0, 0)])
    drain(eng, {0: (0, 19)})
    eng.release([0])
    sh = eng._shards[0]
    pgs = sh.prefix[hash(tuple(PRE))][1]
    idx = torch.as_tensor(pgs)
    stored = [torch.stack([entry[kind][idx] for entry in eng._pools])
              for kind in range(len(eng._pools[0]))]
    for slot, prompt in ((1, PROMPT_B), (2, PROMPT_C)):
        eng.admit([(slot, prompt, 4, 0.0, 0)])
        eng.release([slot])
    eng.admit([(3, PROMPT_D, 4, 0.0, 0)])           # demotes PRE
    eng.release([3])
    toks, payload, n = sh.spill[hash(tuple(PRE))]
    assert toks == tuple(PRE) and n == 2
    assert all(torch.equal(p, s) for p, s in zip(payload, stored))
    assert all(not p.is_pinned() for p in payload)   # pinned on the card only
    eng.admit([(0, PRE + [7, 7], 4, 0.0, 0)])
    assert eng.promoted_hits == 1
    landed = torch.as_tensor(sh.prefix[hash(tuple(PRE))][1])
    assert all(torch.equal(torch.stack([entry[kind][landed]
                                        for entry in eng._pools]), s)
               for kind, s in enumerate(stored))
    assert drain(eng, {0: (16, 21)})[0][:22].tolist() == solo(
        model, PRE + [7, 7], 4)
    page_accounting_exact(eng)


def test_batcher_spill_admission_deadlock_free(model):
    """tests/test_continuous.py::test_batcher_spill_admission_deadlock_free
    in the port: overlapping shared-prefix requests over a spilling int8
    engine all complete (promoted pages are cache-only, so still
    evictable) and greedy replies equal solo generate()."""
    eng = engine(model, kv_dtype="int8", spill_pages=4, **SPILL)
    cb = tserving.ContinuousBatcher(eng)
    reqs = [(PRE + [7, 7], 4), (PROMPT_B, 4), (PROMPT_C, 4),
            (PRE + [9, 9], 4), (PROMPT_D, 4), (PRE[:8] + [4, 4], 6)]
    results, errors = {}, []

    def run(i, prompt, mt):
        try:
            results[i] = cb.submit(prompt, mt, timeout=120.0)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p, mt))
               for i, (p, mt) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
        assert not t.is_alive()
    assert not errors
    for i, (prompt, mt) in enumerate(reqs):
        assert results[i] == solo(model, prompt, mt), f"request {i}"
    page_accounting_exact(eng)
