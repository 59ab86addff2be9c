"""The port's prefix cache on the CPU at a tiny f32 size, against the JAX
package's engine running the same script: hits of all three kinds (full,
cover, partial), copy-on-write between sharers and within one wave, LRU
eviction with exact refcounts, and the prefill→decode handoff
(``export_prefix``/``import_prefix``) in both directions. Greedy tokens
equal the JAX engine's and the port's own solo ``generate()``;
``debug_logits`` within 1e-5 of the JAX engine; hit, copy-on-write and
page counters, ``last_plans``, block tables and the LRU equal the JAX
engine's after every wave."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode_loop import (  # noqa: F401 (model, params: fixtures)
    admit_tracked, drain, engine, jax_engine, model, params, solo,
)

torch.set_num_threads(2)

# tests/test_continuous.py's shared prefix and prompts
PRE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
PROMPT_B = [(3 * i + 5) % 60 + 1 for i in range(16)]
PROMPT_C = [(3 * i + 7) % 60 + 1 for i in range(20)]
PROMPT_D = [(11 * i + 13) % 60 + 1 for i in range(20)]


def page_accounting_exact(eng):
    """tests/test_continuous.py's allocator oracle: ref and cache_ref
    recomputed from the slots' holdings and the prefix entries equal the
    incremental bookkeeping, every usable page is free or referenced
    exactly once, and the spill tier stays within its bound."""
    for sh in eng._shards:
        held: dict[int, int] = {}
        for pages in eng._slot_pages.values():
            for pg in pages:
                held[pg] = held.get(pg, 0) + 1
        cache: dict[int, int] = {}
        for _toks, pgs in sh.prefix.values():
            for pg in pgs:
                cache[pg] = cache.get(pg, 0) + 1
        assert cache == sh.cache_ref, "cache_ref drifted from prefix entries"
        want = {pg: held.get(pg, 0) + cache.get(pg, 0)
                for pg in set(held) | set(cache)}
        assert want == sh.ref, "ref drifted from slot+cache holdings"
        assert sorted(sh.free + list(sh.ref)) == list(
            range(sh.base + 1, sh.base + sh.span)), (
            "pages leaked or double-freed")
        assert sh.spill_used == sum(n for _t, _p, n in sh.spill.values())
        assert sh.spill_used <= eng.spill_pages


COUNTERS = ("prefix_hits", "prefix_pages_reused", "cow_copies", "demotions",
            "promoted_hits")


def same_state(eng, jeng):
    """The host state both engines must agree on after a wave: counters,
    page accounting, the last wave's plans, block tables, the LRU (keys,
    tokens and pages, in order) and the spill tier's entries."""
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.evictable_pages() == jeng.evictable_pages()
    assert eng.pages_in_use() == jeng.pages_in_use()
    assert eng.free_pages() == jeng.free_pages()
    assert eng.spill_pages_used() == jeng.spill_pages_used()
    assert eng.last_plans == jeng.last_plans
    np.testing.assert_array_equal(eng._bt_np, jeng._bt_np)
    sh, jsh = eng._shards[0], jeng._shards[0]
    assert list(sh.prefix.items()) == list(jsh.prefix.items())
    assert [(k, t, n) for k, (t, _p, n) in sh.spill.items()] == [
        (k, t, n) for k, (t, _p, n) in jsh.spill.items()]
    page_accounting_exact(eng)


def same_logits(eng, jeng, atol=1e-5):
    np.testing.assert_allclose(eng.debug_logits(), jeng.debug_logits(),
                               atol=atol, rtol=atol)


def both(model, params, **kw):
    return engine(model, **kw), jax_engine(params, **kw)


def run_wave(engs, entries, tracks):
    """Admit the same wave into each engine (the tracks carry over)."""
    outs = []
    for eng, track in zip(engs, tracks):
        admit_tracked(eng, track, entries)
        outs.append({s: track[s][0] for s, *_ in entries})
    assert outs[0] == outs[1]


def test_prefix_hits_match_jax_and_solo_all_shapes(model, params):
    """tests/test_continuous.py::test_prefix_hits_match_solo_all_shapes on
    both engines: a cover hit (h >= bucket: no prefill pass), a full hit
    (copy-on-write re-decode of the boundary token) and a partial hit
    (prefill [h, c) seeded from the shared pages)."""
    engs = both(model, params, slots=4, segment=3)
    tracks = ({}, {})
    run_wave(engs, [(0, PRE + [11, 12], 6, 0.0, 0)], tracks)
    same_state(*engs)
    same_logits(*engs)
    bufs = [drain(e, t) for e, t in zip(engs, tracks)]
    assert bufs[0][0][:24].tolist() == bufs[1][0][:24].tolist() == solo(
        model, PRE + [11, 12], 6)
    assert engs[0].prefix_hits == 0
    reqs = {1: (PRE + [13, 14, 15], 5),  # h=16 >= bucket 16: no pass
            2: (PRE, 8),                 # full-prompt hit -> CoW
            3: (PRE[:8] + [7] * 9, 4)}   # h=8 < bucket 16: seeded prefill
    tracks = ({}, {})
    run_wave(engs, [(s, p, mt, 0.0, 0) for s, (p, mt) in reqs.items()],
             tracks)
    assert engs[0].prefix_hits == 3 and engs[0].cow_copies == 1
    assert {s: p["hit_kind"] for s, p in engs[0].last_plans.items()} == {
        1: "cover", 2: "full", 3: "partial"}
    assert engs[0]._pos_h[2] == len(PRE) - 1
    same_state(*engs)
    same_logits(*engs)
    bufs = [drain(e, t) for e, t in zip(engs, tracks)]
    same_state(*engs)
    for s, (prompt, mt) in reqs.items():
        got = bufs[0][s][:len(prompt) + mt].tolist()
        assert got == np.asarray(bufs[1][s][:len(prompt) + mt]).tolist()
        assert got == solo(model, prompt, mt), f"slot {s}"


@pytest.mark.parametrize("temp", [0.8, 1.3])
def test_sampled_hits_equal_solo(model, temp):
    """A sampled row draws the same tokens whether its prefix was cached
    (all three hit kinds) or not: the draws are keyed on (seed, 0,
    position), and a full hit samples position plen from plen-1's logits
    with the key a cold prefill's boundary choice uses."""
    eng = engine(model, slots=4, segment=3)
    track = {}
    admit_tracked(eng, track, [(0, PRE + [11, 12], 6, 0.0, 0)])
    drain(eng, track)
    reqs = {1: (PRE + [13, 14, 15], 5), 2: (PRE, 8), 3: (PRE[:8] + [7] * 9, 4)}
    track = {}
    admit_tracked(eng, track, [(s, p, mt, temp, 10 + s)
                               for s, (p, mt) in reqs.items()])
    assert eng.prefix_hits == 3
    buf = drain(eng, track)
    for s, (prompt, mt) in reqs.items():
        assert buf[s][:len(prompt) + mt].tolist() == solo(
            model, prompt, mt, temp, 10 + s), f"slot {s}"


def cached_pages(eng, toks):
    """The pages of the cache entry for ``toks``, and their contents."""
    pgs = eng._shards[0].prefix[hash(tuple(toks))][1]
    idx = torch.as_tensor(pgs)
    return pgs, [b[idx].clone() for entry in eng._pools for b in entry]


def test_cow_isolation_between_sharers(model, params):
    """tests/test_continuous.py::test_cow_isolation_between_sharers on both
    engines: two full hits on one cached prefix in one wave each get their
    own copy-on-write page, neither corrupts the other, and the cached
    pages are unchanged after both wrote, so a third request hits them."""
    engs = both(model, params, slots=4, segment=3)
    tracks = ({}, {})
    run_wave(engs, [(0, PRE, 4, 0.0, 0)], tracks)       # publish the pages
    for e, t in zip(engs, tracks):
        drain(e, t)
    pgs, before = cached_pages(engs[0], PRE)
    tracks = ({}, {})
    run_wave(engs, [(1, PRE, 6, 0.0, 0), (2, PRE, 8, 0.0, 0)], tracks)
    assert engs[0].cow_copies == 2
    # each sharer's last block is its own copy, its first the cached page
    for s in (1, 2):
        assert engs[0]._slot_pages[s][0] == pgs[0]
        assert engs[0]._slot_pages[s][1] != pgs[1]
    same_state(*engs)
    same_logits(*engs)
    bufs = [drain(e, t) for e, t in zip(engs, tracks)]
    for s, mt in ((1, 6), (2, 8)):
        got = bufs[0][s][:16 + mt].tolist()
        assert got == np.asarray(bufs[1][s][:16 + mt]).tolist()
        assert got == solo(model, PRE, mt)
    _, after = cached_pages(engs[0], PRE)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    tracks = ({}, {})
    run_wave(engs, [(3, PRE + [17, 18], 4, 0.0, 0)], tracks)
    assert engs[0].last_plans[3]["hit_kind"] == "cover"
    same_state(*engs)
    bufs = [drain(e, t) for e, t in zip(engs, tracks)]
    assert bufs[0][3][:22].tolist() == np.asarray(bufs[1][3][:22]).tolist() \
        == solo(model, PRE + [17, 18], 4)


def test_cow_source_evicted_and_reused_within_one_wave(model, params):
    """Plan A (a full hit) copies the cached page it is about to write;
    plan B of the same wave evicts that entry and is handed the freed
    source page for its own prefill. Copy-on-write gathers every source
    before any write of the wave, so A still gets the cached K/V."""
    engs = both(model, params, slots=2, segment=3, pages=7)
    tracks = ({}, {})
    run_wave(engs, [(0, PRE, 4, 0.0, 0)], tracks)
    for e, t in zip(engs, tracks):
        drain(e, t)
        e.release([0])
    src = engs[0]._shards[0].prefix[hash(tuple(PRE))][1][1]
    fresh = [31 - i for i in range(16)]
    tracks = ({}, {})
    run_wave(engs, [(0, PRE, 4, 0.0, 0), (1, fresh, 8, 0.0, 0)], tracks)
    assert engs[0].last_plans[0]["hit_kind"] == "full"
    # the scenario holds: B's first page is A's copy-on-write source
    assert engs[0]._slot_pages[1][0] == src
    assert src not in engs[0]._slot_pages[0]
    same_state(*engs)
    same_logits(*engs)
    bufs = [drain(e, t) for e, t in zip(engs, tracks)]
    for s, (prompt, mt) in ((0, (PRE, 4)), (1, (fresh, 8))):
        got = bufs[0][s][:len(prompt) + mt].tolist()
        assert got == np.asarray(bufs[1][s][:len(prompt) + mt]).tolist()
        assert got == solo(model, prompt, mt), f"slot {s}"


def test_eviction_refcount_correctness(model, params):
    """tests/test_continuous.py::test_eviction_refcount_correctness on both
    engines: released prefix pages stay cached (pages_in_use ==
    evictable), are evicted LRU-first when admission needs the room, and
    pages a live slot shares with the cache are never evictable."""
    engs = both(model, params, slots=2, segment=4, pages=7)
    tracks = ({}, {})
    run_wave(engs, [(0, PRE, 8, 0.0, 0)], tracks)       # 3 pages
    for e, t in zip(engs, tracks):
        drain(e, t)
        e.release([0])
    same_state(*engs)
    assert engs[0].pages_in_use() == 2 == engs[0].evictable_pages()
    assert engs[0].free_pages() == 4
    fresh = {0: ([7 + i for i in range(16)], 8),
             1: ([31 - i for i in range(16)], 8)}
    tracks = ({}, {})
    run_wave(engs, [(s, p, mt, 0.0, 0) for s, (p, mt) in fresh.items()],
             tracks)
    assert engs[0].free_pages() == 0 and engs[0].evictable_pages() == 0
    assert hash(tuple(PRE[:8])) not in engs[0]._shards[0].prefix
    same_state(*engs)
    same_logits(*engs)
    bufs = [drain(e, t) for e, t in zip(engs, tracks)]
    for s, (prompt, mt) in fresh.items():
        assert bufs[0][s][:24].tolist() == np.asarray(
            bufs[1][s][:24]).tolist() == solo(model, prompt, mt)
    for e in engs:
        e.release([0, 1])
    same_state(*engs)
    assert engs[0].pages_in_use() == engs[0].evictable_pages() == 4
    # a full drain hands every page back
    sh = engs[0]._shards[0]
    engs[0]._ensure_free(sh, sh.span - 1)
    assert engs[0].free_pages() == sh.span - 1 and not sh.prefix
    page_accounting_exact(engs[0])
    with pytest.raises(RuntimeError, match="after draining the prefix cache"):
        engs[0]._ensure_free(sh, sh.span)


def test_hash_collision_is_a_miss(model):
    """An entry filed under a prompt's hash with other tokens is a miss,
    never a wrong hit."""
    eng = engine(model, slots=2, segment=3)
    sh = eng._shards[0]
    sh.prefix[hash(tuple(PRE[:8]))] = (tuple(PROMPT_B[:8]), (5,))
    assert eng._lookup_prefix(0, PRE) == (0, ())
    track = {}
    admit_tracked(eng, track, [(0, PRE, 4, 0.0, 0)])
    assert eng.prefix_hits == 0
    # the resident entry is kept; the 16-token prefix is published
    assert sh.prefix[hash(tuple(PRE[:8]))][0] == tuple(PROMPT_B[:8])
    assert hash(tuple(PRE)) in sh.prefix
    assert drain(eng, track)[0][:20].tolist() == solo(model, PRE, 4)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_export_import_between_engines(model, params, direction):
    """The prefill→decode handoff across the two packages: one engine
    prefills and exports its pages, the numpy payload lands in the other
    engine's pool through ``import_prefix``, and the importer's next
    admission of the request is a full hit whose tokens equal the
    exporter's."""
    port, jeng = both(model, params, slots=2, segment=3)
    src, dst = (jeng, port) if direction == "jax_to_port" else (port, jeng)
    track = {}
    admit_tracked(src, track, [(0, PRE, 6, 0.0, 0)])
    want = np.asarray(drain(src, track)[0][:22]).tolist()
    layers = [(np.asarray(k), np.asarray(v))
              for k, v in src.export_prefix(0, 2)]
    assert layers[0][0].shape == (2, port.page, 4, 8)
    convert = ((lambda a: torch.tensor(a)) if dst is port
               else (lambda a: jnp.asarray(a)))
    assert dst.import_prefix(PRE, [(convert(k), convert(v))
                                   for k, v in layers]) == 2
    assert dst.import_prefix(PRE, layers) == 0      # already covered
    assert dst.pages_in_use() == 2 == dst.evictable_pages()
    track = {}
    admit_tracked(dst, track, [(1, PRE, 6, 0.0, 0)])
    assert dst.last_plans[1]["hit_kind"] == "full"
    assert np.asarray(drain(dst, track)[1][:22]).tolist() == want \
        == solo(model, PRE, 6)
    if dst is port:
        page_accounting_exact(port)
    with pytest.raises(ValueError, match="multiple of the page size"):
        dst.import_prefix(PRE[:5], layers)
    with pytest.raises(ValueError, match="cannot export"):
        src.export_prefix(0, 9)
