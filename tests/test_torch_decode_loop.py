"""The port's paged slot-pool engine (``SlotPoolEngine``) on the CPU at a
tiny f32 size: against the JAX package's engine (greedy tokens equal,
``debug_logits`` within 1e-5, ``validate_page_pool`` alike), and within
the port against its own solo ``generate()`` (greedy and sampled rows,
mixed shapes, mid-flight admission, slot and neighbour invariance), plus
page accounting and the protocol the reference's ``ContinuousBatcher``
reads."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import decode_loop as jdl
from kubeoperator_tpu.workloads import serving as jserving
from kubeoperator_tpu.workloads.transformer import TransformerConfig
from kubeoperator_tpu_torch.workloads import decode_loop as tdl
from kubeoperator_tpu_torch.workloads.generate import generate
from kubeoperator_tpu_torch.workloads.train import MeshSpec
from kubeoperator_tpu_torch.workloads.transformer import rope
from test_torch_bridge import jax_params, port_cfg, port_model

torch.set_num_threads(2)

# tests/test_continuous.py's CFG and key
JCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq_len=24, dtype=jnp.float32,
                         remat=False, attention="dense")
CFG = port_cfg(JCFG)

MIXED = {0: ([1, 2, 3, 4, 5], 6),                 # non-pow2 prompt
         1: ([7, 8, 9, 10, 11, 12, 13, 14], 5),   # pow2 prompt
         2: ([42], 9),                            # single-token prompt
         3: ([3, 1, 4, 1, 5, 9, 2], 12)}


@pytest.fixture(scope="module")
def params():
    return jax_params(JCFG, seed=7)


@pytest.fixture(scope="module")
def model(params):
    return port_model(JCFG, params)


def engine(model, **kw):
    return tdl.SlotPoolEngine(CFG, model, device="cpu", **kw)


def jax_engine(params, **kw):
    # compile_cache=None: tests/conftest.py routes bare engines through a
    # session-wide AOT cache whose artifacts carry other modules' weights
    return jdl.SlotPoolEngine(JCFG, jax.tree.map(jnp.asarray, params),
                              compile_cache=None, **kw)


def solo(model, prompt, mt, temperature=0.0, seed=0):
    return generate(CFG, model, [prompt], mt, temperature=temperature,
                    seed=seed, device="cpu")[0].tolist()


def admit_tracked(eng, track, entries):
    pos = eng.admit(entries)
    for slot, prompt, mt, _t, _s in entries:
        track[slot] = (pos[slot], len(prompt) + mt - 1)


def drain(eng, track):
    """Run segments until every tracked slot is finished; return rows."""
    for _ in range(200):
        if all(p >= last for p, last in track.values()):
            break
        eng.run_segment()
        for s, (p, last) in track.items():
            track[s] = (min(p + eng.segment, last), last)
    buf, _ = eng.poll()
    return np.asarray(buf)


def mixed_run(eng, temps=None, seeds=None):
    temps = temps or {}
    seeds = seeds or {}
    track = {}
    admit_tracked(eng, track, [(s, p, mt, temps.get(s, 0.0), seeds.get(s, 0))
                               for s, (p, mt) in MIXED.items()])
    buf = drain(eng, track)
    return {s: buf[s][:len(p) + mt].tolist() for s, (p, mt) in MIXED.items()}


def mid_flight_run(eng, temps=(0.0, 0.0)):
    track = {}
    admit_tracked(eng, track, [(0, [5, 6, 7, 8, 9, 10], 10, temps[0], 3)])
    eng.run_segment()   # slot 0 is now mid-decode
    track[0] = (min(track[0][0] + 2, track[0][1]), track[0][1])
    admit_tracked(eng, track, [(2, [11, 12, 13], 8, temps[1], 4)])
    buf = drain(eng, track)
    return buf[0][:16].tolist(), buf[2][:11].tolist()


# ---------------------------------------------------------------------------
# against the JAX package's engine
# ---------------------------------------------------------------------------

def test_greedy_mixed_shapes_match_jax_engine(model, params):
    """tests/test_continuous.py::test_greedy_matches_solo_mixed_shapes on
    both engines: mixed prompt lengths (pow2 and not) and per-row
    max_tokens in one pool give the same greedy tokens."""
    got = mixed_run(engine(model, slots=4, segment=3))
    want = mixed_run(jax_engine(params, slots=4, segment=3))
    assert got == want
    for s, (prompt, mt) in MIXED.items():
        assert got[s] == solo(model, prompt, mt), f"slot {s}"


def test_mid_flight_admission_matches_jax_engine(model, params):
    """tests/test_continuous.py::test_mid_flight_admission_matches_solo on
    both engines: a request admitted while another is mid-decode."""
    got = mid_flight_run(engine(model, slots=3, segment=2))
    want = mid_flight_run(jax_engine(params, slots=3, segment=2))
    assert got == want
    assert got[0] == solo(model, [5, 6, 7, 8, 9, 10], 10)
    assert got[1] == solo(model, [11, 12, 13], 8)


def test_debug_logits_after_admission_match_jax_engine(model, params):
    entries = [(s, p, mt, 0.0, 0) for s, (p, mt) in MIXED.items()]
    eng, jeng = engine(model, slots=4, segment=3), jax_engine(
        params, slots=4, segment=3)
    pos = eng.admit(entries)
    assert pos == jeng.admit(entries)
    np.testing.assert_allclose(eng.debug_logits(), jeng.debug_logits(),
                               atol=1e-5, rtol=1e-5)
    # the hook advances nothing: decoding on gives the solo tokens
    track = {s: (pos[s], len(p) + mt - 1) for s, (p, mt) in MIXED.items()}
    buf = drain(eng, track)
    for s, (prompt, mt) in MIXED.items():
        assert buf[s][:len(prompt) + mt].tolist() == solo(model, prompt, mt)


PAGE_GRID = [dict(page=p, pages=n, max_seq_len=t, dp=dp, kv_dtype=kv,
                  spill_pages=sp)
             for p, n, t, dp, kv, sp in [
                 (8, 7, 24, 1, "bf16", 0), (6, 8, 24, 1, "bf16", 0),
                 (0, 8, 24, 1, "bf16", 0), (32, 8, 24, 1, "bf16", 0),
                 (16, 8, 24, 1, "bf16", 0), (8, 9, 24, 2, "bf16", 0),
                 (8, 2, 24, 2, "bf16", 0), (8, 1, 24, 1, "bf16", 0),
                 (8, 8, 24, 1, "int4", 0), (1, 8, 24, 1, "int8", 0),
                 (2, 8, 24, 1, "fp8", 0), (8, 8, 24, 1, "bf16", -1),
                 (16, 4097, 2048, 1, "bf16", 0), (16, 2049, 2048, 1, "int8", 8)]]


@pytest.mark.parametrize("kw", PAGE_GRID,
                         ids=[str(tuple(k.values())) for k in PAGE_GRID])
def test_validate_page_pool_matches_jax(kw):
    def outcome(fn):
        try:
            fn(**kw)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(tdl.validate_page_pool) == outcome(jdl.validate_page_pool)


def test_constants_and_defaults_match_jax():
    assert tdl.KV_DTYPES == jdl.KV_DTYPES
    assert tdl.LOGIT_TOLERANCE == jdl.LOGIT_TOLERANCE
    for t in (1, 6, 8, 24, 48, 2048, 4096):
        assert tdl._default_page(t) == jdl._default_page(t)


def test_rope_rows_is_rope_at_each_rows_position():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((5, 1, 4, 8)), dtype=torch.float32)
    pos = torch.tensor([0, 3, 7, 23, 1000])
    got = tdl._rope_rows(x, pos)
    for i in range(5):
        assert torch.equal(got[i:i + 1], rope(x[i:i + 1], pos[i:i + 1]))
    want = np.asarray(jdl._rope_rows(jnp.asarray(x.numpy()),
                                     jnp.asarray(pos.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# within the port: the pool equals its own solo generate()
# ---------------------------------------------------------------------------

def test_pool_matches_solo_greedy_and_sampled_mixed_shapes(model):
    temps, seeds = {1: 0.8, 3: 1.3}, {0: 5, 1: 6, 2: 7, 3: 8}
    got = mixed_run(engine(model, slots=4, segment=3), temps, seeds)
    for s, (prompt, mt) in MIXED.items():
        assert got[s] == solo(model, prompt, mt, temps.get(s, 0.0),
                              seeds[s]), f"slot {s}"


def test_mid_flight_sampled_matches_solo(model):
    got = mid_flight_run(engine(model, slots=3, segment=2), (0.9, 0.7))
    assert got[0] == solo(model, [5, 6, 7, 8, 9, 10], 10, 0.9, 3)
    assert got[1] == solo(model, [11, 12, 13], 8, 0.7, 4)


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_row_invariant_to_slot_and_neighbours(model, temp):
    prompt, mt = [9, 8, 7, 6, 5], 7
    runs = []
    for slot, neighbours in ((0, []), (2, [(0, [1, 2], 10, 0.0, 0),
                                           (3, [4, 4, 4, 4], 6, 0.7, 5)])):
        eng = engine(model, slots=4, segment=4)
        track = {}
        admit_tracked(eng, track, neighbours + [(slot, prompt, mt, temp, 9)])
        runs.append(drain(eng, track)[slot][:len(prompt) + mt].tolist())
    assert runs[0] == runs[1] == solo(model, prompt, mt, temp, 9)


def test_segment_needs_no_device_read(model):
    """run_segment only enqueues work: the host mirror of every position
    equals the device's after it, without a fetch in between."""
    eng = engine(model, slots=4, segment=3)
    eng.admit([(s, p, mt, 0.5 * (s % 2), s) for s, (p, mt) in MIXED.items()])
    for _ in range(3):
        eng.run_segment()
        _, pos = eng.poll()
        np.testing.assert_array_equal(pos, eng._pos_h)


# ---------------------------------------------------------------------------
# page accounting
# ---------------------------------------------------------------------------

def test_page_pool_defaults_match_jax(model, params):
    eng, jeng = engine(model, slots=2, segment=2), jax_engine(
        params, slots=2, segment=2)
    for e in (eng, jeng):
        assert (e.page, e.blocks, e.pages) == (8, 3, 2 * 3 + 1)
        assert e.max_request_pages == e.pages - 1
        assert e.pages_for(5, 4) == 2                 # ceil(9/8)
        assert e.free_pages(0) == e.pages - 1         # trash page reserved
    assert eng.pool_bytes == 2 * CFG.n_layers * 7 * 8 * 4 * 8 * 4


def test_release_returns_pages_and_points_tables_at_trash(model):
    eng = engine(model, slots=3, segment=4)
    trash = eng._shards[0].trash
    eng.admit([(0, [1, 2, 3], 8, 0.0, 0), (2, [4] * 9, 10, 0.0, 0)])
    assert eng.pages_in_use() == 2 + 3
    assert eng.free_pages() == eng.pages - 1 - 5
    held = set(eng._bt_np[0, :2]) | set(eng._bt_np[2, :3])
    assert len(held) == 5 and trash not in held
    assert eng.last_plans[2]["pages"] == 3 and eng.last_plans[2]["bucket"] == 8
    eng.release([0])
    assert eng.pages_in_use() == 3
    assert (eng._bt_np[0] == trash).all()
    assert (eng._bt.numpy()[0] == trash).all()
    assert (eng._bt.numpy()[2, :3] == eng._bt_np[2, :3]).all()
    eng.release([2, 1])              # slot 1 holds nothing: ignored
    assert eng.pages_in_use() == 0 and eng.free_pages() == eng.pages - 1
    assert (eng._bt.numpy() == trash).all()
    # a retired row keeps writing its frozen K/V into the trash page only
    before = [p.clone() for entry in eng._pools for p in entry]
    eng.run_segment()
    after = [p for entry in eng._pools for p in entry]
    for b, a in zip(before, after):
        keep = torch.ones(eng.pages, dtype=torch.bool)
        keep[trash] = False
        assert torch.equal(b[keep], a[keep])


def test_readmitted_slot_releases_its_pages(model):
    eng = engine(model, slots=2, segment=2)
    eng.admit([(0, [1, 2, 3], 12, 0.0, 0)])
    assert eng.pages_in_use() == 2
    eng.admit([(0, [5, 6], 3, 0.0, 0)])
    assert eng.pages_in_use() == 1


def test_page_exhaustion_raises(model):
    eng = engine(model, slots=4, segment=2, pages=5)
    assert eng.max_request_pages == 4
    eng.admit([(0, [1, 2, 3], 8, 0.0, 0), (1, [4, 5, 6], 8, 0.0, 1)])
    assert eng.free_pages(0) == 0 and eng.evictable_pages(0) == 0
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        eng.admit([(2, [7, 8, 9], 8, 0.0, 2)])


def test_engine_validates_requests(model):
    eng = engine(model, slots=2, segment=2)
    with pytest.raises(ValueError):
        eng.admit([(0, [], 4, 0.0, 0)])
    with pytest.raises(ValueError, match="exceed max_seq_len"):
        eng.admit([(0, [1] * 20, 10, 0.0, 0)])
    with pytest.raises(ValueError, match="outside pool"):
        eng.admit([(5, [1, 2], 4, 0.0, 0)])
    with pytest.raises(ValueError, match="slots and segment"):
        engine(model, slots=0)
    with pytest.raises(ValueError, match="power of two"):
        engine(model, page=6)


@pytest.mark.parametrize("kw,item", [
    (dict(kv_dtype="int8"), "item 7"), (dict(spill_pages=4), "item 7"),
    (dict(spec_k=2, draft_layers=1), "item 9"),
    (dict(mesh_spec=MeshSpec(dp=2)), "item 14"),
    (dict(compile_cache=object()), "item 15")])
def test_unported_options_raise(model, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        engine(model, **kw)


def test_moe_config_raises(model):
    with pytest.raises(NotImplementedError, match="item 9"):
        tdl.SlotPoolEngine(dataclasses.replace(CFG, moe_experts=4), model,
                           device="cpu")


def test_model_must_be_on_the_engine_device(model):
    with pytest.raises(ValueError, match="model is on"):
        tdl.SlotPoolEngine(CFG, model, device="meta")


# ---------------------------------------------------------------------------
# the duck-typed protocol the reference's ContinuousBatcher reads
# ---------------------------------------------------------------------------

def test_reference_batcher_drives_the_port_engine(model):
    """The JAX package's ContinuousBatcher (framework-free) reads slots,
    segment, max_total, dp, page/pages accounting, admit, last_plans,
    run_segment, poll and release: driven by it, the port's pool still
    gives every request its solo tokens and hands every page back."""
    eng = engine(model, slots=4, segment=2, pages=7)
    cb = jserving.ContinuousBatcher(eng)
    reqs = [([1, 2, 3, 4, 5], 6, 0.0), ([7, 8, 9], 4, 0.0),
            ([3, 1, 4, 1, 5, 9, 2, 6], 8, 0.7), ([2, 2, 2], 12, 0.0),
            ([40, 41], 0, 0.0)]
    results = {}

    def client(i, prompt, mt, temp):
        results[i] = cb.submit(prompt, mt, temperature=temp, seed=i,
                               timeout=120.0)

    threads = [threading.Thread(target=client, args=(i, *r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
        assert not t.is_alive()
    for i, (prompt, mt, temp) in enumerate(reqs):
        assert results[i] == solo(model, prompt, mt, temp, i), f"request {i}"
    # the reference batcher wakes a client before it releases the slot's
    # pages: wait (bounded) for the worker to hand them back
    deadline = time.monotonic() + 60.0
    while eng.free_pages(0) != eng.pages - 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.free_pages(0) == eng.pages - 1
    s = cb.stats.snapshot()
    assert s["requests_total"] == 5 and s["errors_total"] == 0
