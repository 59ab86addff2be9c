"""The port's serving batchers on the CPU at a tiny f32 size:
``plan_bucket`` and ``BatcherStats`` against the JAX package's, the
``ContinuousBatcher`` end to end over the port's slot pool (solo tokens,
page backpressure, engine failure) and the ``DynamicBatcher`` over the
port's ``generate()`` (concurrent requests equal solo runs)."""

import re
import sys
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from kubeoperator_tpu.workloads import serving as jserving
from kubeoperator_tpu.workloads.transformer import TransformerConfig
from kubeoperator_tpu_torch.workloads import serving as tserving
from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
from kubeoperator_tpu_torch.workloads.generate import generate
from test_torch_bridge import jax_params, port_cfg, port_model

torch.set_num_threads(2)

JCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq_len=24, dtype=jnp.float32,
                         remat=False, attention="dense")
CFG = port_cfg(JCFG)
WAIT = 120.0     # seconds any one thread or request may take here


@pytest.fixture(scope="module")
def model():
    return port_model(JCFG, jax_params(JCFG, seed=7))


def solo(model, prompt, mt, temperature=0.0, seed=0):
    return generate(CFG, model, [prompt], mt, temperature=temperature,
                    seed=seed, device="cpu")[0].tolist()


def run_clients(submit, reqs, stagger_s=0.0):
    """Submit each (prompt, max_tokens, temperature) from its own thread;
    return {index: tokens}."""
    results = {}

    def client(i, prompt, mt, temp):
        time.sleep(stagger_s * i)
        results[i] = submit(prompt, mt, temperature=temp, seed=i,
                            timeout=WAIT)

    threads = [threading.Thread(target=client, args=(i, *r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    return results


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

BUCKET_GRID = [([5], [7], 24), ([5, 9], [3, 4], 24), ([1], [1], 2048),
               ([17, 3], [10, 2], 32), ([20], [4], 24), ([12], [12], 24),
               ([15, 2], [9, 9], 24), ([100, 60, 7], [28, 100, 1], 256),
               ([16], [8], 24), ([9], [15], 24)]


@pytest.mark.parametrize("lens,mt,t", BUCKET_GRID)
def test_plan_bucket_matches_jax(lens, mt, t):
    assert tserving.plan_bucket(lens, mt, t) == jserving.plan_bucket(
        lens, mt, t)


def _drive(stats, mod):
    stats.enqueued()
    stats.enqueued()
    stats.executed(3)
    stats.executed(16)
    req = mod._Pending([1, 2], 5, 0.0, 0)
    stats.finished(req, ok=True)
    stats.finished(req, ok=False)
    stats.occupancy(2)
    stats.ttft(0.02)
    stats.ttft(0.3)
    stats.segment(0.004)
    stats.segment_device(0.006)
    stats.host_blocked(0.001)
    stats.pages_used(7)


def test_batcher_stats_match_jax():
    got, want = tserving.BatcherStats(), jserving.BatcherStats()
    _drive(got, tserving)
    _drive(want, jserving)
    snap, jsnap = got.snapshot(), want.snapshot()
    assert snap.keys() == jsnap.keys()
    # every field but the wall-clock latencies is the same value
    for key in snap.keys() - {"latency_p50_s", "latency_p95_s"}:
        assert snap[key] == jsnap[key], key
    family = re.compile(r"^# TYPE (ko_serve_\S+) (\S+)$", re.M)
    fams = family.findall(got.prometheus())
    assert fams == family.findall(want.prometheus())
    assert len(fams) == 22
    # the same series too, once the wall-clock ones are left out
    series = re.compile(r"^(ko_serve_(?!request_latency)\S+ \S+)$", re.M)
    assert series.findall(got.prometheus()) == series.findall(
        want.prometheus())
    assert got.ttft_quantile(0.5) == want.ttft_quantile(0.5) == 0.025
    assert got.ttft_quantile(0.95) == want.ttft_quantile(0.95) == 0.5
    assert got.ttft_mean() == pytest.approx(want.ttft_mean())


def test_stats_registries_are_private_unless_shared():
    a, b = tserving.BatcherStats(), tserving.BatcherStats()
    a.executed(1)
    assert b.snapshot()["batches_total"] == 0
    shared = tserving.BatcherStats(registry=a.registry)
    assert shared.snapshot()["batches_total"] == 1


def test_short_id():
    ids = {tserving.short_id(12) for _ in range(50)}
    assert len(ids) == 50 and all(len(i) == 12 for i in ids)
    assert len(tserving._Pending([1], 1, 0.0, 0).id) == 12


# ---------------------------------------------------------------------------
# ContinuousBatcher over the port's slot pool
# ---------------------------------------------------------------------------

def test_continuous_batcher_end_to_end(model):
    eng = SlotPoolEngine(CFG, model, slots=4, segment=2, device="cpu")
    cb = tserving.ContinuousBatcher(eng)
    reqs = [([1, 2, 3, 4, 5], 6, 0.0), ([7, 8, 9], 4, 0.0),
            ([3, 1, 4, 1, 5, 9, 2, 6], 8, 0.7), ([2, 2, 2], 12, 0.0),
            ([40, 41], 0, 0.0), ([9, 9, 9, 9, 9, 9], 7, 1.1)]
    results = run_clients(cb.submit, reqs, stagger_s=0.01)
    for i, (prompt, mt, temp) in enumerate(reqs):
        assert results[i] == solo(model, prompt, mt, temp, i), f"request {i}"
    s = cb.stats.snapshot()
    assert s["requests_total"] == 6 and s["errors_total"] == 0
    assert s["tokens_generated_total"] == 6 + 4 + 8 + 12 + 7
    assert s["queue_depth"] == 0 and s["slot_occupancy"] == 0
    assert s["kv_pages_used"] == 0 and s["batches_total"] >= 1
    assert s["ttft_count"] == 5            # max_tokens=0 never decodes
    text = cb.stats.prometheus()
    assert 'ko_serve_slot_occupancy{shard="0"} 0' in text
    assert "ko_serve_ttft_seconds_bucket" in text
    assert "ko_serve_segment_duration_seconds_count" in text
    with pytest.raises(ValueError, match="exceed max_seq_len"):
        cb.submit([1] * 20, 10)
    with pytest.raises(ValueError, match="non-empty"):
        cb.submit([], 3)


def test_continuous_batcher_backpressure_on_pages(model):
    """More requests than the page pool holds at once: FIFO page
    accounting delays admission instead of failing the engine, every reply
    still matches solo, and retirement returns every page."""
    eng = SlotPoolEngine(CFG, model, slots=4, segment=4, pages=5,
                         device="cpu")
    admitted = []
    admit = eng.admit

    def spy(entries):
        admitted.append(len(entries))
        return admit(entries)

    eng.admit = spy
    cb = tserving.ContinuousBatcher(eng)
    reqs = [([5 + i, 6 + i, 7 + i], 8, 0.0) for i in range(4)]   # 2 pages each
    results = run_clients(cb.submit, reqs, stagger_s=0.005)
    for i, (prompt, mt, _) in enumerate(reqs):
        assert results[i] == solo(model, prompt, mt), f"request {i}"
    assert sum(admitted) == 4 and max(admitted) <= 2
    assert eng.free_pages() == 4 and eng.pages_in_use() == 0
    # a request that could never fit is rejected client-side, never queued
    tiny = tserving.ContinuousBatcher(SlotPoolEngine(
        CFG, model, slots=2, segment=2, pages=3, device="cpu"))
    with pytest.raises(ValueError, match="could never be admitted"):
        tiny.submit([1] * 16, 8)


def test_continuous_batcher_under_thread_stress(model):
    """More clients than cores against a small pool, with the interpreter
    switching threads every 10 µs: every reply is its solo run, and the
    queue, slots and pages all come back (a lost update to the shared
    queue or free list would strand a request or a page)."""
    eng = SlotPoolEngine(CFG, model, slots=3, segment=2, pages=6,
                         device="cpu")
    cb = tserving.ContinuousBatcher(eng)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11]]
    want = {i: solo(model, p, 5) for i, p in enumerate(prompts)}
    reqs = [(prompts[i % 4], 5, 0.0) for i in range(24)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = run_clients(lambda p, mt, **kw: cb.submit(
            p, mt, timeout=WAIT), reqs)
    finally:
        sys.setswitchinterval(old)
    assert all(results[i] == want[i % 4] for i in range(24))
    s = cb.stats.snapshot()
    assert s["requests_total"] == 24 and s["queue_depth"] == 0
    assert s["slot_occupancy"] == 0 and s["kv_pages_used"] == 0
    assert eng.free_pages() == eng.pages - 1 and sorted(cb._free) == [0, 1, 2]


class _Failing:
    """A slot pool whose segment fails: the batcher must fail the
    in-flight requests, count the errors and reset the pool."""

    slots, segment, max_total, page, pages = 2, 2, 24, 8, 7
    max_request_pages = 6

    def __init__(self):
        self.released = []

    def pages_for(self, plen, mt):
        return -(-(plen + mt) // self.page)

    def free_pages(self, shard=0):
        return 6

    def evictable_pages(self, shard=0):
        return 0

    def pages_in_use(self, shard=0):
        return 0

    def admit(self, entries):
        return {slot: 1 for slot, *_ in entries}

    def run_segment(self):
        raise RuntimeError("device lost")

    def release(self, slots):
        self.released.append(list(slots))


def test_continuous_batcher_fails_requests_when_the_engine_fails():
    eng = _Failing()
    cb = tserving.ContinuousBatcher(eng)
    with pytest.raises(RuntimeError, match="device lost"):
        cb.submit([1, 2, 3], 4, timeout=WAIT)
    s = cb.stats.snapshot()
    assert s["errors_total"] == 1 and s["queue_depth"] == 0
    assert eng.released == [[0, 1]]
    assert sorted(cb._free) == [0, 1]


# ---------------------------------------------------------------------------
# DynamicBatcher over the port's generate()
# ---------------------------------------------------------------------------

def _dynamic(model, calls):
    def run_batch(prompts, lens, max_new, temp, prefill, seed):
        calls.append((len(prompts), len(prompts[0]), max_new, prefill))
        return generate(CFG, model, prompts, max_new, temperature=temp,
                        seed=seed, prompt_lens=lens, prefill_len=prefill,
                        device="cpu").numpy()

    return tserving.DynamicBatcher(run_batch, max_batch=8, window_ms=200.0,
                                   max_seq_len=CFG.max_seq_len)


def test_dynamic_batcher_concurrent_requests_equal_solo(model):
    calls = []
    db = _dynamic(model, calls)
    reqs = [([1, 2, 3, 4, 5], 6, 0.0), ([7, 8, 9], 4, 0.0),
            ([3, 1, 4, 1, 5, 9, 2, 6], 3, 0.0), ([42], 9, 0.0)]
    results = run_clients(db.submit, reqs)
    for i, (prompt, mt, _) in enumerate(reqs):
        assert results[i] == solo(model, prompt, mt), f"request {i}"
    # fused: fewer executed batches than requests, each bucketed
    assert sum(c[0] for c in calls) == 4 and len(calls) < 4
    for b, p, n, prefill in calls:
        assert p >= 8 and p & (p - 1) == 0 and n & (n - 1) == 0
    s = db.stats.snapshot()
    assert s["requests_total"] == 4 and s["tokens_generated_total"] == 22


def test_dynamic_batcher_splits_temperatures_and_reports_errors(model):
    calls = []
    db = _dynamic(model, calls)
    reqs = [([1, 2, 3], 4, 0.0), ([4, 5, 6], 4, 0.8)]
    results = run_clients(db.submit, reqs)
    assert results[0] == solo(model, [1, 2, 3], 4)
    assert results[1] == solo(model, [4, 5, 6], 4, 0.8, 1)
    assert len(calls) == 2              # one batch per temperature

    def broken(*a):
        raise RuntimeError("decode failed")

    bad = tserving.DynamicBatcher(broken, window_ms=1.0)
    with pytest.raises(RuntimeError, match="decode failed"):
        bad.submit([1, 2], 3, timeout=WAIT)
    assert bad.stats.snapshot()["errors_total"] == 1
