"""The port's serve tracer (``telemetry/serve_trace.py``) against the
reference's: the store's ring, the span cap, ``critical_path`` on the same
rendered payloads, and the trees the two packages' batchers and tracers
build for the same choreography (span names, kinds, parents, attribute
keys and their host values), f32 at the tiny size of
tests/test_torch_decode_loop.py: a full prefix hit's tree on one device,
and complete trees on the port's 2-shard pool under gloo, with the JAX
engine's tokens."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.telemetry import serve_trace as jst
from kubeoperator_tpu.telemetry import tracing as jtracing
from kubeoperator_tpu.workloads import decode_loop as jdl
from kubeoperator_tpu.workloads import serving as jserving
from kubeoperator_tpu.workloads.generate import generate as jgenerate
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu_torch.telemetry import serve_trace as tst
from kubeoperator_tpu_torch.telemetry import tracing as ttracing
from kubeoperator_tpu_torch.workloads import decode_loop as tdl
from kubeoperator_tpu_torch.workloads import serving as tserving
from test_torch_bridge import jax_params, port_cfg, port_model
from test_torch_decode_loop import JCFG
from torch_dist_cases import TRACE_REQS, gated_submits, spawn_group

torch.set_num_threads(2)

CFG = port_cfg(JCFG)
# 16 tokens = exactly 2 pages at the page size JCFG resolves to
PRE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
WAIT = 120.0
PACKAGES = ((tst, ttracing), (jst, jtracing))


@pytest.fixture(scope="module")
def params():
    return jax_params(JCFG, seed=7)


def jax_solo(params, prompt, mt):
    out = jgenerate(JCFG, jax.tree.map(jnp.asarray, params),
                    jnp.asarray([prompt], jnp.int32), mt, temperature=0.0)
    return np.asarray(out)[0].tolist()


def fake_record(tracing, rid: str, duration: float):
    root = {"name": "request", "kind": "serve", "span_id": "r" + rid,
            "parent_id": "", "start_offset_s": 0.0, "duration_s": duration,
            "status": "ok", "attributes": {}, "events": []}
    child = {"name": "retire", "kind": "serve", "span_id": "c" + rid,
             "parent_id": "r" + rid, "start_offset_s": duration / 2,
             "duration_s": duration / 2, "status": "ok", "attributes": {},
             "events": []}
    return tracing.TraceRecord(name=rid, operation="serve",
                               spans=[root, child])


def shape(spans: list[dict]) -> list[tuple]:
    """Each span's name, kind, parent's name, status, attribute keys with
    the values that are not times, and event names (compile events
    aside), as a sorted list: the tree a choreography gives, with its
    ids and times taken out."""
    names = {s["span_id"]: s["name"] for s in spans}
    return sorted(
        (s["name"], s["kind"], names.get(s["parent_id"], ""), s["status"],
         tuple(sorted((k, None if k.endswith("_s") else repr(v))
                      for k, v in s["attributes"].items())),
         tuple(e["name"] for e in s["events"] if e["name"] != "compile"))
        for s in spans)


def test_store_span_cap_and_critical_path_are_the_reference_s():
    """The ring evicts the oldest record and counts it, a re-added id
    refreshes, ``slowest`` orders by root duration; past the span cap the
    tail drops, never the root; and one stitched choreography (gateway
    wait, handoff, admit and prefill, a decode segment, a drain hop, a
    re-admission on a full hit, retire), a shed request and a failed one
    give the reference's trees, whose ``critical_path`` the two packages
    compute alike, its phases and ``unattributed`` tiling the root's
    duration."""
    rings = []
    for st, tracing in PACKAGES:
        store = st.ServeTraceStore(max_records=3)
        for i in range(4):
            store.add(fake_record(tracing, f"req{i}", 0.1 * (i + 1)))
        seen = [store.evicted, store.get("req0"),
                [r.name for r in store.records()]]
        store.add(fake_record(tracing, "req2", 9.0))
        seen += [store.evicted, [r.name for r in store.records()],
                 [r.name for r in store.slowest(2)]]
        store.clear()
        rings.append(seen + [store.records(), store.evicted])
    assert rings[0] == rings[1]
    assert rings[0][:3] == [1, None, ["req1", "req2", "req3"]]

    capped = []
    for st, _ in PACKAGES:
        store = st.ServeTraceStore()
        rt = st.RequestTrace("rq", store, max_spans=4, prompt_len=5,
                             max_tokens=99)
        rt.admitted(slot=0, shard=0, wave_s=0.01, plan=None)
        for _ in range(3):
            rt.segment(0.001, pos=4, k=1, shard=0)
        rt.retire(blocked_s=0.002, device_s=0.003, shard=0, tokens=99)
        rec = store.get("rq")
        payload = st.render_record(rec)
        root = next(s for s in rec.spans if not s["parent_id"])
        assert payload["duration_s"] == root["duration_s"] > 0
        capped.append((rec.dropped, shape(rec.spans)))
    assert capped[0] == capped[1] and capped[0][0] == 4

    def choreography(st, store):
        tracer = st.ServeTracer(store, max_spans=64)
        rt = tracer.begin("stitched", prompt_len=16, max_tokens=8,
                          gateway=True, tenant="a", priority="batch")
        time.sleep(0.002)
        rt.dispatched(replica=0, decision="sticky")
        rt.handoff(pages=2, seconds=0.001, replica=0)
        time.sleep(0.002)
        rt.admitted(slot=1, shard=0, wave_s=0.001,
                    plan={"pages": 3, "bucket": 16, "hit_kind": "miss",
                          "pos0": 0, "pages_reused": 0, "hit_len": 0},
                    replica=0)
        rt.ttft(0.004)
        rt.segment(0.001, pos=16, k=2, shard=0)
        rt.aot_event(hit=True, seconds=0.0)
        rt.hop_begin(reason="drain", from_replica=0)
        time.sleep(0.002)
        rt.dispatched(replica=1, decision="requeue")
        rt.admitted(slot=0, shard=0, wave_s=0.001,
                    plan={"pages": 3, "bucket": 16, "hit_kind": "full",
                          "pos0": 15, "pages_reused": 2, "hit_len": 16},
                    replica=1)
        time.sleep(0.001)
        rt.segment(0.001, pos=16, k=2, shard=0)
        rt.retire(blocked_s=0.001, device_s=0.002, shard=0, tokens=8)
        shed = tracer.begin("shed", prompt_len=4, max_tokens=2,
                            gateway=True, tenant="b", priority="latency")
        shed.shed(reason="rate", retry_after_s=0.5)
        failed = tracer.begin("failed", prompt_len=4, max_tokens=2)
        failed.fail(RuntimeError("engine lost"))
        return {r.name: st.render_record(r) for r in store.records()}

    port = choreography(tst, tst.ServeTraceStore())
    ref = choreography(jst, jst.ServeTraceStore())
    assert sorted(port) == sorted(ref) == ["failed", "shed", "stitched"]
    for rid in port:
        assert shape(port[rid]["spans"]) == shape(ref[rid]["spans"]), rid
        for payload in (port[rid], ref[rid]):
            cp = tst.critical_path(payload)
            assert cp == jst.critical_path(payload)
            assert sum(cp["phases"].values()) + cp["unattributed"] \
                == pytest.approx(cp["duration_s"], abs=1e-5)
    cp = tst.critical_path(port["stitched"])
    assert {"gateway_wait", "handoff", "prefill", "decode", "hop",
            "host_blocked"} <= set(cp["phases"])
    assert (cp["ttft_s"], cp["status"]) == (0.004, "ok")
    assert tst.critical_path(port["shed"])["status"] == "shed"
    assert tst.critical_path(port["failed"])["status"] == "error"
    assert tst.critical_path({"spans": []}) == jst.critical_path(
        {"spans": []})


def test_full_hit_trace_skips_prefill_span(params):
    """The same prompt twice through a traced batcher: the cold request's
    tree has its ``prefill`` span under ``admit`` over [0, 16), the full
    hit's none; both trees are the reference batcher's over the JAX
    engine, host values and all, and both replies the JAX ``generate()``'s."""
    model = port_model(JCFG, params)
    trees = []
    for st, engine, batcher in (
            (tst, tdl.SlotPoolEngine(CFG, model, slots=2, segment=2,
                                     device="cpu"),
             tserving.ContinuousBatcher),
            (jst, jdl.SlotPoolEngine(JCFG, jax.tree.map(jnp.asarray,
                                                        params),
                                     slots=2, segment=2,
                                     compile_cache=None),
             jserving.ContinuousBatcher)):
        store = st.ServeTraceStore()
        cb = batcher(engine, tracer=st.ServeTracer(store))
        out1 = cb.submit(PRE, 4, timeout=WAIT)
        out2 = cb.submit(PRE, 4, timeout=WAIT)
        assert out1 == out2 == jax_solo(params, PRE, 4)
        trees.append([shape(r.spans) for r in store.records()])
        miss, hit = ({s["name"]: s for s in r.spans}
                     for r in store.records())
        if st is tst:
            assert miss["admit"]["attributes"]["hit_kind"] == "miss"
            assert miss["prefill"]["parent_id"] == miss["admit"]["span_id"]
            assert miss["prefill"]["attributes"] == {"start": 0, "stop": 16}
            a = hit["admit"]["attributes"]
            assert a["hit_kind"] == "full" and a["pages_reused"] == 2
            assert "prefill" not in hit
            assert {"enqueue", "segment", "retire"} <= set(hit)
    assert trees[0] == trees[1]


@pytest.fixture(scope="module")
def mesh_run(params, tmp_path_factory):
    inputs = {"dense": {"cfg": CFG,
                        "params": port_model(JCFG, params).state_dict()}}
    out = spawn_group("trace2", 2, tmp_path_factory.mktemp("trace2"),
                      inputs)
    return out[0]["trace_dp2"]


def test_trace_tree_complete_on_2shard_pool(params, mesh_run):
    """A traced batcher on rank 0 of the port's pool at dp 2 (gloo, the
    other rank following): four requests, the first admitted alone and
    the other three in the next wave, so both shards hold rows. Every
    retired request has a complete tree (enqueue → admit → prefill →
    segments → retire, each under the root, with its shard, pages, hit
    kind and host-blocked and device attribution) and, since the pool
    builds no kernel library, no compile event; the trees are the
    reference batcher's over the JAX engine at dp 2 in the same
    choreography, and the replies its tokens."""
    got = mesh_run
    eng = jdl.SlotPoolEngine(JCFG, jax.tree.map(jnp.asarray, params),
                             slots=4, segment=3, compile_cache=None,
                             mesh_spec=JMeshSpec(dp=2),
                             devices=jax.devices()[:2])
    store = jst.ServeTraceStore()
    cb = jserving.ContinuousBatcher(eng, tracer=jst.ServeTracer(store))
    want = gated_submits(cb, eng, TRACE_REQS)
    assert got["replies"] == want
    ref = {r.name: r for r in store.records()}
    assert len(got["records"]) == len(ref) == len(TRACE_REQS)
    assert got["evicted"] == 0
    port_shapes = sorted(shape(r["spans"]) for r in got["records"])
    assert port_shapes == sorted(shape(r.spans) for r in ref.values())
    shards = set()
    for rec in got["records"]:
        assert rec["operation"] == "serve" and rec["dropped"] == 0
        names = {}
        for s in rec["spans"]:
            names.setdefault(s["name"], []).append(s)
        assert {"request", "enqueue", "admit", "prefill", "segment",
                "retire"} <= set(names)
        root = names["request"][0]
        assert not root["parent_id"] and root["duration_s"] > 0
        assert root["attributes"]["ttft_s"] > 0
        for name in ("enqueue", "admit", "segment", "retire"):
            assert all(s["parent_id"] == root["span_id"]
                       for s in names[name]), name
        a = names["admit"][0]["attributes"]
        assert a["shard"] == a["slot"] // 2
        assert a["pages"] >= 1 and a["hit_kind"] == "miss"
        shards.add(a["shard"])
        r = names["retire"][0]["attributes"]
        assert r["host_blocked_s"] >= 0 and r["tokens"] > 0
        assert "device_s" in r
        assert not any(e["name"] == "compile" for s in rec["spans"]
                       for e in s["events"])
        cp = tst.critical_path(rec)
        assert sum(cp["phases"].values()) + cp["unattributed"] \
            == pytest.approx(cp["duration_s"], abs=1e-5)
    assert shards == {0, 1}
    assert "ko_serve_segment_device_seconds_count" in got["prometheus"]
    assert 'ko_serve_host_blocked_seconds_count{shard="1"}' \
        in got["prometheus"]
