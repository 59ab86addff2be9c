"""The port's cluster tier (``cluster/gateway.py``, ``cluster/disagg.py``)
and the continuous batcher's levers on the CPU: one scripted choreography
(a drain mid-decode, a readmit, an inject, a priority preemption, QoS
sheds, an unknown model) driven through the reference's batcher and
gateway and through the port's over the same numpy cost-model engine
(``scenario.engines.FakePagedEngine``), with equal requeues, snapshots,
counters and replies; then real port engines at the tiny f32 size of
tests/test_torch_decode_loop.py: two replicas behind the gateway give
the JAX ``generate()``'s greedy tokens, a page handoff between two port
engines (directly and through the gateway's prefill worker) is a prefix
hit with those tokens, and drained and preempted rows equal their solo
runs.

The choreography is scripted on state, never on sleeps: the engines
inject no latency and hold each segment until the script releases it,
and each lever is called once the batchers' host state shows the rows it
needs in flight."""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.cluster import gateway as jgateway
from kubeoperator_tpu.scenario.engines import FakePagedEngine, fake_row
from kubeoperator_tpu.telemetry import flight as jflight
from kubeoperator_tpu.telemetry import metrics as jmetrics
from kubeoperator_tpu.workloads import serving as jserving
from kubeoperator_tpu.workloads.generate import generate as jgenerate
from kubeoperator_tpu_torch.cluster import PrefillWorker, aligned_prefix
from kubeoperator_tpu_torch.cluster import gateway as tgateway
from kubeoperator_tpu_torch.telemetry import flight as tflight
from kubeoperator_tpu_torch.telemetry import metrics as tmetrics
from kubeoperator_tpu_torch.telemetry.serve_trace import (
    ServeTracer, ServeTraceStore, critical_path, render_record,
)
from kubeoperator_tpu_torch.workloads import serving as tserving
from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
from kubeoperator_tpu_torch.workloads.generate import generate
from test_torch_bridge import jax_params, port_cfg, port_model
from test_torch_decode_loop import JCFG

torch.set_num_threads(2)

CFG = port_cfg(JCFG)
# 16 tokens = exactly 2 pages at the page size JCFG resolves to
PRE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
WAIT = 120.0
PORT = SimpleNamespace(serving=tserving, gateway=tgateway, metrics=tmetrics,
                       flight=tflight)
REF = SimpleNamespace(serving=jserving, gateway=jgateway, metrics=jmetrics,
                      flight=jflight)
# time-valued keys, left out of the comparisons
TIMED = ("latency_p50_s", "latency_p95_s", "ttft_p95_s", "tokens")


@pytest.fixture(scope="module")
def params():
    return jax_params(JCFG, seed=7)


@pytest.fixture(scope="module")
def model(params):
    return port_model(JCFG, params)


def jax_solo(params, prompt, mt):
    out = jgenerate(JCFG, jax.tree.map(jnp.asarray, params),
                    jnp.asarray([prompt], jnp.int32), mt, temperature=0.0)
    return np.asarray(out)[0].tolist()


def solo(model, prompt, mt):
    return generate(CFG, model, [prompt], mt, device="cpu")[0].tolist()


def spin(pred, msg: str) -> None:
    deadline = time.monotonic() + WAIT
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(0.001)


class Gate:
    """Holds ``engine``'s segments: while held, each ``run_segment``
    waits for one permit (``step``); ``open`` lets every segment run."""

    def __init__(self, engine):
        self.sem = threading.Semaphore(0)
        self.held = True
        seg = engine.run_segment

        def gated():
            if self.held:
                assert self.sem.acquire(timeout=WAIT), "segment gate starved"
            seg()

        engine.run_segment = gated

    def step(self, n: int = 1) -> None:
        self.sem.release(n)

    def open(self) -> None:
        self.held = False
        self.sem.release(1000)


class Clients:
    """One thread per ``submit``: ``start`` a call, ``join`` every reply
    (re-raising what a call raised)."""

    def __init__(self):
        self.threads, self.out = [], {}

    def start(self, key, fn, *args, **kw):
        def run():
            try:
                self.out[key] = fn(*args, **kw)
            except Exception as e:  # noqa: BLE001 — re-raised by join
                self.out[key] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self.threads.append(t)

    def join(self) -> dict:
        for t in self.threads:
            t.join(WAIT)
            assert not t.is_alive()
        for v in self.out.values():
            if isinstance(v, Exception):
                raise v
        return self.out


def first_page_for_home(n_replicas: int, home: int, page: int = 8):
    """A first page whose sticky hash lands on ``home`` (int tuples hash
    the same in every process)."""
    i = 0
    while True:
        cand = [(i + j) % 50 + 1 for j in range(page)]
        if hash(tuple(cand)) % n_replicas == home:
            return cand
        i += 1


def fake_engine(slots: int) -> FakePagedEngine:
    return FakePagedEngine(slots=slots, segment=2, max_total=24, page=8,
                           step_s=0.0, dispatch_s=0.0, prefill_s=0.0)


def spy_sinks(batchers, sunk: list) -> None:
    """Record the labels (last prompt token) of each requeue batch a
    batcher hands its gateway, in order."""
    for b in batchers:
        sink = b.requeue_sink
        b.requeue_sink = (lambda reqs, sink=sink: (
            sunk.append([r.prompt_ids[-1] for r in reqs]), sink(reqs)))


def plain(snap: dict) -> dict:
    return {k: (plain(v) if isinstance(v, dict) else v)
            for k, v in snap.items() if k not in TIMED}


def metric_values(pkg) -> dict:
    m = pkg.metrics
    return {"preempted": m.SERVE_PREEMPTIONS.value(tenant="bat"),
            "shed_rate": m.SERVE_SHED.value(tenant="bat", reason="rate"),
            "shed_deadline": m.SERVE_SHED.value(tenant="bat",
                                                reason="deadline"),
            "routed_requeue": m.GATEWAY_ROUTED.value(replica="1",
                                                     policy="requeue")}


def choreography(pkg) -> dict:
    """The script, through ``pkg``'s batcher and gateway; what it saw."""
    rec: dict = {}
    pkg.flight.FLIGHT.clear()
    before = metric_values(pkg)
    Pending = pkg.serving._Pending

    # -- (a) two replicas: drain replica 0 mid-decode, readmit, inject,
    # an unknown model
    engines = [fake_engine(4) for _ in range(2)]
    gates = [Gate(e) for e in engines]
    gates[1].open()
    bs = [pkg.serving.ContinuousBatcher(e, stats=pkg.serving.BatcherStats())
          for e in engines]
    gw = pkg.gateway.ServeGateway(bs, policy="sticky_prefix")
    sunk: list = []
    spy_sinks(bs, sunk)
    home0 = first_page_for_home(2, 0)
    cl = Clients()
    reqs = [(home0 + [20 + i], 15) for i in range(3)]
    cl.start(0, gw.submit, *reqs[0], timeout=WAIT)
    spin(lambda: len(bs[0]._track) == 1, "request 0 in flight")
    for i in (1, 2):
        cl.start(i, gw.submit, *reqs[i], timeout=WAIT)
        spin(lambda i=i: len(bs[0]._queue) == i, f"request {i} queued")
    gates[0].step()
    spin(lambda: len(bs[0]._track) == 3, "three rows in flight")
    rec["before_drain"] = (bs[0].backlog(), bs[0].free_slots(),
                           [(s, r.prompt_ids[-1])
                            for s, r in bs[0].preemptible("latency")])
    cl.start("drain", gw.drain_replica, 0, reason="slice_revoked")
    spin(lambda: len(bs[0]._ctl) == 1, "the drain handshake")
    gates[0].step()
    got = cl.join()
    rec["drained"] = len(got["drain"])
    rec["sunk"] = list(sunk)
    for i, (p, mt) in enumerate(reqs):
        assert got[i] == [int(x) for x in fake_row(p, len(p) + mt)]
    rec["drained_snapshot"] = gw.snapshot()
    gw.readmit_replica(0)
    gates[0].open()
    rec["after_readmit"] = gw.submit(home0 + [99], 4, timeout=WAIT)
    injected = [Pending([5, 6, 7], 3, 0.0, 0), Pending([8, 9], 2, 0.0, 0)]
    bs[1].inject(list(reversed(injected)), front=True)
    for r in injected:
        assert r.done.wait(WAIT)
    rec["injected"] = [r.result for r in injected]
    with pytest.raises(pkg.gateway.UnknownModelError) as err:
        gw.submit([1, 2, 3], 2, model="nope")
    rec["unknown"] = (err.value.model, err.value.available)
    rec["gateway"] = gw.snapshot()
    rec["stats"] = plain(gw.stats.snapshot())
    rec["replicas"] = [plain(b.stats.snapshot()) for b in bs]
    rec["ttft_count"] = gw.stats.ttft_histogram()[2]

    # -- (b) QoS over one replica of two slots: a latency request preempts
    # the newest batch-class row, then two batch submits are shed
    eng = fake_engine(2)
    gate = Gate(eng)
    b = pkg.serving.ContinuousBatcher(eng, stats=pkg.serving.BatcherStats())
    tenants = {"bat": {"priority": "batch", "rate": 0.001, "burst": 1.0},
               "lat": {"priority": "latency"}}
    qgw = pkg.gateway.ServeGateway([b], tenants=tenants, shed_after=3)
    qsunk: list = []
    spy_sinks([b], qsunk)
    cl = Clients()
    batch = [(home0 + [30 + i], 15) for i in range(2)]
    cl.start("b0", qgw.submit, *batch[0], tenant="bat", timeout=WAIT)
    spin(lambda: len(b._track) == 1, "batch row 0 in flight")
    cl.start("b1", qgw.submit, *batch[1], tenant="bat", timeout=WAIT)
    spin(lambda: len(b._queue) == 1, "batch row 1 queued")
    gate.step()
    spin(lambda: len(b._track) == 2, "both batch rows in flight")
    rec["preemptible"] = [(s, r.prompt_ids[-1])
                          for s, r in b.preemptible("batch")]
    rec["free_slots"] = b.free_slots()
    lat = ([7, 7, 7, 41], 6)
    cl.start("lat", qgw.submit, *lat, tenant="lat", timeout=WAIT)
    spin(lambda: len(b._ctl) == 1, "the preempt handshake")
    gate.step()
    spin(lambda: len(b._queue) == 2, "the victim and the latency request")
    rec["queue_after_preempt"] = [r.prompt_ids[-1] for r in b._queue]
    sheds = []
    for kw in ({}, {"deadline_s": 1e-3}):
        with pytest.raises(pkg.gateway.ShedError) as err:
            qgw.submit(home0 + [60], 4, tenant="bat", **kw)
        sheds.append((err.value.tenant, err.value.reason,
                      err.value.retry_after_s > 0))
    rec["sheds"] = sheds
    gate.open()
    got = cl.join()
    for key, (p, mt) in (("b0", batch[0]), ("b1", batch[1]), ("lat", lat)):
        assert got[key] == [int(x) for x in fake_row(p, len(p) + mt)], key
    spin(lambda: b.backlog() == 0, "the pool drained")
    rec["qsunk"] = list(qsunk)
    rec["qos"] = qgw.snapshot()
    rec["tenants"] = plain(qgw.tenant_snapshot())
    rec["qos_stats"] = plain(b.stats.snapshot())
    rec["decisions"] = [(d["kind"], d.get("reason"), d.get("tenant"))
                        for d in pkg.flight.FLIGHT._decisions]
    after = metric_values(pkg)
    rec["metrics"] = {k: after[k] - before[k] for k in after}
    return rec


def test_levers_and_gateway_match_the_reference_on_one_choreography():
    """The same script through both packages: the drain's victims leave
    through the sink oldest first and finish on replica 1 under the
    ``requeue`` label, the preempt takes the newest batch row, whose
    re-route puts it at the queue's head before the latency request, the
    sheds carry ``rate`` and ``deadline`` with a positive retry-after,
    the unknown model names the fleet, and the snapshots, counters,
    metrics and flight decisions agree."""
    want = choreography(REF)
    got = choreography(PORT)
    assert got == want
    assert got["sunk"] == [[20, 21, 22]] and got["drained"] == 3
    assert got["qsunk"] == [[31]]
    assert got["queue_after_preempt"] == [31, 41]
    assert got["sheds"] == [("bat", "rate", True), ("bat", "deadline", True)]
    assert got["unknown"] == ("nope", ["default@v0"])
    assert got["metrics"] == {"preempted": 1.0, "shed_rate": 1.0,
                              "shed_deadline": 1.0, "routed_requeue": 3.0}
    assert got["stats"]["requests_requeued_total"] == 3
    assert got["qos"]["preempted_total"] == 1
    assert got["qos"]["shed_total"] == 2


def test_gateway_gives_jax_tokens_on_real_engines(params, model):
    """Two port ``SlotPoolEngine`` replicas behind the port's gateway
    (sticky prefix): greedy tokens equal the JAX ``generate()``'s."""
    bs = [tserving.ContinuousBatcher(
        SlotPoolEngine(CFG, model, slots=2, segment=3, device="cpu"),
        stats=tserving.BatcherStats()) for _ in range(2)]
    gw = tgateway.ServeGateway(bs, policy="sticky_prefix")
    reqs = [(PRE + [11, 12], 6), ([1, 2, 3, 4, 5], 6), (PRE + [13], 7),
            ([7, 8, 9, 10, 11, 12, 13, 14], 5)]
    cl = Clients()
    for i, (p, mt) in enumerate(reqs):
        cl.start(i, gw.submit, p, mt, timeout=WAIT)
    got = cl.join()
    for i, (p, mt) in enumerate(reqs):
        assert got[i] == jax_solo(params, p, mt), f"request {i}"
    assert gw.stats.snapshot()["requests_total"] == len(reqs)


def test_page_handoff_between_port_engines(params, model):
    """``PrefillWorker.prefill`` on one port engine exports two whole
    pages, ``import_prefix`` lands them in another (once: a covered
    prefix imports nothing), and the decode over them is a prefix hit with
    the JAX tokens; through a traced gateway with the worker attached the
    same prompt is handed off once, admitted as a hit, and its tree holds
    the ``handoff`` span, its critical path tiling its duration."""
    worker = PrefillWorker(SlotPoolEngine(CFG, model, slots=2, segment=3,
                                          device="cpu"))
    payload = worker.prefill(PRE)
    assert payload["pages"] == 2 and len(payload["layers"]) == CFG.n_layers
    for kp, vp in payload["layers"]:
        assert kp.shape == vp.shape == (2, 8, 4, 8)
    dst = SlotPoolEngine(CFG, model, slots=2, segment=3, device="cpu")
    assert dst.import_prefix(payload["tokens"], payload["layers"]) == 2
    assert dst.import_prefix(payload["tokens"], payload["layers"]) == 0
    prompt, mt = PRE + [11, 12], 6
    pos = dst.admit([(0, prompt, mt, 0.0, 0)])[0]
    assert dst.prefix_hits == 1
    while pos < len(prompt) + mt - 1:
        dst.run_segment()
        pos = min(pos + dst.segment, len(prompt) + mt - 1)
    buf, _ = dst.poll()
    want = jax_solo(params, prompt, mt)
    assert buf[0][:len(prompt) + mt].tolist() == want

    store = ServeTraceStore()
    engines = [SlotPoolEngine(CFG, model, slots=2, segment=3, device="cpu")
               for _ in range(2)]
    bs = [tserving.ContinuousBatcher(e, stats=tserving.BatcherStats())
          for e in engines]
    gw = tgateway.ServeGateway(bs, prefill_worker=PrefillWorker(
        SlotPoolEngine(CFG, model, slots=1, segment=3, device="cpu")),
        tracer=ServeTracer(store))
    assert gw.submit(prompt, mt, timeout=WAIT) == want
    assert gw.submit(aligned_prefix(prompt, 8) + [42], 3,
                     timeout=WAIT) == jax_solo(params, PRE + [42], 3)
    assert gw.snapshot()["handoff_pages"] == 2
    assert sum(e.prefix_hits for e in engines) == 2
    rec = render_record(store.records()[0])
    names = [s["name"] for s in rec["spans"]]
    assert {"gateway", "handoff", "enqueue", "admit", "retire"} <= set(names)
    admit = next(s for s in rec["spans"] if s["name"] == "admit")
    assert admit["attributes"]["hit_kind"] in ("cover", "partial")
    cp = critical_path(rec)
    assert cp["phases"]["handoff"] > 0
    assert sum(cp["phases"].values()) + cp["unattributed"] \
        == pytest.approx(cp["duration_s"], abs=1e-5)


def test_drain_and_preempt_keep_rows_bit_identical(model):
    """Real port engines: rows drained off replica 0 mid-decode finish on
    replica 1, and a batch row preempted by a latency request re-prefills
    and finishes, each with the tokens of its solo ``generate()``."""
    home0 = first_page_for_home(2, 0)
    engines = [SlotPoolEngine(CFG, model, slots=2, segment=2, device="cpu")
               for _ in range(2)]
    gate = Gate(engines[0])
    bs = [tserving.ContinuousBatcher(e, stats=tserving.BatcherStats())
          for e in engines]
    gw = tgateway.ServeGateway(bs, policy="sticky_prefix")
    reqs = [(home0 + [20 + i], 10) for i in range(2)]
    cl = Clients()
    cl.start(0, gw.submit, *reqs[0], timeout=WAIT)
    spin(lambda: len(bs[0]._track) == 1, "request 0 in flight")
    cl.start(1, gw.submit, *reqs[1], timeout=WAIT)
    spin(lambda: len(bs[0]._queue) == 1, "request 1 queued")
    gate.step()
    spin(lambda: len(bs[0]._track) == 2, "both rows in flight")
    cl.start("drain", gw.drain_replica, 0)
    spin(lambda: len(bs[0]._ctl) == 1, "the drain handshake")
    gate.step()
    got = cl.join()
    assert len(got["drain"]) == 2
    for i, (p, mt) in enumerate(reqs):
        assert got[i] == solo(model, p, mt), f"drained request {i}"
    assert gw.snapshot()["routed"]["1"]["requeue"] == 2

    eng = SlotPoolEngine(CFG, model, slots=2, segment=2, device="cpu")
    gate = Gate(eng)
    b = tserving.ContinuousBatcher(eng, stats=tserving.BatcherStats())
    qgw = tgateway.ServeGateway([b], tenants={
        "bat": {"priority": "batch"}, "lat": {"priority": "latency"}})
    batch = [(PRE + [30], 6), ([5, 6, 7, 8, 9], 10)]
    cl = Clients()
    cl.start(0, qgw.submit, *batch[0], tenant="bat", timeout=WAIT)
    spin(lambda: len(b._track) == 1, "batch row 0 in flight")
    cl.start(1, qgw.submit, *batch[1], tenant="bat", timeout=WAIT)
    spin(lambda: len(b._queue) == 1, "batch row 1 queued")
    gate.step()
    spin(lambda: len(b._track) == 2, "both batch rows in flight")
    lat = ([1, 2, 3], 8)
    cl.start("lat", qgw.submit, *lat, tenant="lat", timeout=WAIT)
    spin(lambda: len(b._ctl) == 1, "the preempt handshake")
    gate.open()
    got = cl.join()
    for key, (p, mt) in ((0, batch[0]), (1, batch[1]), ("lat", lat)):
        assert got[key] == solo(model, p, mt), key
    assert qgw.snapshot()["preempted_total"] == 1
    assert b.stats.snapshot()["requests_requeued_total"] == 1
