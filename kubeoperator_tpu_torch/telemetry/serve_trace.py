"""Per-request span trees for the serving data plane, the counterpart of
``kubeoperator_tpu/telemetry/serve_trace.py``: the same spans, parents,
attribute keys, ring and critical-path sweep, copied so the port imports
nothing of the JAX package.

``ContinuousBatcher`` calls a ``ServeTracer`` (when one is wired: tracing
is opt-in, and off it costs one ``is None`` test a hook) at the
scheduling edges it already owns: submit, admission, segment advance and
retirement. Each request becomes one ``tracing.Trace`` whose tree is

    request
    ├── enqueue            (submit → admission pick)
    ├── admit              (the admission wave; slot/shard/pages/hit_kind)
    │   └── prefill        (only when the prefix cache did NOT cover it)
    ├── segment ×N         (one per decode-segment dispatch touching it)
    └── retire             (device_s / host_blocked_s attribution)

The cluster tier stitches into the SAME tree: a gateway-minted
``RequestTrace`` (``gateway=True``) opens a ``gateway``-kind span at
submit that closes at dispatch (admission and fair-queue wait),
token-bucket and deadline sheds end the tree with a ``shed`` span,
prefill handoffs post a ``handoff`` span, and every preempt or drain
eviction opens a ``hop``-kind span that the NEXT admission closes, so one
request's journey across gateway → prefill worker → decode replicas is
one connected tree under one trace id. ``critical_path`` decomposes that
tree's wall time into exclusive phases (gateway wait, replica queue,
admit, prefill, handoff, decode, host-blocked, requeue hops) that tile
the root span exactly.

All spans are annotated from values the batcher already holds on the
host (admission plans, segment wall times, the retirement fetch), so
tracing adds no device read or launch to the decode loop. Spans past
``max_spans`` hit the trace's dropped counter. The root and enqueue spans
are recorded at ``begin`` and mutated in place until the tree is
serialized, so a long generation that overflows the cap loses trailing
``segment``/``retire`` spans, never the request root.

Completed trees persist as ``TraceRecord``s (``name`` = request id,
``operation`` = "serve") into a bounded per-process ring,
``ServeTraceStore`` (``SERVE_TRACES`` by default). The port's serve job
wires a tracer into its continuous batcher as the reference's does and,
like it, serves no route for the ring.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any

from kubeoperator_tpu_torch.telemetry.tracing import (
    DEFAULT_MAX_SPANS, Span, Trace, TraceRecord,
)

#: completed request traces kept per process — small: the ring answers
#: "which recent request stalled where", not long-term storage
DEFAULT_MAX_RECORDS = 256


class ServeTraceStore:
    """Bounded ring of recent serve ``TraceRecord``s keyed by request id
    (insertion-ordered; adding past ``max_records`` evicts the oldest and
    increments ``evicted`` — the ring-level analogue of a trace's dropped
    counter)."""

    def __init__(self, max_records: int = DEFAULT_MAX_RECORDS):
        self.max_records = max(1, int(max_records))
        self.evicted = 0
        self._lock = threading.Lock()
        self._records: OrderedDict[str, TraceRecord] = OrderedDict()

    def add(self, record: TraceRecord) -> None:
        with self._lock:
            self._records.pop(record.name, None)
            self._records[record.name] = record
            while len(self._records) > self.max_records:
                self._records.popitem(last=False)
                self.evicted += 1

    def get(self, request_id: str) -> TraceRecord | None:
        with self._lock:
            return self._records.get(request_id)

    def records(self) -> list[TraceRecord]:
        """Newest last (insertion order), a snapshot."""
        with self._lock:
            return list(self._records.values())

    def slowest(self, n: int) -> list[TraceRecord]:
        """The ``n`` records with the longest root-span duration."""
        return sorted(self.records(), key=_root_duration, reverse=True)[:n]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.evicted = 0


def _root_duration(rec: TraceRecord) -> float:
    for s in rec.spans:
        if not s.get("parent_id"):
            return float(s.get("duration_s") or 0.0)
    return 0.0


#: the per-process ring: the serve job's batcher writes here through the
#: default ``ServeTracer``
SERVE_TRACES = ServeTraceStore()


class RequestTrace:
    """One in-flight request's span tree — the handle the batcher stashes
    on its ``_Pending`` record. Only the batcher's worker thread calls the
    mutating methods after ``ServeTracer.begin`` (same single-writer
    contract as the slot tracker), so no lock beyond the ``Trace``'s own
    span-list lock is needed."""

    def __init__(self, request_id: str, store: ServeTraceStore,
                 max_spans: int, prompt_len: int, max_tokens: int,
                 gateway: bool = False, tenant: str | None = None,
                 priority: str | None = None):
        self.store = store
        self.trace = Trace(request_id, max_spans=max_spans)
        attrs: dict[str, Any] = {"prompt_len": prompt_len,
                                 "max_tokens": max_tokens}
        if tenant is not None:
            attrs["tenant"] = tenant
        if priority is not None:
            attrs["priority"] = priority
        self.root = Span("request", "serve", self.trace, attributes=attrs)
        # recorded up-front (records hold live Span objects; durations land
        # via finish() before serialization) so cap overflow can only drop
        # later segment/retire spans, never the request root
        self.trace.record(self.root)
        self.queue_span: Span | None = None
        self.gateway_span: Span | None = None
        self.hop_span: Span | None = None
        if gateway:
            # gateway-minted context: the live gateway span covers
            # admission + fair-queue wait until ``dispatched`` closes it
            # and opens the replica-level enqueue span in its place
            self.gateway_span = Span("gateway", "gateway", self.trace,
                                     parent_id=self.root.span_id)
            self.trace.record(self.gateway_span)
        else:
            self.queue_span = Span("enqueue", "serve", self.trace,
                                   parent_id=self.root.span_id)
            self.trace.record(self.queue_span)
        self.segments = 0

    # -- span helpers --------------------------------------------------------
    def _post_span(self, name: str, parent_id: str, dur_s: float,
                   attrs: dict) -> Span:
        """A span whose work already happened: shift its start back by the
        measured duration so the sorted timeline reads correctly."""
        sp = Span(name, "serve", self.trace, parent_id=parent_id,
                  attributes=attrs)
        sp.start_offset_s = round(sp._t0 - dur_s - self.trace.t0, 6)
        sp.duration_s = round(dur_s, 6)
        self.trace.record(sp)
        return sp

    # -- gateway edges -------------------------------------------------------
    def dispatched(self, *, replica: int | str,
                   decision: str | None = None) -> float | None:
        """The gateway picked a replica and injected the request. Closes
        the live gateway span (its duration IS the gateway queue wait,
        returned so the dispatch site can feed the wait histogram) and
        opens the replica-level enqueue span. A re-dispatch after a hop
        (requeue batch re-routed to a healthy replica) only notes a
        ``reroute`` event — the hop span already covers the gap."""
        if self.gateway_span is None:
            self.root.add_event("reroute", replica=replica,
                                decision=decision)
            return None
        gs = self.gateway_span
        gs.attributes["replica"] = replica
        if decision is not None:
            gs.attributes["decision"] = decision
        gs.finish()
        self.gateway_span = None
        self.queue_span = Span("enqueue", "serve", self.trace,
                               parent_id=self.root.span_id)
        self.trace.record(self.queue_span)
        return gs.duration_s

    def shed(self, *, reason: str, retry_after_s: float = 0.0) -> None:
        """Terminal gateway rejection (token bucket, queue depth or an
        expired deadline): the tree still records, ending in a ``shed``
        span so a shed request's trace is queryable like any other."""
        if self.gateway_span is not None:
            self.gateway_span.attributes["decision"] = "shed"
            self.gateway_span.finish()
            self.gateway_span = None
        sp = Span("shed", "gateway", self.trace,
                  parent_id=self.root.span_id, attributes={
                      "reason": reason,
                      "retry_after_s": round(float(retry_after_s), 6)})
        sp.finish()
        self.trace.record(sp)
        self.root.status = "shed"
        self._finish()

    def hop_begin(self, *, reason: str,
                  from_replica: int | str | None = None) -> None:
        """The request was evicted mid-flight (preempt or drain) and is
        heading back through the requeue path. The live hop span stays
        open until the NEXT admission closes it — its duration is the
        eviction→readmission gap the critical path charges to ``hop``."""
        if self.hop_span is not None:
            return                       # already hopping (drain of a drain)
        attrs: dict[str, Any] = {"reason": reason}
        if from_replica is not None:
            attrs["from_replica"] = from_replica
        self.hop_span = Span("hop", "hop", self.trace,
                             parent_id=self.root.span_id, attributes=attrs)
        self.trace.record(self.hop_span)

    def handoff(self, *, pages: int, seconds: float,
                replica: int | str | None = None) -> None:
        """Disagg prefill export/import: the prefill worker ran the
        prompt and the decode replica imported the KV pages."""
        attrs: dict[str, Any] = {"pages": int(pages)}
        if replica is not None:
            attrs["replica"] = replica
        sp = self._post_span("handoff", self.root.span_id,
                             float(seconds), attrs)
        sp.kind = "gateway"

    # -- batcher edges -------------------------------------------------------
    def admitted(self, *, slot: int, shard: int, wave_s: float,
                 plan: dict | None,
                 replica: int | str | None = None) -> None:
        if self.queue_span is not None:
            self.queue_span.finish()
            self.queue_span = None
        if self.hop_span is not None:    # readmission closes the hop
            self.hop_span.finish()
            self.hop_span = None
        attrs: dict[str, Any] = {"slot": slot, "shard": shard}
        if replica is not None:
            # which gateway replica admitted this request — a re-routed
            # request grows a second admit span stamped with its new home,
            # so the TTFT decomposition can split gateway-level queueing
            # (between stamps) from replica-level queueing
            attrs["replica"] = replica
        prefilled = True
        if plan:
            attrs.update(
                pages=plan.get("pages"), bucket=plan.get("bucket"),
                hit_kind=plan.get("hit_kind"), pos0=plan.get("pos0"),
                pages_reused=plan.get("pages_reused"),
                hit_len=plan.get("hit_len"))
            # full/cover hits restart from cached pages — no prefill pass
            prefilled = plan.get("hit_kind") in (None, "miss", "partial")
        admit = self._post_span("admit", self.root.span_id, wave_s, attrs)
        if prefilled:
            chunk = {"start": 0, "stop": attrs.get("bucket")}
            if plan:
                chunk = {"start": plan.get("hit_len", 0),
                         "stop": plan.get("bucket")}
            self._post_span("prefill", admit.span_id, wave_s, chunk)

    def segment(self, seg_s: float, *, pos: int, k: int, shard: int) -> None:
        self.segments += 1
        self._post_span("segment", self.root.span_id, seg_s, {
            "index": self.segments, "pos": pos, "k": k, "shard": shard})

    def compile_event(self, n: int) -> None:
        self.root.add_event("compile", n=n)

    def aot_event(self, *, hit: bool, seconds: float) -> None:
        """The engine's AOT-cache bring-up outcome, noted on the first
        in-flight requests: ``hit`` means the segment executable was
        deserialized (zero compiles); a miss pairs with a compile event."""
        self.root.add_event("aot", hit=bool(hit),
                            seconds=round(float(seconds), 6))

    def ttft(self, seconds: float) -> None:
        self.root.attributes["ttft_s"] = round(seconds, 6)

    def retire(self, *, blocked_s: float, device_s: float | None,
               shard: int, tokens: int) -> None:
        attrs: dict[str, Any] = {"shard": shard, "tokens": tokens,
                                 "host_blocked_s": round(blocked_s, 6)}
        if device_s is not None:
            attrs["device_s"] = round(device_s, 6)
        self._post_span("retire", self.root.span_id, blocked_s, attrs)
        self._finish()

    def fail(self, err: Exception) -> None:
        self.root.status = "error"
        self.root.attributes["error"] = f"{type(err).__name__}: {err}"
        self._finish()

    def _finish(self) -> None:
        if self.gateway_span is not None:    # failed before dispatch
            self.gateway_span.finish()
            self.gateway_span = None
        if self.queue_span is not None:      # failed before admission
            self.queue_span.finish()
            self.queue_span = None
        if self.hop_span is not None:        # failed mid-hop
            self.hop_span.finish()
            self.hop_span = None
        self.root.finish()
        self.store.add(TraceRecord(
            name=self.trace.trace_id, operation="serve",
            spans=self.trace.to_dicts(), dropped=self.trace.dropped))


class ServeTracer:
    """Factory the batcher holds: ``begin(req)`` opens a ``RequestTrace``
    into ``store``. ``max_spans`` is the reference's ``trace_max_spans``
    (the serve job reads ``KO_TRACE_MAX_SPANS``, default 4000)."""

    def __init__(self, store: ServeTraceStore | None = None,
                 max_spans: int = DEFAULT_MAX_SPANS):
        self.store = store if store is not None else SERVE_TRACES
        self.max_spans = max_spans

    def begin(self, request_id: str, *, prompt_len: int,
              max_tokens: int, gateway: bool = False,
              tenant: str | None = None,
              priority: str | None = None) -> RequestTrace:
        return RequestTrace(request_id, self.store, self.max_spans,
                            prompt_len, max_tokens, gateway=gateway,
                            tenant=tenant, priority=priority)


#: span name → critical-path phase, highest-specificity first: where two
#: spans of different phases overlap in time, the EARLIER entry here wins
#: the overlap (prefill inside its admit wave is charged to prefill, a
#: segment overlapping the retire fetch is charged to decode, …)
_PHASE_ORDER = (
    ("prefill", "prefill"),
    ("handoff", "handoff"),
    ("admit", "admit"),
    ("segment", "decode"),
    ("retire", "host_blocked"),
    ("hop", "hop"),
    ("enqueue", "replica_queue"),
    ("gateway", "gateway_wait"),
    ("shed", "shed"),
)


def critical_path(payload: dict) -> dict:
    """Attribute one stitched trace's end-to-end latency to exclusive
    phases. ``payload`` is a rendered record (``render_record`` / the
    ``--json`` wire shape). An interval sweep over the root's timeline
    charges every instant to the highest-priority span covering it (see
    ``_PHASE_ORDER``); uncovered time is reported as ``unattributed`` —
    so the phases plus the remainder tile ``duration_s`` exactly."""
    spans = payload.get("spans") or []
    root = next((s for s in spans if not s.get("parent_id")), None)
    if root is None:
        return {"request": payload.get("request"), "duration_s": 0.0,
                "phases": {}, "unattributed": 0.0}
    r0 = float(root.get("start_offset_s") or 0.0)
    r1 = r0 + float(root.get("duration_s") or 0.0)
    prio = {name: i for i, (name, _) in enumerate(_PHASE_ORDER)}
    ivals = []                       # (start, end, priority) clipped to root
    for s in spans:
        p = prio.get(s.get("name"))
        if p is None:
            continue
        a = max(r0, float(s.get("start_offset_s") or 0.0))
        b = min(r1, a + float(s.get("duration_s") or 0.0))
        if b > a:
            ivals.append((a, b, p))
    cuts = sorted({r0, r1} | {x for a, b, _ in ivals for x in (a, b)})
    acc = {phase: 0.0 for _, phase in _PHASE_ORDER}
    unattributed = 0.0
    for a, b in zip(cuts, cuts[1:]):
        covering = [p for ia, ib, p in ivals if ia <= a and b <= ib]
        if covering:
            acc[_PHASE_ORDER[min(covering)][1]] += b - a
        else:
            unattributed += b - a
    phases = {k: round(v, 6) for k, v in acc.items() if v > 0}
    return {
        "request": payload.get("request"),
        "duration_s": round(r1 - r0, 6),
        "status": root.get("status", "ok"),
        "ttft_s": (root.get("attributes") or {}).get("ttft_s"),
        "phases": phases,
        "unattributed": round(unattributed, 6),
    }


def render_record(rec: TraceRecord) -> dict:
    """The wire/JSON shape of one record, the reference's (schema v1 —
    the span dicts are ``Span.to_dict``)."""
    root = next((s for s in rec.spans if not s.get("parent_id")), None)
    return {
        "version": 1,
        "request": rec.name,
        "operation": rec.operation,
        "duration_s": float(root.get("duration_s", 0.0)) if root else 0.0,
        "spans": rec.spans,
        "dropped": rec.dropped,
    }
