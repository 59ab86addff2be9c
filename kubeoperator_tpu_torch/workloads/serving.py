"""Request batching for the token-generation endpoint, the counterpart of
``kubeoperator_tpu/workloads/serving.py``: two engines.

``DynamicBatcher`` (run-to-completion fusion): concurrent ``/generate``
requests queue here; a single worker drains up to ``max_batch`` of them
(waiting ``window_ms`` after the first arrival for company), right-pads
prompts into one batch, and runs ONE batched generation with per-row
prompt lengths (``generate.py``). Each reply slices its own row. Batch,
padded prompt length and new-token count are rounded up to powers of two
and the prefill chunk down to one (``plan_bucket``), as the reference
does to bound its compiles. Requests with different temperatures never
fuse.

``ContinuousBatcher`` (in-flight batching) drives the paged slot-pool
engine (``decode_loop.SlotPoolEngine``): requests are admitted into free
decode slots between fixed K-token segments, each row stops at exactly
its own ``prompt_len + max_tokens``, finished slots retire with one
batched fetch, and mixed temperatures co-batch (the engine samples per
row). Admission reserves KV pages, FIFO, with head-of-line backpressure,
counting the pages the engine's prefix cache could evict as free. The
engine's prefix-cache hits, demotions and promotions reach the
``ko_serve_prefix_hits_total``, ``ko_serve_kv_demotions_total`` and
``ko_serve_kv_promoted_hits_total`` counters and its spill-tier pages the
``ko_serve_kv_spill_pages`` gauge. A speculative engine's draft and
accept counts reach ``ko_serve_spec_*``, an MoE engine's per-expert load
``ko_serve_moe_expert_load``.

Both engines report through ``BatcherStats``, whose ``ko_serve_*``
families live in a ``telemetry.metrics`` registry (private per batcher by
default; the serve job passes its one registry so ``/metrics`` is one
scrape).

The continuous batcher also carries the reference's request tracer
(``tracer=``, ``telemetry/serve_trace.py``), per-shard accounting over a
serving mesh's dp shards, and the cluster tier's levers (``drain``,
``preempt``, ``preemptible``, ``free_slots``, ``backlog``, ``readmit``,
``inject``, ``handoff``, ``requeue_sink``, ``replica``), which
``cluster.ServeGateway`` and ``cluster.PrefillWorker`` drive. Only the
paged engine exists in the port, so the reference's paths for engines
without page accounting are left out.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from kubeoperator_tpu_torch.analysis.compile_guard import active_guard
from kubeoperator_tpu_torch.telemetry import metrics as tm


def short_id(n: int = 8) -> str:
    return uuid.uuid4().hex[:n]


def _pow2_at_least(n: int, floor: int = 1) -> int:
    v = max(floor, 1)
    while v < n:
        v *= 2
    return v


def _pow2_at_most(n: int) -> int:
    v = 1
    while v * 2 <= n:
        v *= 2
    return v


def plan_bucket(lens: Sequence[int], max_tokens: Sequence[int],
                max_seq_len: int) -> tuple[int, int, int]:
    """(prompt_bucket, new_bucket, prefill) for one executed batch — THE
    bucketing rule, shared by the execution path and the serve job's
    ``--warm`` so a warmed bucket is exactly the one real traffic lands
    in (including the shed-padding fallbacks near max_seq_len)."""
    p_bucket = _pow2_at_least(max(lens), 8)
    new_bucket = _pow2_at_least(max(max_tokens))
    if p_bucket + new_bucket > max_seq_len:
        # shed padding before shedding fusion: exact sizes always fit
        # (submit / _run_group guarantee it per executed batch)
        p_bucket = _pow2_at_least(max(lens), 1)
    if p_bucket + new_bucket > max_seq_len:
        new_bucket = max(max_tokens)
    if p_bucket + new_bucket > max_seq_len:
        p_bucket = max(lens)
    return p_bucket, new_bucket, _pow2_at_most(min(lens))


#: process-wide admission order: ``time.monotonic`` ties on coarse
#: clocks, so every requeue sort uses (submitted_at, seq) — two victims
#: drained in the same tick re-route deterministically instead of in
#: container order
_SEQ = itertools.count()
_SEQ_LOCK = threading.Lock()


@dataclass
class _Pending:
    prompt_ids: list[int]
    max_tokens: int
    temperature: float
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    result: list[int] | None = None
    error: Exception | None = None
    submitted_at: float = -1.0
    # request identity for serve traces; the trace handle is a
    # telemetry.serve_trace.RequestTrace when the batcher (or the
    # gateway) was built with a tracer, else None (tracing off)
    id: str = field(default_factory=lambda: short_id(12))
    trace: Any = None
    # multi-tenant QoS: identity and class stamped by the gateway's
    # admission; the batcher treats them as labels, except that the
    # gateway preempts only ``batch``-class victims
    tenant: str = "default"
    priority: str = "latency"
    deadline_s: float | None = None
    # the gateway's replica-group selector, carried so requeue victims
    # re-route inside their own group; None = the single-group fleet
    model: str | None = None
    # first-token latency stamped by the worker at the TTFT observation,
    # so the gateway can aggregate TTFT per tenant
    ttft_s: float | None = None
    seq: int = -1

    def __post_init__(self) -> None:
        # both stamps under one lock: independently evaluated field
        # factories let two racing submits interleave the clock read and
        # the counter bump, giving inverted (submitted_at, seq) pairs that
        # make the requeue sort disagree with admission order
        if self.seq < 0:
            with _SEQ_LOCK:
                stamp = time.monotonic()
                if self.submitted_at < 0:
                    self.submitted_at = stamp
                self.seq = next(_SEQ)


class BatcherStats:
    """Serving observability for both batcher engines, backed by the
    ``telemetry.metrics`` registry: counters, the per-dispatch batch-size
    histogram, a sliding-window latency summary (p50/p95), plus the
    continuous engine's slot-occupancy and KV-page gauges, TTFT and
    segment-duration histograms. Exported as JSON (``snapshot``, the
    reference's keys) and Prometheus text (``prometheus``).

    Each instance owns a private ``Registry`` unless one is passed —
    independent batchers (and tests) must not share counters.
    """

    def __init__(self, window: int = 512, registry: tm.Registry | None = None):
        self._lock = threading.Lock()
        self.registry = registry if registry is not None else tm.Registry()
        self._m = tm.declare_serve_metrics(self.registry, window=window)

    def enqueued(self) -> None:
        self._m["queue_depth"].inc()

    def executed(self, batch_size: int) -> None:
        self._m["batches"].inc()
        self._m["batch_size"].observe(batch_size)

    def finished(self, req: _Pending, ok: bool) -> None:
        with self._lock:   # clamp at 0 needs read-modify-write
            depth = self._m["queue_depth"].value()
            self._m["queue_depth"].set(max(0.0, depth - 1))
        self._m["requests"].inc()
        if ok:
            # the tokens this request actually received (its result is
            # sliced to prompt + max_tokens), not the pow2 bucket the
            # fused batch decoded at
            self._m["tokens"].inc(req.max_tokens)
        else:
            self._m["errors"].inc()
        self._m["latency"].observe(time.monotonic() - req.submitted_at)

    # -- continuous-engine hooks -------------------------------------------
    def occupancy(self, slots_busy: int, shard: int | str = 0) -> None:
        """Occupied slots on one dp mesh shard (shard 0 is the whole pool
        on one device)."""
        self._m["slot_occupancy"].set(slots_busy, shard=str(shard))

    def ttft(self, seconds: float) -> None:
        self._m["ttft"].observe(seconds)

    def segment(self, seconds: float) -> None:
        self._m["segment"].observe(seconds)

    def segment_device(self, seconds: float) -> None:
        """Device share of a segment: dispatch to the ready signal the
        retirement fetch observed (no extra sync — the fetch happens
        anyway)."""
        self._m["segment_device"].observe(seconds)

    def host_blocked(self, seconds: float, shard: int | str = 0) -> None:
        """Host-blocked share of retirement: the worker's wait inside the
        batched result fetch."""
        self._m["host_blocked"].observe(seconds, shard=str(shard))

    def pages_used(self, pages: int, shard: int | str = 0) -> None:
        """Allocated KV pages (live slots + prefix cache) on one dp mesh
        shard of the paged continuous engine."""
        self._m["kv_pages_used"].set(pages, shard=str(shard))

    def prefix_hit(self, n: int = 1) -> None:
        """Admissions that reused prefix-cached pages."""
        self._m["prefix_hits"].inc(n)

    def kv_spill_pages(self, pages: int, shard: int | str = 0) -> None:
        """KV pages parked in one dp shard's host-RAM spill tier."""
        self._m["kv_spill_pages"].set(pages, shard=str(shard))

    def kv_demotion(self, n: int = 1) -> None:
        """Prefix entries demoted from device memory into the host spill
        tier."""
        self._m["kv_demotions"].inc(n)

    def kv_promoted_hit(self, n: int = 1) -> None:
        """Admissions served by promoting a demoted prefix host->device."""
        self._m["kv_promoted_hits"].inc(n)

    def spec_tokens(self, drafted: int, accepted: int) -> None:
        """One speculative dispatch's draft/accept counts; the gauge is
        the cumulative acceptance ratio, so it converges instead of
        following each dispatch's luck."""
        if drafted:
            self._m["spec_draft"].inc(drafted)
        if accepted:
            self._m["spec_accepted"].inc(accepted)
        total = self._m["spec_draft"].value()
        if total:
            self._m["spec_acceptance"].set(
                self._m["spec_accepted"].value() / total)

    def moe_expert_load(self, loads: Sequence[float]) -> None:
        """Cumulative per-expert dispatched-token counts from the serving
        engine (``expert_load()``), one gauge sample per expert index."""
        for e, v in enumerate(loads):
            self._m["moe_expert_load"].set(float(v), expert=str(e))

    def requeued(self, reason: str, n: int = 1) -> None:
        """In-flight requests taken off drained or preempted slots and
        pushed back to the queue head (or out through a gateway's sink)
        instead of dropped, by reason (drain | preempt | ...)."""
        self._m["requeued"].inc(n, reason=reason)

    def dequeued(self, n: int = 1) -> None:
        """Requests that left this batcher's queue without finishing here
        (handed to a gateway's requeue sink for another replica): keeps
        the queue-depth gauge honest across migrations (the receiving
        batcher counts them again in ``enqueued``)."""
        with self._lock:   # clamp at 0 needs read-modify-write
            depth = self._m["queue_depth"].value()
            self._m["queue_depth"].set(max(0.0, depth - n))

    def ttft_mean(self) -> float:
        """Mean observed time-to-first-token in seconds (0.0 before any
        observation)."""
        h = self._m["ttft"]
        n = h.count()
        return h.sum() / n if n else 0.0

    def ttft_histogram(self) -> tuple[tuple[float, ...], list[int], int,
                                      float]:
        """(bucket bounds, per-bucket counts, count, sum) of the TTFT
        histogram: what a cluster gateway merges to take quantiles across
        replicas (a p95 of p95s is not a p95)."""
        h = self._m["ttft"]
        slot = h.samples().get(())
        if not slot:
            return h.buckets, [0] * len(h.buckets), 0, 0.0
        return h.buckets, list(slot["counts"]), int(slot["count"]), h.sum()

    def ttft_quantile(self, q: float = 0.95) -> float | None:
        """Upper-bound quantile over the TTFT histogram buckets, the
        in-process analog of PromQL's ``histogram_quantile``: the smallest
        bucket bound covering fraction ``q`` of observations (the largest
        finite bound when the quantile lands in +Inf), or ``None`` before
        any observation."""
        h = self._m["ttft"]
        slot = h.samples().get(())
        if not slot or not slot["count"]:
            return None
        need = q * slot["count"]
        cum = 0
        for bound, n in zip(h.buckets, slot["counts"]):
            cum += n
            if cum >= need and bound != float("inf"):
                return bound
        return h.buckets[-2]

    def snapshot(self) -> dict:
        hist = self._m["batch_size"]
        slot = hist.samples().get(())
        counts = slot["counts"] if slot else [0] * len(hist.buckets)
        batch_hist: dict = {int(b): n for b, n in zip(hist.buckets, counts)
                            if b != float("inf")}
        batch_hist["+Inf"] = counts[-1]
        return {
            "requests_total": int(self._m["requests"].value()),
            "errors_total": int(self._m["errors"].value()),
            "batches_total": int(self._m["batches"].value()),
            "tokens_generated_total": int(self._m["tokens"].value()),
            "queue_depth": int(self._m["queue_depth"].value()),
            # summed over dp shards: the pool-wide busy count
            "slot_occupancy": int(sum(
                self._m["slot_occupancy"].samples().values())),
            "kv_pages_used": int(sum(
                self._m["kv_pages_used"].samples().values())),
            "prefix_hits_total": int(self._m["prefix_hits"].value()),
            "kv_spill_pages": int(sum(
                self._m["kv_spill_pages"].samples().values())),
            "kv_demotions_total": int(self._m["kv_demotions"].value()),
            "kv_promoted_hits_total": int(
                self._m["kv_promoted_hits"].value()),
            "requests_requeued_total": int(sum(
                self._m["requeued"].samples().values())),
            "batch_size_hist": batch_hist,
            "ttft_count": int(self._m["ttft"].count()),
            "spec_draft_tokens_total": int(self._m["spec_draft"].value()),
            "spec_accepted_tokens_total": int(
                self._m["spec_accepted"].value()),
            "spec_acceptance_ratio": round(
                self._m["spec_acceptance"].value(), 4),
            "latency_p50_s": round(self._m["latency"].quantile(0.50), 4),
            "latency_p95_s": round(self._m["latency"].quantile(0.95), 4),
        }

    def prometheus(self) -> str:
        return self.registry.render()


class DynamicBatcher:
    """``submit`` blocks until the worker has generated this request's
    tokens (possibly fused with others).

    ``run_fn(prompts, prompt_lens, max_new, temperature, prefill_len,
    seed)`` executes one batched generation: prompts is a right-padded
    [B, P] list of lists, prompt_lens the true lengths, and it returns a
    [B, P + max_new] host array (row i's reply = result[i][:len_i +
    want_i]).
    """

    def __init__(self, run_fn: Callable[..., Any], *, max_batch: int = 32,
                 window_ms: float = 5.0, max_seq_len: int = 2048,
                 stats: BatcherStats | None = None):
        self.run_fn = run_fn
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.max_seq_len = max_seq_len
        self.stats = stats if stats is not None else BatcherStats()
        self._q: queue.Queue[_Pending] = queue.Queue()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="ko-serve-batcher")
        self._worker.start()

    # -- client side -------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               timeout: float | None = 300.0) -> list[int]:
        if not prompt_ids:
            raise ValueError("prompt_ids must be non-empty")
        if len(prompt_ids) + max_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt_ids)}) + max_tokens ({max_tokens}) "
                f"exceed max_seq_len ({self.max_seq_len})")
        req = _Pending(list(prompt_ids), int(max_tokens), float(temperature),
                       int(seed))
        self.stats.enqueued()
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # -- worker side -------------------------------------------------------
    def _drain(self) -> list[_Pending]:
        """One request, then whatever arrives within the window."""
        batch = [self._q.get()]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._drain()
            groups: dict[float, list[_Pending]] = {}
            for r in batch:
                groups.setdefault(r.temperature, []).append(r)
            for temp, group in groups.items():
                self._run_group(temp, group)

    def _run_group(self, temp: float, group: list[_Pending]) -> None:
        """Split a same-temperature drain into subgroups whose combined
        shape fits: max(prompt) + max(new) <= max_seq_len must hold per
        EXECUTED batch (submit validates each request alone, but a long
        prompt and a long generation from different requests can't
        co-batch)."""
        sub: list[_Pending] = []
        p_need = n_need = 0
        for r in group:
            p2, n2 = max(p_need, len(r.prompt_ids)), max(n_need, r.max_tokens)
            if sub and p2 + n2 > self.max_seq_len:
                self._execute(temp, sub)
                sub, p2, n2 = [], len(r.prompt_ids), r.max_tokens
            sub.append(r)
            p_need, n_need = p2, n2
        if sub:
            self._execute(temp, sub)

    def _execute(self, temp: float, group: list[_Pending]) -> None:
        # whether this batch is counted: the reference infers it from the
        # rows' done flags, which double-counts a batch whose result loop
        # fails before its first row is done
        executed = False
        try:
            lens = [len(r.prompt_ids) for r in group]
            p_bucket, new_bucket, prefill = plan_bucket(
                lens, [r.max_tokens for r in group], self.max_seq_len)
            prompts = [list(r.prompt_ids) + [0] * (p_bucket - n)
                       for r, n in zip(group, lens)]
            seed = group[0].seed if len(group) == 1 else hash(
                tuple(r.seed for r in group)) & 0x7FFFFFFF
            # ONE device->host transfer for the whole batch (run_fn returns
            # a host array), never a fetch per token
            out = np.asarray(self.run_fn(prompts, lens, new_bucket, temp,
                                         prefill, seed))
            self.stats.executed(len(group))
            executed = True
            for i, (r, n) in enumerate(zip(group, lens)):
                # rows are contiguous: generate() overwrites a short row's
                # pad positions with its own continuation as decode
                # passes them (keep_prompt is per row)
                r.result = [int(x) for x in out[i][:n + r.max_tokens]]
                self.stats.finished(r, ok=True)
                r.done.set()
        except Exception as e:  # noqa: BLE001 — request boundary
            # fail only the rows still pending: a late per-row error must
            # not poison requests already completed above (and their stats
            # must not double-count)
            if not executed:
                self.stats.executed(len(group))   # run_fn itself failed
            for r in (r for r in group if not r.done.is_set()):
                r.error = e
                self.stats.finished(r, ok=False)
                r.done.set()


class ContinuousBatcher:
    """Continuous (in-flight) batching over the paged slot-pool engine.

    ``engine`` is duck-typed (``decode_loop.SlotPoolEngine``, or its
    ``EngineLeader`` over a serving mesh): attributes ``slots`` /
    ``segment`` / ``max_total`` / ``max_request_pages`` / ``pages`` /
    ``page``, and methods ``admit(entries) -> {slot: pos}``,
    ``run_segment()``, ``poll() -> (buf [S, max_total], pos [S])``,
    ``release(slots)``, ``pages_for``, ``free_pages``,
    ``evictable_pages`` and ``pages_in_use``; optionally the counters
    ``prefix_hits`` / ``demotions`` / ``promoted_hits`` and, with
    ``spill_pages`` set, ``spill_pages_used``, which ``_report_pages``
    turns into the prefix-hit and spill-tier metrics; with ``spec_k > 0``,
    ``poll_spec() -> (pos [S], drafted, accepted)``; for an MoE config
    (``cfg.moe_experts > 0``), ``expert_load()``; for ``handoff``,
    ``import_prefix(tokens, layers, shard=)``; the plans of the last
    admission wave (``last_plans``) and the compile cache's result
    (``aot``) when the engine has them.

    The worker alternates: admit queued requests into free slots, dispatch
    ONE segment, retire finished slots from one batched fetch, idle when
    the pool drains. A plain engine's segment adds exactly ``segment``
    tokens to every active row (clamped at its stop index), so the host
    mirror of ``pos`` needs no device read and ``poll()`` runs only when
    some row finished. A speculative engine's dispatch moves each row
    1..K tokens, depending on the data: the worker reads the true
    positions and the draft/accept counts back with ``poll_spec()`` after
    every dispatch. An MoE engine's per-expert load is fetched once per
    retirement wave.

    Admission reserves *pages*, not slots: a request enters when a free
    slot's pool can cover ``ceil((plen+max_tokens)/page)`` pages (counting
    pages the engine could evict) net of what earlier picks of the same
    wave were promised. Admission is FIFO — a head request that does not
    fit blocks the line (no starvation), and retirement ``release``s its
    slots' pages before new admissions.

    On a serving mesh (``engine.dp`` > 1) the slots and pages split over
    the dp shards: slot s lives on shard s // (slots/dp), each shard with
    its own pool, so a request needs one shard with a free slot and the
    pages for it, and the occupancy, pages, spill and host-blocked
    gauges carry one ``shard=`` series each.

    Request tracing: pass a ``telemetry.serve_trace.ServeTracer`` and
    every request gets a span tree (enqueue → admit → prefill → segments
    → retire) annotated from host values the worker already holds
    (``engine.last_plans``, segment wall times, the retirement fetch).
    Without a tracer every hook is one ``is None`` test, and either way
    tracing reads nothing from the device.

    The cluster tier's levers, the reference's, each applied by the
    worker between steps through a control handshake, so ``_track`` and
    the engine keep one writer:

    * ``drain(shards)`` takes every in-flight request off the named dp
      shards (the prompt, position and page reservation are host
      state), requeues them at the **head** of the queue in submission
      order, and fences the shards' slots off admission; ``readmit``
      hands them back. A requeued request re-prefills from scratch
      wherever it admits next: greedy decode is deterministic and
      sampling is keyed by (seed, position), so its tokens are those of
      an undisturbed run.
    * ``preempt(slots)`` is ``drain`` narrowed to slots, with no fence;
      ``preemptible``, ``free_slots`` and ``backlog`` are the gateway's
      lock-free read-outs.
    * With a ``requeue_sink`` (a ``cluster.ServeGateway`` wires one)
      victims leave through the sink oldest first instead, and once a
      drain newly covers every shard the stranded queue leaves with them,
      exactly once. ``inject`` is the other end: pre-built requests enter
      the queue unvalidated, their ``done`` events still reaching their
      callers.
    * ``handoff`` lands a prefill worker's pages (``engine.import_
      prefix``) on the worker thread; ``replica`` stamps this batcher's
      identity onto every admit span.

    One difference from the reference: retired requests are counted and
    woken after their pages are released and the gauges reported, so a
    caller that reads the stats after its reply sees them.
    """

    def __init__(self, engine: Any, *, stats: BatcherStats | None = None,
                 tracer: Any = None,
                 requeue_sink: Callable[[list[_Pending]], None] | None = None,
                 replica: int | str | None = None):
        self.engine = engine
        self.stats = stats if stats is not None else BatcherStats()
        self._tracer = tracer
        self.requeue_sink = requeue_sink
        self.replica = replica
        # dispatch→ready attribution: when the retirement fetch returns,
        # the segment dispatched at _dispatch_t0 is known device-complete
        self._dispatch_t0: float | None = None
        self._compiles_seen = 0
        self._aot_noted = False
        self._traced_seen = False       # a gateway-traced request arrived
        self._cond = threading.Condition()
        self._queue: deque[_Pending] = deque()
        self._track: dict[int, dict] = {}       # slot -> in-flight state
        self._free = list(range(engine.slots))
        self._ctl: deque = deque()              # handshakes (worker-applied)
        self._drained: set[int] = set()         # dp shards fenced off admission
        # slot s lives on dp shard s // (slots/dp): the engine shards the
        # slot axis over dp in contiguous blocks, so occupancy is reported
        # per shard without device reads
        self._dp = max(1, int(getattr(engine, "dp", 1)))
        self._shard_slots = engine.slots // self._dp
        # the engine's counters as last reported (only the worker reads
        # and writes this)
        self._seen = dict.fromkeys(("prefix_hits", "demotions",
                                    "promoted_hits"), 0)
        self._spec = int(getattr(engine, "spec_k", 0) or 0)
        self._moe_serve = (
            hasattr(engine, "expert_load")
            and getattr(getattr(engine, "cfg", None), "moe_experts", 0) > 0)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="ko-serve-continuous")
        self._worker.start()

    # -- client side -------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               timeout: float | None = 300.0) -> list[int]:
        if not prompt_ids:
            raise ValueError("prompt_ids must be non-empty")
        if len(prompt_ids) + max_tokens > self.engine.max_total:
            raise ValueError(
                f"prompt ({len(prompt_ids)}) + max_tokens ({max_tokens}) "
                f"exceed max_seq_len ({self.engine.max_total})")
        need = self.engine.pages_for(len(prompt_ids), max_tokens)
        if need > self.engine.max_request_pages:
            raise ValueError(
                f"request needs {need} KV pages but one dp shard only "
                f"has {self.engine.max_request_pages} allocatable "
                f"(pages={self.engine.pages}, page={self.engine.page}): "
                f"it could never be admitted")
        req = _Pending(list(prompt_ids), int(max_tokens), float(temperature),
                       int(seed))
        self.stats.enqueued()
        if req.max_tokens == 0:
            # nothing to decode: the reply IS the prompt (generate()'s
            # max_new_tokens==0 fast path) — don't burn a slot on it
            req.result = list(req.prompt_ids)
            self.stats.finished(req, ok=True)
            return req.result
        if self._tracer is not None:
            req.trace = self._tracer.begin(
                req.id, prompt_len=len(req.prompt_ids),
                max_tokens=req.max_tokens)
        with self._cond:
            self._queue.append(req)
            self._cond.notify()
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # -- worker side -------------------------------------------------------
    def _report_occupancy(self) -> None:
        busy = [0] * self._dp
        for s in self._track:
            busy[s // self._shard_slots] += 1
        for shard, n in enumerate(busy):
            self.stats.occupancy(n, shard=shard)

    def _report_pages(self) -> None:
        """Pages in use and the spill tier's pages as gauges, per dp
        shard; the engine's prefix-hit, demotion and promotion counters as
        their growth since the last report (an engine without them reports
        none)."""
        eng = self.engine
        for shard in range(self._dp):
            self.stats.pages_used(eng.pages_in_use(shard), shard=shard)
            if getattr(eng, "spill_pages", 0):
                self.stats.kv_spill_pages(eng.spill_pages_used(shard),
                                          shard=shard)
        now = {k: int(getattr(eng, k, 0)) for k in self._seen}
        for key, report in (("prefix_hits", self.stats.prefix_hit),
                            ("demotions", self.stats.kv_demotion),
                            ("promoted_hits", self.stats.kv_promoted_hit)):
            if now[key] > self._seen[key]:
                report(now[key] - self._seen[key])
        self._seen = now

    def _admit_wave_locked(self) -> list[tuple[int, _Pending]]:
        """Pick the next admissions (caller holds the lock): FIFO page
        accounting — the head request enters when a shard with a free slot
        can cover its full page reservation net of pages already promised
        to earlier picks in this same wave (``pending``, per shard;
        without it two requests could both be admitted against the same
        free pages). A head that fits nowhere stops the wave: in-flight
        rows keep decoding, retirement releases pages, and — because
        submit caps every request at ``max_request_pages`` — a drained
        shard always admits the head, so backpressure cannot deadlock."""
        admit_now: list[tuple[int, _Pending]] = []
        pending = [0] * self._dp
        while self._queue and self._free:
            r = self._queue[0]
            need = self.engine.pages_for(len(r.prompt_ids), r.max_tokens)
            slot = None
            for i, s in enumerate(self._free):
                shard = s // self._shard_slots
                cap = (self.engine.free_pages(shard)
                       + self.engine.evictable_pages(shard) - pending[shard])
                if need <= cap:
                    slot = self._free.pop(i)
                    pending[shard] += need
                    break
            if slot is None:
                break           # head-of-line backpressure: keep FIFO order
            self._queue.popleft()
            admit_now.append((slot, r))
        return admit_now

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._ctl:
                        self._apply_ctl_locked()
                    admit_now = self._admit_wave_locked()
                    if admit_now or self._track:
                        break
                    # idle: the pool is drained, or every admittable shard
                    # is fenced off while requests wait for readmit()
                    self._cond.wait()
            try:
                self._step(admit_now)
            except Exception as e:  # noqa: BLE001 — engine boundary
                self._fail_all(admit_now, e)

    def _evict_locked(self, victims: list[int], reason: str
                      ) -> list[_Pending]:
        """Take the in-flight requests off ``victims`` (slots): count
        them, open their hop spans, and release their pages (best effort:
        a revoked shard may not answer; the next step judges it)."""
        reqs = [self._track.pop(s)["req"] for s in victims]
        for r in reqs:
            self.stats.requeued(reason)
            if r.trace is not None:
                # the hop span stays open until the victim's NEXT
                # admission — same trace id, same tree
                r.trace.hop_begin(reason=reason, from_replica=self.replica)
        if victims:
            try:
                self.engine.release(victims)
            except Exception:  # noqa: BLE001 — judged at the next step
                pass
        return reqs

    def _requeue_locked(self, reqs: list[_Pending]) -> None:
        """Victims in submission order: out through the sink, or back to
        this queue's head, oldest first."""
        reqs.sort(key=lambda r: (r.submitted_at, r.seq))
        sink = self.requeue_sink
        if sink is not None and reqs:
            self.stats.dequeued(len(reqs))
            # the gateway's sink takes its own lock, never this _cond
            sink(reqs)
        else:
            # appendleft newest-first so the head ends up oldest-first
            for r in reversed(reqs):
                self._queue.appendleft(r)

    def _apply_ctl_locked(self) -> None:
        """Service pending control handshakes (worker thread, lock held).

        ``drain``: take every in-flight request off the drained shards,
        release their page reservations, and fence the shards' slots out
        of the free list. Without a ``requeue_sink`` the victims go back
        to this queue's head in submission order; with one (the cluster
        gateway) they leave oldest-first through the sink to be re-routed
        — and once EVERY shard is fenced the stranded queue goes with
        them, because nothing left here could ever admit it.

        ``preempt``: the drain narrowed to slots, fencing nothing: the
        freed slots go straight back to admission.

        ``handoff``: import a prefill worker's finished KV pages into the
        engine's prefix cache on the worker thread, preserving the
        engine's single-writer protocol."""
        while self._ctl:
            op, args, ev, out = self._ctl.popleft()
            if op == "handoff":
                tokens, layers, shard = args
                try:
                    out["pages"] = int(self.engine.import_prefix(
                        tokens, layers, shard=shard))
                except Exception as e:  # noqa: BLE001 — judged by caller
                    out["error"] = e
                ev.set()
                continue
            if op == "preempt":
                slot_set, reason = args
                victims = sorted(s for s in self._track if s in slot_set)
                reqs = self._evict_locked(victims, reason)
                self._free.extend(s for s in victims
                                  if s // self._shard_slots
                                  not in self._drained)
                self._requeue_locked(reqs)
                out["requeued"] = [r.id for r in reqs]
                self._report_occupancy()
                ev.set()
                continue
            shard_set, reason = args
            victims = sorted(s for s in self._track
                             if s // self._shard_slots in shard_set)
            reqs = self._evict_locked(victims, reason)
            self._free = [s for s in self._free
                          if s // self._shard_slots not in shard_set]
            # the stranded queue leaves through the sink exactly once:
            # when this drain NEWLY completes full-shard coverage. A
            # re-drain of already-fenced shards finds covered_before True
            # and must not ship the queue again — its contents were
            # either requeued already or submitted after the fence and
            # belong to the next readmit.
            covered_before = len(self._drained) == self._dp
            self._drained |= shard_set
            if self.requeue_sink is not None and not covered_before \
                    and len(self._drained) == self._dp:
                reqs += list(self._queue)
                self._queue.clear()
            self._requeue_locked(reqs)
            out["requeued"] = [r.id for r in reqs]
            self._report_occupancy()
            ev.set()

    def _handshake(self, op: str, args: tuple, what: str,
                   timeout: float | None) -> dict:
        """Queue one control op for the worker and wait until it has
        applied it; the op's results."""
        ev = threading.Event()
        out: dict = {}
        with self._cond:
            self._ctl.append((op, args, ev, out))
            self._cond.notify()
        if not ev.wait(timeout):
            raise TimeoutError(f"{what} timed out waiting for the worker")
        return out

    def drain(self, shards, reason: str = "drain",
              timeout: float | None = 60.0) -> list[str]:
        """Fence the given dp shards off from admission and requeue their
        in-flight requests (head of the queue, submission order) instead
        of dropping them. Blocks until the worker has applied the drain;
        returns the requeued request ids. Safe to call for shards with no
        in-flight work (the fence still applies)."""
        shard_set = {int(s) for s in shards}
        bad = [s for s in shard_set if not 0 <= s < self._dp]
        if bad:
            raise ValueError(f"unknown dp shards {sorted(bad)} "
                             f"(engine has {self._dp})")
        return self._handshake("drain", (shard_set, reason), "drain",
                               timeout)["requeued"]

    def preempt(self, slots, reason: str = "preempt",
                timeout: float | None = 60.0) -> list[str]:
        """Evict the in-flight requests holding the given slots — the
        drain protocol narrowed from per-shard to per-slot. Victims
        requeue exactly like drained ones (queue head, or out through the
        gateway sink) and re-prefill from scratch wherever they admit
        next, so greedy tokens stay those of an undisturbed run. Unlike
        ``drain`` there is NO shard fence: the freed slots return to the
        admission pool at once. Slots with no in-flight request are
        ignored. Returns the requeued ids."""
        slot_set = {int(s) for s in slots}
        bad = [s for s in slot_set if not 0 <= s < self.engine.slots]
        if bad:
            raise ValueError(f"unknown slots {sorted(bad)} "
                             f"(engine has {self.engine.slots})")
        return self._handshake("preempt", (slot_set, reason), "preempt",
                               timeout)["requeued"]

    def preemptible(self, priority: str = "batch") -> list[tuple[int, Any]]:
        """(slot, request) pairs of the in-flight requests of the given
        priority class, newest admission first — the gateway's victim
        list when a latency-class request finds no free slot (the newest
        victim has the least decode progress to throw away)."""
        with self._cond:
            rows = [(s, t["req"]) for s, t in self._track.items()
                    if t["req"].priority == priority]
        rows.sort(key=lambda x: (x[1].submitted_at, x[1].seq), reverse=True)
        return rows

    def free_slots(self) -> int:
        """Admittable slot count — the gateway's preemption trigger. A
        lock-free read of one container length: a heuristic, not a
        barrier, like ``backlog``."""
        return len(self._free)

    def backlog(self) -> int:
        """Queued + in-flight request count — the admission pressure the
        cluster gateway's router balances on. Lock-free reads of two
        container lengths: a heuristic, not a barrier."""
        return len(self._queue) + len(self._track)

    def inject(self, reqs: list[_Pending], front: bool = True) -> None:
        """Enqueue pre-built requests (the gateway's requeue path). The
        requests were validated by their original ``submit`` and their
        ``done`` events still reach the original callers. ``front`` keeps
        drained victims ahead of this replica's own arrivals (they are the
        oldest requests in the cluster)."""
        if not reqs:
            return
        for _ in reqs:
            self.stats.enqueued()
        with self._cond:
            if front:
                # appendleft newest-first so the head ends up oldest-first
                for r in sorted(reqs, key=lambda r: (r.submitted_at, r.seq),
                                reverse=True):
                    self._queue.appendleft(r)
            else:
                self._queue.extend(sorted(
                    reqs, key=lambda r: (r.submitted_at, r.seq)))
            self._cond.notify()

    def handoff(self, tokens: Sequence[int], layers: Any = None,
                shard: int = 0, timeout: float | None = 60.0) -> int:
        """Import a disaggregated prefill worker's finished pages into
        this replica's engine (``engine.import_prefix``) through the
        control handshake, so the import runs on the worker thread between
        steps. Returns the whole pages imported (0 when the prefix was
        already cached)."""
        out = self._handshake("handoff", (list(tokens), layers, int(shard)),
                              "handoff", timeout)
        if "error" in out:
            raise out["error"]
        return out["pages"]

    def readmit(self, shards=None) -> list[int]:
        """Hand drained shards' slots back to the admission pool (all
        drained shards when ``shards`` is None). Returns the shard ids
        re-opened. Requeued requests then re-admit in FIFO order."""
        with self._cond:
            shard_set = (set(self._drained) if shards is None
                         else {int(s) for s in shards} & self._drained)
            for shard in sorted(shard_set):
                self._drained.discard(shard)
                lo = shard * self._shard_slots
                self._free.extend(range(lo, lo + self._shard_slots))
            self._cond.notify()
            return sorted(shard_set)

    def _note_compiles(self) -> None:
        """The compile cache's bring-up outcome (``engine.aot``), noted
        once on the first in-flight traces, and compile events from the
        compile-count guard active now, if any. The port's guard counts
        nvcc builds of kernel libraries, and the pool builds none, so a
        pool's traces carry no compile event."""
        aot = getattr(self.engine, "aot", None)
        if aot is not None and not self._aot_noted and self._track:
            self._aot_noted = True
            for t in self._track.values():
                if t["req"].trace is not None:
                    t["req"].trace.aot_event(hit=aot.hit,
                                             seconds=aot.seconds)
        guard = active_guard()
        if guard is None:
            return
        n = guard.total()
        if n > self._compiles_seen:
            delta = n - self._compiles_seen
            self._compiles_seen = n
            for t in self._track.values():
                if t["req"].trace is not None:
                    t["req"].trace.compile_event(delta)

    def _step(self, admit_now: list[tuple[int, _Pending]]) -> None:
        now = time.monotonic
        if admit_now:
            t_admit = now()
            pos_map = self.engine.admit(
                [(slot, r.prompt_ids, r.max_tokens, r.temperature, r.seed)
                 for slot, r in admit_now])
            admit_s = now() - t_admit
            # the admission plans the engine built on the host (shard,
            # pages, hit kind): a trace annotation is a dict lookup
            plans = getattr(self.engine, "last_plans", None) or {}
            for slot, r in admit_now:
                plen = len(r.prompt_ids)
                t = {"req": r, "plen": plen, "pos": pos_map[slot],
                     "last": plen + r.max_tokens - 1, "ttft": False}
                if r.trace is not None:
                    self._traced_seen = True
                    r.trace.admitted(slot=slot,
                                     shard=slot // self._shard_slots,
                                     wave_s=admit_s, plan=plans.get(slot),
                                     replica=self.replica)
                if t["pos"] >= plen:
                    # pow2-length prompt: its first token was born in the
                    # admission prefill itself
                    self._first_token(r, now() - r.submitted_at)
                    t["ttft"] = True
                self._track[slot] = t
            self._report_occupancy()
            self._report_pages()

        active = [s for s, t in self._track.items() if t["pos"] < t["last"]]
        if active:
            t0 = now()
            self.engine.run_segment()
            seg_s = now() - t0
            self.stats.segment(seg_s)
            self.stats.executed(len(active))
            self._dispatch_t0 = t0
            # gateway-minted traces ride requests injected into an
            # untraced batcher; once one has been seen, compile events
            # must reach those trees too
            if self._tracer is not None or self._traced_seen:
                self._note_compiles()
            k = self.engine.segment
            pos_vec = None
            if self._spec:
                pos_vec, drafted, accepted = self.engine.poll_spec()
                self.stats.spec_tokens(drafted, accepted)
            for s in active:
                t = self._track[s]
                r = t["req"]
                prev = t["pos"]
                t["pos"] = (min(int(pos_vec[s]), t["last"])
                            if pos_vec is not None
                            else min(prev + k, t["last"]))
                if not t["ttft"] and t["pos"] >= t["plen"]:
                    self._first_token(r, now() - r.submitted_at)
                    t["ttft"] = True
                if r.trace is not None:
                    r.trace.segment(seg_s, pos=prev, k=t["pos"] - prev,
                                    shard=s // self._shard_slots)

        done = [s for s, t in self._track.items() if t["pos"] >= t["last"]]
        if done:
            t0 = now()
            buf, _ = self.engine.poll()         # ONE batched fetch
            poll_end = now()
            blocked_s = poll_end - t0
            for shard in sorted({s // self._shard_slots for s in done}):
                self.stats.host_blocked(blocked_s, shard=shard)
            # the fetch forces the last dispatch to device-complete, so
            # dispatch→fetch-return bounds its device time
            device_s = (None if self._dispatch_t0 is None
                        else poll_end - self._dispatch_t0)
            if device_s is not None:
                self.stats.segment_device(device_s)
            self._dispatch_t0 = None
            retired = []
            for s in done:
                t = self._track.pop(s)
                r = t["req"]
                r.result = [int(x)
                            for x in buf[s][:t["plen"] + r.max_tokens]]
                if r.trace is not None:
                    r.trace.retire(blocked_s=blocked_s, device_s=device_s,
                                   shard=s // self._shard_slots,
                                   tokens=r.max_tokens)
                retired.append(r)
            # hand the retired slots' pages back BEFORE the slots are
            # offered for re-admission, and report before the clients wake,
            # so a caller that reads the stats after its reply sees them
            self.engine.release(done)
            if self._moe_serve:
                self.stats.moe_expert_load(self.engine.expert_load())
            with self._cond:
                self._free.extend(done)
            self._report_occupancy()
            self._report_pages()
            for r in retired:
                self.stats.finished(r, ok=True)
                r.done.set()

    def _first_token(self, r: _Pending, ttft_s: float) -> None:
        r.ttft_s = ttft_s
        self.stats.ttft(ttft_s)
        if r.trace is not None:
            r.trace.ttft(ttft_s)

    def _fail_all(self, admit_now: list[tuple[int, _Pending]],
                  err: Exception) -> None:
        """Engine-level failure: fail every in-flight request and reset
        the pool (per-request validation happened in submit, so an admit/
        segment error is systemic, not one bad row's)."""
        with self._cond:
            victims = [t["req"] for t in self._track.values()]
            victims += [r for _, r in admit_now if not r.done.is_set()]
            self._track.clear()
            # the reset pool keeps drained shards fenced: a revocation
            # mid-step must not resurrect the dead shard's slots
            self._free = [s for s in range(self.engine.slots)
                          if s // self._shard_slots not in self._drained]
        try:
            # drop every slot's page reservation so the reset pool starts
            # from a consistent allocator (best-effort: the engine may be
            # the thing that just failed)
            self.engine.release(list(range(self.engine.slots)))
        except Exception:  # noqa: BLE001 — already failing
            pass
        for r in victims:
            if not r.done.is_set():
                r.error = err
                if r.trace is not None:
                    r.trace.fail(err)
                self.stats.finished(r, ok=False)
                r.done.set()
        self._report_occupancy()
