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
row). Admission reserves KV pages, FIFO, with head-of-line backpressure.

Both engines report through ``BatcherStats``, whose ``ko_serve_*``
families live in a ``telemetry.metrics`` registry (private per batcher by
default; the serve job passes its one registry so ``/metrics`` is one
scrape).

Left out of the reference's ``ContinuousBatcher`` (ROADMAP queue 1): the
cluster tier's levers (``drain``, ``preempt``, ``preemptible``,
``readmit``, ``inject``, ``handoff``, ``requeue_sink``, ``replica``), the
request tracer, per-shard (dp mesh) accounting, and engines without page
accounting. Only the paged engine exists in the port.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

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


@dataclass
class _Pending:
    prompt_ids: list[int]
    max_tokens: int
    temperature: float
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    result: list[int] | None = None
    error: Exception | None = None
    submitted_at: float = field(default_factory=time.monotonic)
    id: str = field(default_factory=lambda: short_id(12))


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
        """Allocated KV pages (live slots) on one dp mesh shard of the
        paged continuous engine."""
        self._m["kv_pages_used"].set(pages, shard=str(shard))

    def ttft_mean(self) -> float:
        """Mean observed time-to-first-token in seconds (0.0 before any
        observation)."""
        h = self._m["ttft"]
        n = h.count()
        return h.sum() / n if n else 0.0

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
            pending = [r for r in group if not r.done.is_set()]
            if pending and not any(r.done.is_set() for r in group):
                self.stats.executed(len(group))   # run_fn itself failed
            for r in pending:
                r.error = e
                self.stats.finished(r, ok=False)
                r.done.set()


class ContinuousBatcher:
    """Continuous (in-flight) batching over the paged slot-pool engine.

    ``engine`` is duck-typed (``decode_loop.SlotPoolEngine``): attributes
    ``slots`` / ``segment`` / ``max_total`` / ``max_request_pages`` /
    ``pages`` / ``page``, and methods ``admit(entries) -> {slot: pos}``,
    ``run_segment()``, ``poll() -> (buf [S, max_total], pos [S])``,
    ``release(slots)``, ``pages_for``, ``free_pages``,
    ``evictable_pages`` and ``pages_in_use``.

    The worker alternates: admit queued requests into free slots, dispatch
    ONE segment advancing every active slot K tokens, retire finished
    slots from one batched fetch, idle when the pool drains. Scheduling
    needs **no** device reads: admission returns each slot's position and
    every segment adds exactly K (clamped at the row's stop index), so the
    host mirror of ``pos`` is exact and ``poll()`` runs only when some row
    finished.

    Admission reserves *pages*, not slots: a request enters when a free
    slot's pool can cover ``ceil((plen+max_tokens)/page)`` pages (counting
    pages the engine could evict) net of what earlier picks of the same
    wave were promised. Admission is FIFO — a head request that does not
    fit blocks the line (no starvation), and retirement ``release``s its
    slots' pages before new admissions.
    """

    def __init__(self, engine: Any, *, stats: BatcherStats | None = None):
        self.engine = engine
        self.stats = stats if stats is not None else BatcherStats()
        # dispatch→ready attribution: when the retirement fetch returns,
        # the segment dispatched at _dispatch_t0 is known device-complete
        self._dispatch_t0: float | None = None
        self._cond = threading.Condition()
        self._queue: deque[_Pending] = deque()
        self._track: dict[int, dict] = {}       # slot -> in-flight state
        self._free = list(range(engine.slots))
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
                f"request needs {need} KV pages but the pool only has "
                f"{self.engine.max_request_pages} allocatable "
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
        self.stats.occupancy(len(self._track))

    def _report_pages(self) -> None:
        self.stats.pages_used(self.engine.pages_in_use())

    def _admit_wave_locked(self) -> list[tuple[int, _Pending]]:
        """Pick the next admissions (caller holds the lock): FIFO page
        accounting — the head request enters when the pool can cover its
        full page reservation net of pages already promised to earlier
        picks in this same wave (``pending``; without it two requests
        could both be admitted against the same free pages). A head that
        does not fit stops the wave: in-flight rows keep decoding,
        retirement releases pages, and — because submit caps every request
        at ``max_request_pages`` — a drained pool always admits the head,
        so backpressure cannot deadlock."""
        admit_now: list[tuple[int, _Pending]] = []
        pending = 0
        while self._queue and self._free:
            r = self._queue[0]
            need = self.engine.pages_for(len(r.prompt_ids), r.max_tokens)
            cap = (self.engine.free_pages() + self.engine.evictable_pages()
                   - pending)
            if need > cap:
                break           # head-of-line backpressure: keep FIFO order
            pending += need
            self._queue.popleft()
            admit_now.append((self._free.pop(0), r))
        return admit_now

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    admit_now = self._admit_wave_locked()
                    if admit_now or self._track:
                        break
                    self._cond.wait()     # idle: the pool is drained
            try:
                self._step(admit_now)
            except Exception as e:  # noqa: BLE001 — engine boundary
                self._fail_all(admit_now, e)

    def _step(self, admit_now: list[tuple[int, _Pending]]) -> None:
        now = time.monotonic
        if admit_now:
            pos_map = self.engine.admit(
                [(slot, r.prompt_ids, r.max_tokens, r.temperature, r.seed)
                 for slot, r in admit_now])
            for slot, r in admit_now:
                plen = len(r.prompt_ids)
                t = {"req": r, "plen": plen, "pos": pos_map[slot],
                     "last": plen + r.max_tokens - 1, "ttft": False}
                if t["pos"] >= plen:
                    # pow2-length prompt: its first token was born in the
                    # admission prefill itself
                    self.stats.ttft(now() - r.submitted_at)
                    t["ttft"] = True
                self._track[slot] = t
            self._report_occupancy()
            self._report_pages()

        active = [s for s, t in self._track.items() if t["pos"] < t["last"]]
        if active:
            t0 = now()
            self.engine.run_segment()
            self.stats.segment(now() - t0)
            self.stats.executed(len(active))
            self._dispatch_t0 = t0
            k = self.engine.segment
            for s in active:
                t = self._track[s]
                t["pos"] = min(t["pos"] + k, t["last"])
                if not t["ttft"] and t["pos"] >= t["plen"]:
                    self.stats.ttft(now() - t["req"].submitted_at)
                    t["ttft"] = True

        done = [s for s, t in self._track.items() if t["pos"] >= t["last"]]
        if done:
            t0 = now()
            buf, _ = self.engine.poll()         # ONE batched fetch
            poll_end = now()
            self.stats.host_blocked(poll_end - t0)
            # the fetch forces the last dispatch to device-complete, so
            # dispatch→fetch-return bounds its device time
            if self._dispatch_t0 is not None:
                self.stats.segment_device(poll_end - self._dispatch_t0)
            self._dispatch_t0 = None
            retired = []
            for s in done:
                t = self._track.pop(s)
                r = t["req"]
                r.result = [int(x)
                            for x in buf[s][:t["plen"] + r.max_tokens]]
                retired.append(r)
            # hand the retired slots' pages back BEFORE the slots are
            # offered for re-admission, and report before the clients wake,
            # so a caller that reads the stats after its reply sees them
            self.engine.release(done)
            with self._cond:
                self._free.extend(done)
            self._report_occupancy()
            self._report_pages()
            for r in retired:
                self.stats.finished(r, ok=True)
                r.done.set()

    def _fail_all(self, admit_now: list[tuple[int, _Pending]],
                  err: Exception) -> None:
        """Engine-level failure: fail every in-flight request and reset
        the pool (per-request validation happened in submit, so an admit/
        segment error is systemic, not one bad row's)."""
        with self._cond:
            victims = [t["req"] for t in self._track.values()]
            victims += [r for _, r in admit_now if not r.done.is_set()]
            self._track.clear()
            self._free = list(range(self.engine.slots))
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
                self.stats.finished(r, ok=False)
                r.done.set()
        self._report_occupancy()
