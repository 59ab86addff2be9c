"""Cluster-tier serving: one gateway fronting N batcher replicas, the
counterpart of ``kubeoperator_tpu/cluster/gateway.py``, whole (every
policy, the requeue path, the prefill handoff, QoS, model groups, the
aggregate stats and the stitched traces), over the port's
``ContinuousBatcher``.

One paged ``SlotPoolEngine`` — however well it batches and pages — is a
single-replica ceiling. ``ServeGateway`` is the next scale axis: N
independent ``ContinuousBatcher`` + engine replicas (each on one device
or over a serving mesh behind an ``EngineLeader``) behind one ``submit``
with the batcher's own signature, so every caller of one replica calls
a cluster alike.

The router reads two signals:

* **prefix affinity** — the hashed first ``affinity_pages`` pages of the
  prompt pick a *home* replica (``hash % N`` over all replicas, draining
  or not, so the mapping is stable across drains). Requests sharing a
  page-aligned prefix keep landing where their pages already sit, which
  turns the per-shard LRU prefix cache into a cluster-wide cache with no
  coherence protocol — just sticky hashing. Hashing only the leading
  page(s) matters: a full-prefix hash would fold each request's unique
  tail in and spray one tenant's traffic across every replica.
* **load** — queued + in-flight requests per replica (``backlog``), with
  free + evictable KV pages as the tiebreak. When the home replica is
  saturated (backlog at ``spill_after``) or draining, the request
  spills to the least-loaded healthy replica: worse for affinity,
  necessary for tail latency. ``round_robin`` and ``least_loaded``
  policies skip the affinity signal entirely (the A/B baselines).

Replica loss rides the batcher's drain protocol: ``drain_replica`` wires
every batcher's ``requeue_sink`` back here, so mid-decode victims (and,
once every shard is fenced, the stranded queue) re-enter the *gateway*
queue in submission order and a dispatcher thread re-routes them to
healthy replicas — their ``done`` events travel with them, so blocked
clients never notice the migration. Greedy decode is deterministic and
sampling is (seed, position)-keyed, so tokens through any routing
policy, spill-over, or mid-trace replica loss stay bit-identical to a
solo ``generate()`` (pinned by tests/test_torch_cluster.py).

With a ``disagg.PrefillWorker`` attached, long prompts additionally
prefill on a dedicated worker and the finished pages ship to the routed
replica as block-table page lists (``engine.import_prefix``) before the
request is submitted — so the decode replica's admission sees a prefix
hit and its in-flight decodes stop losing segment time to other
tenants' prefills.

Multi-tenant QoS: construct with ``tenants={name: {rate,
burst, weight, priority, deadline_s}}`` and ``submit`` grows tenant
identity + a priority class (``latency`` | ``batch``). Requests then
flow through the gateway's own per-tenant queues instead of straight
into a replica:

* **admission** — a per-tenant token bucket (``rate`` req/s refill,
  ``burst`` capacity). Below saturation an over-rate tenant merely
  borrows (its bucket goes into debt, floored at ``-burst``); above
  saturation (cluster backlog at ``shed_after``) its requests are
  deliberately **shed** with a ``ShedError`` carrying ``retry_after_s``
  — the time the bucket needs to refill back to one token — instead of
  queueing without bound. A request whose ``deadline_s`` is shorter
  than that refill sheds as ``deadline``; one that out-waits its
  deadline in the queue sheds as ``expired`` at dispatch.
* **weighted-fair dequeue** — the dispatcher serves tenant queues by
  virtual time (cost ``prompt+max_tokens`` over ``weight``), with
  latency-class heads strictly ahead of batch-class heads, and it
  dispatches batch work only into replica room (backlog below
  ``spill_after``) so one tenant's burst cannot bury the replica
  queues FIFO-style. Latency-class requests bypass the room gate and
  enter their replica's queue at the *head*.
* **priority preemption** — a latency-class request routed to a
  replica with zero free slots may evict the newest batch-class
  in-flight victim (``ContinuousBatcher.preempt``, the drain protocol
  narrowed to one slot). The victim re-enters the gateway queue,
  re-routes, and re-prefills — greedy decode is deterministic and
  sampling (seed, position)-keyed, so its reply stays bit-identical
  to an undisturbed solo ``generate()``.

Without ``tenants`` the gateway is exactly the pre-QoS router: submit
routes and delegates directly, nothing is shed, nothing preempts.

Model identity: construct with ``models=`` (one
``model_id@version`` string per batcher) and replicas join **replica
groups** keyed by model id. ``submit(..., model=)`` routes within that
group only — sticky-prefix hashing runs over the group's stable member
list, spill stays inside the group, and an unregistered model raises a
typed ``UnknownModelError`` carrying the available identities instead
of crashing or silently cross-routing. A bare model id spans every
version of the group (how live traffic keeps flowing mid-rollout, when
the group is briefly split across two weight versions); a full
``model_id@version`` pins the exact cohort (how the canary judge and
tests address one side of a rollout). ``set_replica_version`` is the
rollout controller's commit point: version is replica metadata, group
membership never changes, so the sticky home mapping is stable across
an entire rollout. Without ``models=`` every replica lands in one
``default`` group and the gateway is exactly the pre-model router.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Sequence

from kubeoperator_tpu_torch.telemetry import metrics as tm
from kubeoperator_tpu_torch.telemetry.flight import FLIGHT
from kubeoperator_tpu_torch.workloads.serving import _Pending

POLICIES = ("sticky_prefix", "round_robin", "least_loaded")
PRIORITIES = ("latency", "batch")
QOS_MODES = ("fair", "fifo")

#: model identity for gateways constructed without ``models=`` — one
#: group, version v0, byte-compatible with every pre-model caller
DEFAULT_MODEL = "default@v0"

#: bounded per-tenant latency/TTFT sample windows (p95 estimation)
_SAMPLE_WINDOW = 512


class ShedError(RuntimeError):
    """Deliberate overload rejection: the gateway refused to queue this
    request. ``retry_after_s`` is the contract — the client should back
    off at least that long (the tenant's token bucket will have
    refilled to one token by then). ``reason`` is ``rate`` (over the
    tenant's admission rate at saturation), ``deadline`` (the required
    backoff already exceeds the request's deadline), or ``expired``
    (the request out-waited its deadline in the gateway queue)."""

    def __init__(self, tenant: str, reason: str, retry_after_s: float):
        super().__init__(
            f"shed for tenant {tenant!r} ({reason}): retry after "
            f"{retry_after_s:.3f}s")
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s


class UnknownModelError(LookupError):
    """Typed rejection for ``submit(model=...)`` naming a model (or a
    ``model@version`` cohort) no replica serves. ``available`` carries
    the full ``model_id@version`` identities currently registered, so a
    client can discover the fleet from the rejection itself — the same
    machine-actionable contract as ``ShedError.retry_after_s``."""

    def __init__(self, model: str | None, available: Sequence[str]):
        avail = sorted(available)
        super().__init__(
            f"unknown model {model!r}: available models are {avail}")
        self.model = model
        self.available = avail


class _Tenant:
    """Per-tenant QoS state, all mutated under the gateway lock: the
    token bucket, the weighted-fair queue + virtual time, and the
    observability the per-tenant SLO verdicts read."""

    __slots__ = ("name", "rate", "burst", "weight", "priority",
                 "deadline_s", "tokens", "refilled_at", "vtime", "queue",
                 "submitted", "finished", "shed", "preempted",
                 "ttft_samples", "latency_samples")

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec or {}
        self.name = name
        self.rate = float(spec.get("rate", float("inf")))
        self.burst = float(spec.get("burst", float("inf")))
        self.weight = float(spec.get("weight", 1.0))
        self.priority = spec.get("priority", "latency")
        self.deadline_s = spec.get("deadline_s")
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError(f"tenant {name!r}: rate and burst must be > 0")
        if self.weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        if self.priority not in PRIORITIES:
            raise ValueError(f"tenant {name!r}: priority must be one of "
                             f"{PRIORITIES}, got {self.priority!r}")
        self.tokens = self.burst
        self.refilled_at = time.monotonic()
        self.vtime = 0.0
        self.queue: deque = deque()
        self.submitted = 0
        self.finished = 0
        self.shed: dict[str, int] = {}
        self.preempted = 0
        self.ttft_samples: deque = deque(maxlen=_SAMPLE_WINDOW)
        self.latency_samples: deque = deque(maxlen=_SAMPLE_WINDOW)

    def refill(self, now: float) -> None:
        if self.rate == float("inf"):
            self.tokens = self.burst
            return
        self.tokens = min(self.burst,
                          self.tokens + (now - self.refilled_at) * self.rate)
        self.refilled_at = now

    def spend(self) -> None:
        if self.rate == float("inf"):
            return
        # debt floored at -burst: a 10x burst pays back at most one full
        # bucket of backoff, it is not locked out for the burst's length
        self.tokens = max(self.tokens - 1.0, -self.burst)

    def retry_after(self) -> float:
        """Seconds until the bucket refills back to one token."""
        if self.rate == float("inf") or self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


def _p95(samples) -> float | None:
    if not samples:
        return None
    vals = sorted(samples)
    return vals[min(len(vals) - 1, int(0.95 * len(vals)))]


class AggregateStats:
    """Read-only cluster view over N replicas' ``BatcherStats`` with the
    per-replica API (``snapshot``, the TTFT reads) —
    counters sum, gauges sum (they are pool sizes), latency quantiles
    take the worst replica (conservative for SLOs), and TTFT quantiles
    merge the underlying histogram counts (a p95 of p95s is not a p95)."""

    _SUMMED = ("requests_total", "errors_total", "batches_total",
               "tokens_generated_total", "queue_depth", "slot_occupancy",
               "kv_pages_used", "prefix_hits_total", "kv_spill_pages",
               "kv_demotions_total", "kv_promoted_hits_total",
               "requests_requeued_total", "spec_draft_tokens_total",
               "spec_accepted_tokens_total")

    def __init__(self, stats: Sequence[Any]):
        if not stats:
            raise ValueError("AggregateStats needs at least one BatcherStats")
        self._stats = list(stats)

    def snapshot(self) -> dict:
        snaps = [s.snapshot() for s in self._stats]
        out: dict = {k: sum(s[k] for s in snaps) for k in self._SUMMED}
        hist: dict = {}
        for s in snaps:
            for k, v in s["batch_size_hist"].items():
                hist[k] = hist.get(k, 0) + v
        out["batch_size_hist"] = hist
        # cluster acceptance is a ratio of the summed counters — an
        # average of per-replica ratios would overweight idle replicas
        out["spec_acceptance_ratio"] = round(
            out["spec_accepted_tokens_total"]
            / max(out["spec_draft_tokens_total"], 1), 4)
        for k in ("latency_p50_s", "latency_p95_s"):
            out[k] = max(s[k] for s in snaps)
        return out

    def ttft_histogram(self) -> tuple[tuple[float, ...], list[int], int,
                                      float]:
        buckets, counts, n, total = self._stats[0].ttft_histogram()
        counts = list(counts)
        for s in self._stats[1:]:
            b2, c2, n2, t2 = s.ttft_histogram()
            if b2 != buckets:
                raise ValueError("replicas disagree on TTFT buckets")
            counts = [a + b for a, b in zip(counts, c2)]
            n += n2
            total += t2
        return buckets, counts, n, total

    def ttft_mean(self) -> float:
        _, _, n, total = self.ttft_histogram()
        return total / n if n else 0.0

    def ttft_quantile(self, q: float = 0.95) -> float | None:
        buckets, counts, n, _ = self.ttft_histogram()
        if not n:
            return None
        need = q * n
        cum = 0
        for bound, c in zip(buckets, counts):
            cum += c
            if cum >= need and bound != float("inf"):
                return bound
        return buckets[-2]


class _Replica:
    """One routing target: index is the sticky hash's stable identity.
    ``model`` (the replica-group key) is fixed for the replica's life;
    ``version`` is mutable metadata a rollout rewrites between drain and
    readmit — the canary cohort label, never a routing-stability input."""

    __slots__ = ("index", "batcher", "draining", "model", "version")

    def __init__(self, index: int, batcher: Any,
                 model: str = DEFAULT_MODEL):
        self.index = index
        self.batcher = batcher
        self.draining = False
        self.model, self.version = _split_identity(model)

    @property
    def identity(self) -> str:
        return f"{self.model}@{self.version}"


def _split_identity(model: str) -> tuple[str, str]:
    """``model_id@version`` → (model_id, version); a bare id gets v0."""
    if "@" in model:
        mid, _, ver = model.partition("@")
    else:
        mid, ver = model, "v0"
    if not mid or not ver:
        raise ValueError(f"bad model identity {model!r}: want "
                         f"'model_id' or 'model_id@version'")
    return mid, ver


class ServeGateway:
    """Two-signal router over N ``ContinuousBatcher`` replicas; see the
    module docstring for the routing discipline. ``submit`` has the
    batcher's signature, so the gateway stands in wherever a batcher is
    called.

    Construction wires each batcher's ``requeue_sink`` and ``replica``
    stamp — the batchers must not already belong to another gateway."""

    def __init__(self, batchers: Sequence[Any], *,
                 policy: str = "sticky_prefix", affinity_pages: int = 1,
                 spill_after: int | None = None, prefill_worker: Any = None,
                 handoff_min_pages: int = 1,
                 tenants: dict[str, dict] | None = None,
                 qos: str = "fair", shed_after: int | None = None,
                 models: Sequence[str] | None = None,
                 tracer: Any = None):
        if not batchers:
            raise ValueError("ServeGateway needs at least one batcher")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        if affinity_pages < 1:
            raise ValueError(f"affinity_pages must be >= 1, "
                             f"got {affinity_pages}")
        if qos not in QOS_MODES:
            raise ValueError(f"qos must be one of {QOS_MODES}, got {qos!r}")
        if models is not None and len(models) != len(batchers):
            raise ValueError(f"models must name one model_id@version per "
                             f"batcher: got {len(models)} for "
                             f"{len(batchers)} batchers")
        self.policy = policy
        self.affinity_pages = int(affinity_pages)
        self._page = int(getattr(batchers[0].engine, "page", 16))
        # saturation threshold: twice the pool depth tolerates a burst's
        # queueing (affinity survives) but sheds a truly hot replica
        self._spill_after = (int(spill_after) if spill_after is not None
                             else 2 * int(batchers[0].engine.slots))
        self._prefill = prefill_worker
        self._handoff_min_pages = int(handoff_min_pages)
        # the gateway-tier tracer: when wired, submit mints
        # ONE trace per request here — gateway wait, sheds, handoffs and
        # requeue hops stitch into the same tree the batcher's scheduling
        # edges already annotate. Without it the batchers mint their own
        # traces, one per replica visit.
        self._tracer = tracer
        self.replicas = [
            _Replica(i, b, models[i] if models is not None else DEFAULT_MODEL)
            for i, b in enumerate(batchers)]
        # replica groups keyed by model id: the member list is fixed at
        # construction (sticky hashing needs a stable modulus), versions
        # within it churn as rollouts rewrite them
        self._groups: dict[str, list[_Replica]] = {}
        for r in self.replicas:
            self._groups.setdefault(r.model, []).append(r)
        self.stats = AggregateStats([b.stats for b in batchers])
        self._lock = threading.Lock()
        self._gcond = threading.Condition(self._lock)
        self._gq: deque = deque()           # gateway requeue queue
        self._rr = 0
        self._routed: dict[tuple[int, str], int] = {}
        self._sticky_hits = 0               # landed on the hashed home
        self._sticky_total = 0              # had a sticky-eligible prefix
        self._handoff_pages = 0
        self._requeued_total = 0
        self._handed: list[set[tuple[int, ...]]] = [set() for _ in batchers]
        # -- multi-tenant QoS state (all under _lock) -----------------------
        self.qos = tenants is not None
        self._qos_mode = qos
        self._tenants: dict[str, _Tenant] = {
            name: _Tenant(name, spec) for name, spec in (tenants or {}).items()
        }
        # saturation for deliberate shedding: the whole cluster's spill
        # depth — beyond it queueing is unbounded latency, not buffering
        self._shed_after = (int(shed_after) if shed_after is not None
                            else len(batchers) * self._spill_after)
        self._vclock = 0.0                  # weighted-fair virtual clock
        self._fifo: deque = deque()         # qos="fifo" baseline queue
        self._shed_total = 0
        self._preempted_total = 0
        for r in self.replicas:
            r.batcher.requeue_sink = self._sink
            r.batcher.replica = r.index
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="ko-gateway")
        self._dispatcher.start()

    # -- client side --------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               timeout: float | None = 300.0, tenant: str | None = None,
               priority: str | None = None,
               deadline_s: float | None = None,
               model: str | None = None) -> list[int]:
        prompt = list(prompt_ids)
        model = self._resolve_model(model)
        if not self.qos:
            if self._tracer is not None:
                return self._submit_traced(prompt, int(max_tokens),
                                           float(temperature), int(seed),
                                           timeout, model)
            # pre-QoS direct path: route and delegate (tenant identity is
            # accepted but unenforced — nothing to admit against)
            idx, decision = self._route(prompt, model=model)
            tm.GATEWAY_ROUTED.inc(replica=str(idx), policy=decision)
            if self._prefill is not None:
                self._maybe_handoff(idx, prompt)
            return self.replicas[idx].batcher.submit(
                prompt, max_tokens, temperature, seed, timeout=timeout)
        return self._submit_qos(prompt, int(max_tokens), float(temperature),
                                int(seed), timeout, tenant or "default",
                                priority, deadline_s, model)

    def _submit_traced(self, prompt: list[int], max_tokens: int,
                       temperature: float, seed: int,
                       timeout: float | None,
                       model: str | None) -> list[int]:
        """The non-QoS path with a gateway tracer wired: mint the trace
        context HERE so gateway wait, handoffs and any later requeue hops
        land in the same tree the decode replica's scheduling edges
        annotate — the request enters the replica through ``inject`` with
        its trace already attached instead of via ``batcher.submit``."""
        self._validate(prompt, max_tokens)
        if max_tokens == 0:
            return list(prompt)      # the batcher's mt==0 fast path
        req = _Pending(prompt, max_tokens, temperature, seed)
        req.model = model
        req.trace = self._tracer.begin(req.id, prompt_len=len(prompt),
                                       max_tokens=max_tokens, gateway=True)
        idx, decision = self._route(prompt, model=model)
        tm.GATEWAY_ROUTED.inc(replica=str(idx), policy=decision)
        tm.GATEWAY_QUEUE_WAIT.observe(
            time.monotonic() - req.submitted_at, tenant=req.tenant)
        req.trace.dispatched(replica=idx, decision=decision)
        if self._prefill is not None:
            self._maybe_handoff(idx, prompt, trace=req.trace)
        self.replicas[idx].batcher.inject([req], front=False)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def _resolve_model(self, model: str | None) -> str | None:
        """Validate a submit's model selector against the registered
        groups. None stays None when there is exactly one group (the
        pre-model fleet — routing ignores model entirely); with several
        groups an unnamed submit is ambiguous and gets the same typed
        rejection as an unknown name."""
        if model is None:
            if len(self._groups) == 1:
                return None
            raise UnknownModelError(model, self._identities())
        mid, _, ver = model.partition("@")
        group = self._groups.get(mid)
        if group is None or (ver and all(r.version != ver for r in group)):
            raise UnknownModelError(model, self._identities())
        return model

    def _identities(self) -> list[str]:
        return sorted({r.identity for r in self.replicas})

    def _validate(self, prompt: list[int], max_tokens: int) -> None:
        """The batcher's submit-side validation, applied here because the
        QoS path enters replicas through ``inject`` (which trusts its
        caller). Every replica engine is homogeneous by construction."""
        eng = self.replicas[0].batcher.engine
        if not prompt:
            raise ValueError("prompt_ids must be non-empty")
        if len(prompt) + max_tokens > eng.max_total:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceed max_seq_len ({eng.max_total})")
        if hasattr(eng, "pages_for"):
            need = eng.pages_for(len(prompt), max_tokens)
            if need > eng.max_request_pages:
                raise ValueError(
                    f"request needs {need} KV pages but one dp shard only "
                    f"has {eng.max_request_pages} allocatable "
                    f"(pages={eng.pages}, page={eng.page}): "
                    f"it could never be admitted")

    def _tenant(self, name: str) -> _Tenant:
        # unknown tenants get an unmetered default policy: identity and
        # per-tenant observability always work, limits are opt-in
        t = self._tenants.get(name)
        if t is None:
            # caller holds _lock: every _tenant call site runs inside _gcond/_lock
            t = self._tenants[name] = _Tenant(name)
        return t

    def _submit_qos(self, prompt: list[int], max_tokens: int,
                    temperature: float, seed: int, timeout: float | None,
                    tenant: str, priority: str | None,
                    deadline_s: float | None,
                    model: str | None = None) -> list[int]:
        self._validate(prompt, max_tokens)
        req = _Pending(prompt, max_tokens, temperature, seed)
        req.model = model
        with self._gcond:
            t = self._tenant(tenant)
            req.tenant = tenant
            req.priority = priority if priority is not None else t.priority
            if req.priority not in PRIORITIES:
                raise ValueError(f"priority must be one of {PRIORITIES}, "
                                 f"got {req.priority!r}")
            req.deadline_s = (float(deadline_s) if deadline_s is not None
                              else t.deadline_s)
            if self._tracer is not None and max_tokens > 0:
                req.trace = self._tracer.begin(
                    req.id, prompt_len=len(prompt), max_tokens=max_tokens,
                    gateway=True, tenant=tenant, priority=req.priority)
            t.refill(time.monotonic())
            # fifo mode is the no-QoS baseline: per-tenant accounting
            # only — admission never sheds, arrival order rules
            if self._qos_mode == "fair" \
                    and self._overloaded_locked() and t.tokens < 1.0:
                retry = t.retry_after()
                reason = ("deadline" if req.deadline_s is not None
                          and retry >= req.deadline_s else "rate")
                if req.trace is not None:
                    req.trace.shed(reason=reason, retry_after_s=retry)
                raise self._shed_locked(t, reason, retry)
            t.spend()
            t.submitted += 1
            if max_tokens == 0:
                # the batcher's mt==0 fast path, kept at the gateway so
                # the reply (= the prompt) never burns queue time
                t.finished += 1
                return list(prompt)
            if self._qos_mode == "fifo":
                self._fifo.append(req)
            else:
                if not t.queue:
                    # newly backlogged: forfeit idle credit so a tenant
                    # can't hoard virtual time and starve the others
                    t.vtime = max(t.vtime, self._vclock)
                t.queue.append(req)
            self._gcond.notify()
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        with self._lock:
            t.finished += 1
            if req.ttft_s is not None:
                t.ttft_samples.append(req.ttft_s)
            t.latency_samples.append(time.monotonic() - req.submitted_at)
        return req.result

    def _overloaded_locked(self) -> bool:
        return self.backlog() >= self._shed_after

    def _shed_locked(self, t: _Tenant, reason: str,
                     retry_after_s: float) -> ShedError:
        t.shed[reason] = t.shed.get(reason, 0) + 1
        # caller holds _lock: _shed_locked runs inside _submit_qos/_dispatch_one lock scopes
        self._shed_total += 1
        tm.SERVE_SHED.inc(tenant=t.name, reason=reason)
        FLIGHT.record_decision("shed", tenant=t.name, reason=reason,
                               retry_after_s=round(retry_after_s, 6))
        return ShedError(t.name, reason, retry_after_s)

    # -- routing ------------------------------------------------------------
    def _sticky_key(self, prompt: list[int]) -> int | None:
        span = self.affinity_pages * self._page
        if len(prompt) < span:
            return None      # no page-aligned prefix to be sticky about
        # tuples of ints hash deterministically (PYTHONHASHSEED only
        # perturbs str/bytes), so the home mapping is reproducible
        return hash(tuple(prompt[:span]))

    def _load_key(self, r: _Replica) -> tuple[int, int, int]:
        eng = r.batcher.engine
        cap = 0
        if hasattr(eng, "pages_for"):
            cap = sum(eng.free_pages(s) + eng.evictable_pages(s)
                      for s in range(max(1, int(getattr(eng, "dp", 1)))))
        return (r.batcher.backlog(), -cap, r.index)

    def _saturated(self, r: _Replica) -> bool:
        return r.batcher.backlog() >= self._spill_after

    def _members_locked(self, model: str | None) -> list[_Replica]:
        """The routing universe for a submit's model selector: the whole
        fleet (no selector / single group), one model's group (bare id),
        or one version cohort (full identity). A cohort emptied by a
        concurrent rollout commit re-raises the typed rejection — the
        caller asked for a version that no longer exists."""
        if model is None:
            return self.replicas
        mid, _, ver = model.partition("@")
        members = self._groups.get(mid, [])
        if ver:
            members = [r for r in members if r.version == ver]
        if not members:
            raise UnknownModelError(model, self._identities())
        return members

    def _route(self, prompt: list[int], requeue: bool = False,
               model: str | None = None) -> tuple[int, str]:
        with self._lock:
            members = self._members_locked(model)
            healthy = [r for r in members if not r.draining]
            if not healthy:
                raise RuntimeError(
                    "no healthy replicas: every gateway replica "
                    f"{'in group ' + model + ' ' if model else ''}"
                    "is draining")
            if self.policy == "round_robin":
                r = healthy[self._rr % len(healthy)]
                self._rr += 1
                return self._picked(r.index, "round_robin", requeue)
            if self.policy == "least_loaded":
                r = min(healthy, key=self._load_key)
                return self._picked(r.index, "least_loaded", requeue)
            key = self._sticky_key(prompt)
            if key is None:
                r = min(healthy, key=self._load_key)
                return self._picked(r.index, "least_loaded", requeue)
            # the sticky modulus is the group's full member list (not
            # just healthy, not just this version cohort) so the home
            # mapping survives drains AND rollout version churn
            home = members[key % len(members)]
            others = [r for r in healthy if r is not home]
            if not home.draining and (not self._saturated(home)
                                      or not others):
                if not requeue:
                    self._sticky_total += 1
                    self._sticky_hits += 1
                    self._set_affinity_locked()
                return self._picked(home.index, "sticky", requeue)
            if not requeue:
                self._sticky_total += 1
                self._set_affinity_locked()
            r = min(others, key=self._load_key)
            return self._picked(r.index, "spill", requeue)

    def _picked(self, idx: int, decision: str, requeue: bool
                ) -> tuple[int, str]:
        decision = "requeue" if requeue else decision
        # caller holds _lock: _picked only runs inside _route's lock scope
        self._routed[(idx, decision)] = self._routed.get((idx, decision),
                                                         0) + 1
        return idx, decision

    def _set_affinity_locked(self) -> None:
        if self._sticky_total:
            tm.GATEWAY_AFFINITY.set(self._sticky_hits / self._sticky_total)

    def affinity_ratio(self) -> float | None:
        """Fraction of sticky-eligible requests that landed on their
        hashed home replica (None before any eligible request)."""
        with self._lock:
            if not self._sticky_total:
                return None
            return self._sticky_hits / self._sticky_total

    # -- disaggregated prefill handoff --------------------------------------
    def _maybe_handoff(self, idx: int, prompt: list[int],
                       trace: Any = None) -> None:
        n = len(prompt) // self._page
        if n < self._handoff_min_pages:
            return
        aligned = tuple(prompt[:n * self._page])
        with self._lock:
            if aligned in self._handed[idx]:
                return
            self._handed[idx].add(aligned)   # claim before the slow part
        t0 = time.perf_counter()
        try:
            payload = self._prefill.prefill(list(aligned))
            pages = self.replicas[idx].batcher.handoff(
                payload["tokens"], payload.get("layers"))
        except Exception:
            with self._lock:
                self._handed[idx].discard(aligned)
            raise
        if pages:
            tm.GATEWAY_HANDOFF_PAGES.inc(pages)
            with self._lock:
                self._handoff_pages += pages
        if trace is not None:
            trace.handoff(pages=pages or 0,
                          seconds=time.perf_counter() - t0, replica=idx)

    # -- replica lifecycle --------------------------------------------------
    def drain_replica(self, index: int, reason: str = "replica_drain",
                      timeout: float | None = 60.0) -> list[str]:
        """Take one replica out of rotation: mark it draining (routing
        stops immediately), then drain every dp shard — its in-flight
        requests and stranded queue flow through the requeue sink into
        the gateway queue and re-route to healthy replicas. Returns the
        requeued request ids.

        Idempotent under concurrency: the ``draining`` flag is the drain
        claim, taken atomically under the gateway lock. A second caller
        racing the first (the rollout beat vs a revoke_slice chaos
        drain) loses the claim and returns ``[]`` immediately — the
        victims belong to whoever won, so they requeue exactly once."""
        r = self.replicas[index]
        with self._gcond:
            if r.draining:
                return []
            r.draining = True
        dp = max(1, int(getattr(r.batcher.engine, "dp", 1)))
        ids = r.batcher.drain(range(dp), reason=reason, timeout=timeout)
        with self._lock:
            self._requeued_total += len(ids)
        FLIGHT.record_decision("drain_replica", replica=index,
                               reason=reason, requeued=len(ids))
        return ids

    def readmit_replica(self, index: int) -> None:
        """Hand a drained replica back to the router (and wake the
        dispatcher in case requeued work was waiting for ANY healthy
        replica)."""
        r = self.replicas[index]
        r.batcher.readmit()
        with self._gcond:
            r.draining = False
            self._gcond.notify()
        FLIGHT.record_decision("readmit_replica", replica=index)

    def set_replica_version(self, index: int, version: str) -> None:
        """Rewrite one replica's version label — the rollout
        controller's commit point, called between ``drain_replica`` and
        ``readmit_replica`` once the new weights are installed. Group
        membership (the sticky modulus) is untouched."""
        if not version:
            raise ValueError("version must be non-empty")
        with self._lock:
            self.replicas[index].version = str(version)

    def model_snapshot(self) -> dict:
        """Replica-group topology for the rollout controller and the
        ``/api/v1/rollouts`` view: per model id, the member replicas
        with their current version + draining flag, and the version →
        indices cohort map the canary judge labels verdicts by."""
        with self._lock:
            out: dict[str, dict] = {}
            for mid in sorted(self._groups):
                members = self._groups[mid]
                versions: dict[str, list[int]] = {}
                for r in members:
                    versions.setdefault(r.version, []).append(r.index)
                out[mid] = {
                    "replicas": [{"index": r.index, "version": r.version,
                                  "draining": r.draining}
                                 for r in members],
                    "versions": {v: sorted(ix)
                                 for v, ix in sorted(versions.items())},
                }
            return out

    # -- gateway requeue path -----------------------------------------------
    def _sink(self, reqs: list) -> None:
        """A batcher's drain hand-off (called on ITS worker thread, its
        lock held): park the victims in the gateway queue. The dispatcher
        re-routes outside every batcher lock, so two replicas draining
        into each other can never deadlock."""
        with self._gcond:
            self._gq.extend(reqs)
            self._gcond.notify()

    def _dispatch_loop(self) -> None:
        while True:
            with self._gcond:
                batch, fresh = self._dispatch_wait_locked()
            if batch:
                self._reroute(batch)
            for req in fresh:
                self._dispatch_one(req)

    def _dispatch_wait_locked(self) -> tuple[list, list]:
        """Block until there is dispatchable work: requeue victims, or
        QoS-queued requests with somewhere to go. Batch-class work parked
        behind full replicas polls on a short timeout (nothing notifies
        the gateway when a replica retires a request)."""
        while True:
            alive = not all(r.draining for r in self.replicas)
            batch: list = []
            if alive and self._gq:
                batch = sorted(self._gq,
                               key=lambda r: (r.submitted_at, r.seq))
                self._gq.clear()
            fresh = self._dequeue_qos_locked() if alive else []
            if batch or fresh:
                return batch, fresh
            parked = alive and (bool(self._fifo) or any(
                t.queue for t in self._tenants.values()))
            self._gcond.wait(0.005 if parked else None)

    def _qos_room_locked(self) -> int:
        """How many more requests the healthy replicas can absorb before
        saturation — the dispatch budget for batch-class work, so one
        tenant's burst queues HERE (where fairness and shedding apply),
        not FIFO inside the replicas."""
        return sum(max(0, self._spill_after - r.batcher.backlog())
                   for r in self.replicas if not r.draining)

    def _dequeue_qos_locked(self) -> list:
        if not self.qos:
            return []
        room = self._qos_room_locked()
        if self._qos_mode == "fifo":
            out = []
            while self._fifo and room > 0:
                out.append(self._fifo.popleft())
                room -= 1
            return out
        out = []
        while True:
            ready = [t for t in self._tenants.values() if t.queue]
            pool = [t for t in ready if t.queue[0].priority == "latency"]
            if not pool and room > 0:
                pool = ready
            if not pool:
                return out
            t = min(pool, key=lambda x: (x.vtime, x.name))
            req = t.queue.popleft()
            if req.priority == "batch":
                room -= 1
            # caller holds _lock: _dequeue_qos_locked runs inside the dispatcher's _gcond wait scope
            self._vclock = t.vtime
            t.vtime += (len(req.prompt_ids) + req.max_tokens) / t.weight
            out.append(req)

    def _reroute(self, batch: list) -> None:
        """The requeue path: drained/preempted victims re-route and
        re-enter their new replica's queue at the head (they are the
        oldest requests in the cluster)."""
        groups: dict[int, list] = {}
        for i, req in enumerate(batch):
            try:
                idx, decision = self._route(req.prompt_ids, requeue=True,
                                            model=getattr(req, "model",
                                                          None))
            except RuntimeError:
                # lost the race with a concurrent drain_replica — park
                # the rest and wait for a readmit to wake us
                with self._gcond:
                    self._gq.extend(batch[i:])
                break
            tm.GATEWAY_ROUTED.inc(replica=str(idx), policy=decision)
            if req.trace is not None:
                # post-hop re-dispatch: the hop span is still open (the
                # next admission closes it) — note where the victim went
                req.trace.dispatched(replica=idx, decision=decision)
            groups.setdefault(idx, []).append(req)
        for idx, rs in groups.items():
            self.replicas[idx].batcher.inject(rs, front=True)

    def _dispatch_one(self, req) -> None:
        """Route one QoS-admitted request. Deadline-aware: a request
        that out-waited its ``deadline_s`` in the gateway queue sheds
        here (``expired``) instead of wasting a slot on a reply its
        client has abandoned. The fifo baseline never sheds."""
        if self._qos_mode == "fair" and req.deadline_s is not None and \
                time.monotonic() - req.submitted_at > req.deadline_s:
            with self._lock:
                t = self._tenant(req.tenant)
                t.refill(time.monotonic())
                req.error = self._shed_locked(t, "expired",
                                              max(t.retry_after(), 0.0))
            if req.trace is not None:
                req.trace.shed(reason="expired",
                               retry_after_s=req.error.retry_after_s)
            req.done.set()
            return
        try:
            idx, decision = self._route(req.prompt_ids,
                                        model=getattr(req, "model", None))
        except RuntimeError:
            # every replica draining: park as a requeue victim; a
            # readmit wakes the dispatcher and re-routes it
            with self._gcond:
                self._gq.append(req)
            return
        tm.GATEWAY_ROUTED.inc(replica=str(idx), policy=decision)
        tm.GATEWAY_QUEUE_WAIT.observe(
            time.monotonic() - req.submitted_at, tenant=req.tenant)
        if req.trace is not None:
            req.trace.dispatched(replica=idx, decision=decision)
        front = False
        if req.priority == "latency" and self._qos_mode == "fair":
            front = True        # latency class enters at the queue head
            self._maybe_preempt(idx)
        if self._prefill is not None:
            self._maybe_handoff(idx, req.prompt_ids, trace=req.trace)
        self.replicas[idx].batcher.inject([req], front=front)

    def _maybe_preempt(self, idx: int) -> None:
        """A latency-class request is about to land on replica ``idx``:
        if the replica has zero free slots and a batch-class victim in
        flight, evict the newest victim (least decode progress lost) so
        the latency request admits next wave instead of waiting out a
        whole batch decode."""
        r = self.replicas[idx]
        if r.batcher.free_slots() > 0:
            return
        victims = r.batcher.preemptible("batch")
        if not victims:
            return
        slot, victim = victims[0]
        try:
            r.batcher.preempt([slot], reason="preempt")
        except (TimeoutError, ValueError):
            return              # the victim retired first — nothing lost
        tm.SERVE_PREEMPTIONS.inc(tenant=victim.tenant)
        FLIGHT.record_decision("preempt", tenant=victim.tenant,
                               replica=idx, request=victim.id)
        with self._lock:
            self._tenant(victim.tenant).preempted += 1
            self._preempted_total += 1

    # -- observability -------------------------------------------------------
    def backlog(self) -> int:
        """Cluster-wide queued + in-flight requests (gateway requeue and
        QoS tenant queues included), same contract as
        ``ContinuousBatcher.backlog``."""
        return (len(self._gq) + len(self._fifo)
                + sum(len(t.queue) for t in self._tenants.values())
                + sum(r.batcher.backlog() for r in self.replicas))

    def tenant_snapshot(self) -> dict:
        """Per-tenant QoS state: admission counters, shed breakdown by
        reason, preemption victims, queue depth, and p95 TTFT/latency
        over the bounded sample windows (None before any observation)."""
        with self._lock:
            out: dict[str, dict] = {}
            for name in sorted(self._tenants):
                t = self._tenants[name]
                out[name] = {
                    "priority": t.priority,
                    "weight": t.weight,
                    "submitted": t.submitted,
                    "finished": t.finished,
                    "shed": dict(t.shed),
                    "shed_total": sum(t.shed.values()),
                    "preempted_total": t.preempted,
                    "queue_depth": len(t.queue),
                    "tokens": (None if t.rate == float("inf")
                               else round(t.tokens, 3)),
                    "ttft_p95_s": _p95(t.ttft_samples),
                    "latency_p95_s": _p95(t.latency_samples),
                }
            return out

    def snapshot(self) -> dict:
        with self._lock:
            routed: dict[str, dict[str, int]] = {}
            for (idx, decision), n in sorted(self._routed.items()):
                routed.setdefault(str(idx), {})[decision] = n
            return {
                "replicas": len(self.replicas),
                "policy": self.policy,
                "models": sorted({r.identity for r in self.replicas}),
                "draining": [r.index for r in self.replicas if r.draining],
                "routed": routed,
                "affinity_ratio": (self._sticky_hits / self._sticky_total
                                   if self._sticky_total else None),
                "handoff_pages": self._handoff_pages,
                "requeued_total": self._requeued_total,
                "gateway_queue_depth": len(self._gq),
                "qos": (self._qos_mode if self.qos else None),
                "tenants": len(self._tenants),
                "shed_total": self._shed_total,
                "preempted_total": self._preempted_total,
            }
