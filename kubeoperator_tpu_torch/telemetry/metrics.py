"""In-process metrics registry with Prometheus text exposition: the part
of ``kubeoperator_tpu/telemetry/metrics.py`` the workload layer needs
(``Counter``, ``Gauge``, ``Histogram``, ``Summary``, ``Registry``, the
process-wide ``REGISTRY``, the ``ko_serve_*`` vocabulary and the
``ko_train_*`` one with ``record_train_step``), copied so the port imports
nothing of the JAX package. The families, names, labels and exposition
format are the reference's, so one ``/metrics`` scrape reads the same on
both, but for four ``ko_train_*`` families the reference lacks: the step
phases that ``tracing.StepPhases`` records in the port's trainers
(``ko_train_steps_total``, ``ko_train_phase_host_seconds_total``,
``ko_train_phase_device_seconds_total``, ``ko_train_phase_skipped_total``).
The cluster tier's ``ko_gateway_*`` families and the QoS ones
(``ko_serve_shed_total``, ``ko_serve_preemptions_total``), which
``cluster/gateway.py`` sets on the process ``REGISTRY``, are the
reference's too. The control-plane families the reference declares on
its ``REGISTRY`` (SLOs, scenarios, the autoscaler, rollouts) are not part
of the workload layer and are not copied.

Design points:

* label sets are declared at metric creation and enforced on every sample
  call — a typo'd label name raises instead of silently minting a new
  series;
* every family emits its ``# HELP``/``# TYPE`` header even with zero
  samples, so scrapers see the full vocabulary from boot;
* per-metric locks make updates safe from the batcher's worker and the
  HTTP handler threads.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left, insort
from typing import Iterable

# Latency buckets from 5 ms to five minutes: the reference's default, which
# the TTFT histogram keeps so both packages bucket it alike.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0,
)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_suffix(names: tuple[str, ...], values: tuple[str, ...],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{k}="{_escape_label(v)}"' for k, v in zip(names, values)]
    pairs += [f'{k}="{_escape_label(v)}"' for k, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class Metric:
    """Base family: a name, a help string, declared label names, and one
    sample slot per observed label-value tuple."""

    type = "untyped"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._samples: dict[tuple[str, ...], object] = {}

    def _key(self, label_values: dict) -> tuple[str, ...]:
        if set(label_values) != set(self.labels):
            raise ValueError(
                f"{self.name}: got labels {sorted(label_values)}, "
                f"declared {sorted(self.labels)}")
        return tuple(str(label_values[k]) for k in self.labels)

    def samples(self) -> dict[tuple[str, ...], object]:
        with self._lock:
            return dict(self._samples)

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()

    def render(self) -> list[str]:
        raise NotImplementedError


class Counter(Metric):
    type = "counter"

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def value(self, **labels: object) -> float:
        with self._lock:
            return float(self._samples.get(self._key(labels), 0.0))

    def render(self) -> list[str]:
        with self._lock:
            return [f"{self.name}{_labels_suffix(self.labels, key)} "
                    f"{_format_value(v)}"
                    for key, v in sorted(self._samples.items())]


class Gauge(Metric):
    type = "gauge"

    def set(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._samples[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: object) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: object) -> float:
        with self._lock:
            return float(self._samples.get(self._key(labels), 0.0))

    def render(self) -> list[str]:
        with self._lock:
            return [f"{self.name}{_labels_suffix(self.labels, key)} "
                    f"{_format_value(v)}"
                    for key, v in sorted(self._samples.items())]


class Histogram(Metric):
    type = "histogram"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets = tuple(bounds)

    def observe(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            slot = self._samples.get(key)
            if slot is None:
                slot = {"counts": [0] * len(self.buckets), "sum": 0.0,
                        "count": 0}
                self._samples[key] = slot
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    slot["counts"][i] += 1
                    break
            slot["sum"] += value
            slot["count"] += 1

    def count(self, **labels: object) -> int:
        with self._lock:
            slot = self._samples.get(self._key(labels))
            return slot["count"] if slot else 0

    def sum(self, **labels: object) -> float:
        with self._lock:
            slot = self._samples.get(self._key(labels))
            return slot["sum"] if slot else 0.0

    def render(self) -> list[str]:
        lines: list[str] = []
        with self._lock:
            for key, slot in sorted(self._samples.items()):
                cumulative = 0
                for bound, n in zip(self.buckets, slot["counts"]):
                    cumulative += n
                    le = (("le", _format_value(bound)),)
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_labels_suffix(self.labels, key, le)} {cumulative}")
                lines.append(f"{self.name}_sum{_labels_suffix(self.labels, key)} "
                             f"{_format_value(slot['sum'])}")
                lines.append(f"{self.name}_count{_labels_suffix(self.labels, key)} "
                             f"{slot['count']}")
        return lines


class Summary(Metric):
    """Quantile-labelled summary over a bounded sliding reservoir — the
    Prometheus summary type (``name{quantile="0.5"}`` series plus
    ``_sum``/``_count``). Quantiles are computed over the last ``window``
    observations, so they track current load rather than process history
    (the serving batcher's p50/p95 semantics)."""

    type = "summary"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = (),
                 quantiles: tuple[float, ...] = (0.5, 0.95),
                 window: int = 512):
        super().__init__(name, help, labels)
        self.quantiles = tuple(quantiles)
        self.window = int(window)

    def observe(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            slot = self._samples.get(key)
            if slot is None:
                slot = {"sorted": [], "order": [], "sum": 0.0, "count": 0}
                self._samples[key] = slot
            v = float(value)
            insort(slot["sorted"], v)
            slot["order"].append(v)
            if len(slot["order"]) > self.window:
                old = slot["order"].pop(0)
                del slot["sorted"][bisect_left(slot["sorted"], old)]
            slot["sum"] += v
            slot["count"] += 1

    def quantile(self, q: float, **labels: object) -> float:
        with self._lock:
            slot = self._samples.get(self._key(labels))
            if not slot or not slot["sorted"]:
                return 0.0
            i = min(len(slot["sorted"]) - 1, int(q * len(slot["sorted"])))
            return slot["sorted"][i]

    def count(self, **labels: object) -> int:
        with self._lock:
            slot = self._samples.get(self._key(labels))
            return slot["count"] if slot else 0

    def render(self) -> list[str]:
        lines: list[str] = []
        with self._lock:
            for key, slot in sorted(self._samples.items()):
                for q in self.quantiles:
                    data = slot["sorted"]
                    v = (data[min(len(data) - 1, int(q * len(data)))]
                         if data else 0.0)
                    qs = (("quantile", _format_value(q)),)
                    lines.append(f"{self.name}"
                                 f"{_labels_suffix(self.labels, key, qs)} "
                                 f"{_format_value(v)}")
                lines.append(f"{self.name}_sum{_labels_suffix(self.labels, key)} "
                             f"{_format_value(slot['sum'])}")
                lines.append(f"{self.name}_count"
                             f"{_labels_suffix(self.labels, key)} "
                             f"{slot['count']}")
        return lines


class Registry:
    """Holds metric families in registration order. Re-declaring a name
    with the same type and labels returns the existing family (module
    reloads under pytest importmode quirks must not double-register);
    re-declaring with a different shape is a programming error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _register(self, cls, name: str, help: str,
                  labels: tuple[str, ...], **kwargs) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labels != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type}{existing.labels}")
                return existing
            m = cls(name, help, tuple(labels), **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str,
                labels: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str,
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str, labels: tuple[str, ...] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets)

    def summary(self, name: str, help: str, labels: tuple[str, ...] = (),
                quantiles: tuple[float, ...] = (0.5, 0.95),
                window: int = 512) -> Summary:
        return self._register(Summary, name, help, labels,
                              quantiles=quantiles, window=window)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._metrics)

    def get(self, name: str) -> Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Clear every family's samples (tests); families stay declared."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: list[str] = []
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.type}")
            out.extend(m.render())
        return "\n".join(out) + "\n"


# the process-wide registry: the serve job's batcher stats and the training
# jobs' step metrics record here, so one /metrics scrape covers a pod
REGISTRY = Registry()


# -- serving-plane families (workloads/serving.BatcherStats) ----------------
# Fused-batch sizes and continuous-engine slot counts; power-of-two edges
# matching the batcher's bucketing rule.
SERVE_BATCH_BUCKETS: tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64)
# One decode segment takes milliseconds to seconds; start finer than
# DEFAULT_BUCKETS' 5 ms floor.
SERVE_SEGMENT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def declare_serve_metrics(registry: Registry, window: int = 512) -> dict:
    """Declare the ``ko_serve_*`` vocabulary on ``registry`` and return the
    families keyed by short name. Each BatcherStats instance owns a private
    Registry by default (independent batchers must not share counters);
    the serve job passes its one registry so a ``/metrics`` scrape covers
    the whole process."""
    return {
        "requests": registry.counter(
            "ko_serve_requests_total",
            "Generation requests finished, ok or error."),
        "errors": registry.counter(
            "ko_serve_errors_total",
            "Generation requests that finished with an error."),
        "batches": registry.counter(
            "ko_serve_batches_total",
            "Device dispatches: fused batches (dynamic) or decode "
            "segments (continuous)."),
        "tokens": registry.counter(
            "ko_serve_tokens_generated_total",
            "New tokens delivered to finished requests."),
        "queue_depth": registry.gauge(
            "ko_serve_queue_depth",
            "Requests submitted but not yet finished (queued or in "
            "flight)."),
        "latency": registry.summary(
            "ko_serve_request_latency_seconds",
            "End-to-end request latency, submit to tokens (sliding "
            "window).",
            window=window),
        "batch_size": registry.histogram(
            "ko_serve_batch_size",
            "Rows per device dispatch (dynamic: fused batch; continuous: "
            "active slots per segment).",
            buckets=SERVE_BATCH_BUCKETS),
        "slot_occupancy": registry.gauge(
            "ko_serve_slot_occupancy",
            "Occupied decode slots in the continuous engine's pool, per "
            "dp mesh shard (shard=\"0\" when serving single-chip).",
            labels=("shard",)),
        "ttft": registry.histogram(
            "ko_serve_ttft_seconds",
            "Time from submit to a request's first generated token "
            "(continuous engine)."),
        "segment": registry.histogram(
            "ko_serve_segment_duration_seconds",
            "Wall time of one decode-segment dispatch (continuous "
            "engine).",
            buckets=SERVE_SEGMENT_BUCKETS),
        "kv_pages_used": registry.gauge(
            "ko_serve_kv_pages_used",
            "KV-cache pages allocated to live slots or the prefix cache, "
            "per dp mesh shard (paged continuous engine; excludes the "
            "reserved trash page).",
            labels=("shard",)),
        "prefix_hits": registry.counter(
            "ko_serve_prefix_hits_total",
            "Admissions that reused cached prompt-prefix pages (their "
            "prefill was skipped; paged continuous engine)."),
        "kv_spill_pages": registry.gauge(
            "ko_serve_kv_spill_pages",
            "KV pages currently parked in the host-RAM prefix-cache "
            "spill tier, per dp mesh shard (paged continuous engine).",
            labels=("shard",)),
        "kv_demotions": registry.counter(
            "ko_serve_kv_demotions_total",
            "Cold prefix-cache entries demoted from device HBM into the "
            "host-RAM spill tier at LRU eviction instead of dropped."),
        "kv_promoted_hits": registry.counter(
            "ko_serve_kv_promoted_hits_total",
            "Admissions whose prompt prefix hit a demoted entry and was "
            "gathered host->device instead of recomputed."),
        "requeued": registry.counter(
            "ko_serve_requests_requeued_total",
            "In-flight requests snapshotted off drained slots and pushed "
            "back to the queue head instead of dropped, by reason "
            "(drain | slice_revoked | scale_down).",
            labels=("reason",)),
        "segment_device": registry.histogram(
            "ko_serve_segment_device_seconds",
            "Device share of one decode segment: dispatch to the ready "
            "signal the retirement fetch observes (continuous engine).",
            buckets=SERVE_SEGMENT_BUCKETS),
        "host_blocked": registry.histogram(
            "ko_serve_host_blocked_seconds",
            "Host-blocked share of retirement: time the worker waited in "
            "the batched result fetch, per dp mesh shard retiring rows.",
            labels=("shard",),
            buckets=SERVE_SEGMENT_BUCKETS),
        "spec_draft": registry.counter(
            "ko_serve_spec_draft_tokens_total",
            "Draft tokens proposed by speculative-decode dispatches "
            "(continuous engine with spec_k > 0)."),
        "spec_accepted": registry.counter(
            "ko_serve_spec_accepted_tokens_total",
            "Draft tokens the target model verified and committed "
            "(always <= draft tokens proposed)."),
        "spec_acceptance": registry.gauge(
            "ko_serve_spec_acceptance_ratio",
            "Cumulative accepted/drafted ratio of speculative decoding "
            "(0 before any dispatch; 1.0 means every draft committed)."),
        "moe_expert_load": registry.gauge(
            "ko_serve_moe_expert_load",
            "Cumulative tokens dispatched to each MoE expert by the "
            "serving engine, per expert index.",
            labels=("expert",)),
    }


# -- training-plane families (train/jobs.py) --------------------------------
# One training step spans ~1 ms (tiny CPU runs) to minutes (large models
# through cold caches); start finer than DEFAULT_BUCKETS.
TRAIN_STEP_BUCKETS: tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


def declare_train_metrics(registry: Registry) -> dict:
    """Declare the ``ko_train_*`` vocabulary on ``registry`` and return the
    families keyed by short name: the train-plane mirror of
    :func:`declare_serve_metrics`."""
    return {
        "step": registry.histogram(
            "ko_train_step_seconds",
            "Wall-clock duration of one optimizer step (fwd + bwd + "
            "update), per workload.",
            labels=("workload",), buckets=TRAIN_STEP_BUCKETS),
        "collective": registry.counter(
            "ko_train_collective_seconds",
            "Seconds attributed to inter-chip collectives per step, by "
            "collective family (all_gather | reduce_scatter | ppermute | "
            "all_reduce); cost-model derived on CPU meshes, profiler-"
            "derived on device.",
            labels=("workload", "collective")),
        "mfu": registry.gauge(
            "ko_train_mfu",
            "Model FLOPs utilization of the last measured step window, "
            "per workload (model FLOPs / peak FLOPs of the mesh).",
            labels=("workload",)),
        # the port's own: the trainers' step phases (tracing.StepPhases)
        "steps": registry.counter(
            "ko_train_steps_total",
            "Train steps the trainer's train_step ran, per workload.",
            labels=("workload",)),
        "phase_host": registry.counter(
            "ko_train_phase_host_seconds_total",
            "Host wall seconds inside each phase of a train step (step | "
            "forward | backward | grad_reduce | optimizer | metrics; step "
            "holds the others), per workload.",
            labels=("workload", "phase")),
        "phase_device": registry.counter(
            "ko_train_phase_device_seconds_total",
            "Device seconds of each phase of a train step, from timing "
            "events on the step's stream at each phase's entry and the "
            "step's end (marker to marker: a phase's idle time on the card "
            "included); counted once the card has passed them, per "
            "workload.",
            labels=("workload", "phase")),
        "phase_skipped": registry.counter(
            "ko_train_phase_skipped_total",
            "Train steps whose device markers were dropped because the "
            "trainer's pool of timing events ran empty, per workload.",
            labels=("workload",)),
    }


def record_train_step(workload: str, step_seconds: float,
                      mfu: float | None = None,
                      collective_seconds: dict[str, float] | None = None,
                      registry: Registry | None = None) -> None:
    """One call per measured step window: observes the step histogram and
    updates the collective counters and the MFU gauge, on ``registry`` or
    the process ``REGISTRY``."""
    fams = declare_train_metrics(registry if registry is not None else REGISTRY)
    fams["step"].observe(float(step_seconds), workload=workload)
    if mfu is not None:
        fams["mfu"].set(float(mfu), workload=workload)
    for kind, secs in (collective_seconds or {}).items():
        if secs > 0:
            fams["collective"].inc(float(secs), workload=workload,
                                   collective=kind)


# -- compile-cache families (aot/cache.py) -----------------------------------
# Bring-up spans loading a stored kernel library (milliseconds) to an nvcc
# build of one (tens of seconds); the reference's buckets.
AOT_BRINGUP_BUCKETS: tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0, 180.0,
    600.0)


def declare_aot_metrics(registry: Registry) -> dict:
    """Declare the ``ko_aot_*`` vocabulary on ``registry`` and return the
    families keyed by short name. The port's ``CompileCache`` records one
    sample per library it consults into the process ``REGISTRY``, so a
    scrape of any worker shows whether its bring-up loaded its kernel
    libraries or built them."""
    return {
        "hits": registry.counter(
            "ko_aot_cache_hits_total",
            "Compile-cache consults that loaded a stored kernel library "
            "(no nvcc run), by library.",
            labels=("fn",)),
        "misses": registry.counter(
            "ko_aot_cache_misses_total",
            "Compile-cache consults that built the kernel library with "
            "nvcc (entry absent, corrupt, or built by another toolkit), "
            "by library.",
            labels=("fn",)),
        "bringup": registry.histogram(
            "ko_aot_bringup_seconds",
            "Wall-clock bring-up of one kernel library through the compile "
            "cache: check and load on a hit, nvcc build and publish on a "
            "miss.",
            labels=("fn", "outcome"), buckets=AOT_BRINGUP_BUCKETS),
    }


def record_aot_event(fn: str, *, hit: bool, seconds: float,
                     registry: Registry | None = None) -> None:
    """One call per library a ``CompileCache`` consults: bump the hit or
    miss counter and observe the bring-up histogram."""
    fams = declare_aot_metrics(registry if registry is not None else REGISTRY)
    (fams["hits"] if hit else fams["misses"]).inc(fn=fn)
    fams["bringup"].observe(float(seconds), fn=fn,
                            outcome="hit" if hit else "miss")


# -- cluster gateway families (cluster/gateway.py) --------------------------
# Set by the ServeGateway fronting N batcher replicas: routing decisions,
# prefix-affinity quality and disaggregated page handoffs, on the
# process-global REGISTRY so one scrape covers the whole cluster tier.
GATEWAY_ROUTED = REGISTRY.counter(
    "ko_gateway_requests_routed_total",
    "Requests the cluster gateway routed, by target replica and routing "
    "decision (sticky | spill | requeue | round_robin | least_loaded).",
    labels=("replica", "policy"))
GATEWAY_AFFINITY = REGISTRY.gauge(
    "ko_gateway_prefix_affinity_ratio",
    "Fraction of sticky-eligible requests that landed on their hashed "
    "prefix's home replica (spill-over and drains erode it).")
GATEWAY_HANDOFF_PAGES = REGISTRY.counter(
    "ko_gateway_handoff_pages_total",
    "Whole KV pages shipped from disaggregated prefill workers into "
    "decode replicas' prefix caches as block-table page lists.")
# A gateway dequeue is sub-ms on an idle cost model but stretches to
# many seconds for batch-class work parked behind full replicas; start
# finer than DEFAULT_BUCKETS and keep its tail.
GATEWAY_WAIT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 15.0, 60.0)
GATEWAY_QUEUE_WAIT = REGISTRY.histogram(
    "ko_gateway_queue_wait_seconds",
    "Time one request spent in the gateway tier before dispatch to a "
    "replica (QoS admission + weighted-fair queue wait, measured at "
    "dispatch), by tenant.",
    labels=("tenant",), buckets=GATEWAY_WAIT_BUCKETS)

# -- multi-tenant QoS families (cluster/gateway.py) -------------------------
# Set by the gateway's tenant admission and preemption paths, on the
# process-global REGISTRY like the other gateway families.
SERVE_SHED = REGISTRY.counter(
    "ko_serve_shed_total",
    "Requests deliberately rejected by the gateway's QoS admission, by "
    "tenant and reason (rate = over the tenant's token bucket at cluster "
    "saturation, deadline = the required backoff exceeds the request's "
    "deadline, expired = the request out-waited its deadline queued). "
    "Every shed carries a retry_after_s hint.",
    labels=("tenant", "reason"))
SERVE_PREEMPTIONS = REGISTRY.counter(
    "ko_serve_preemptions_total",
    "Batch-class in-flight requests evicted mid-decode so a latency-class "
    "request could take the slot, by victim tenant (victims requeue and "
    "re-prefill with bit-identical replies).",
    labels=("tenant",))


# declared at import, as the reference does, so a scrape of the process
# registry shows every vocabulary from boot
declare_serve_metrics(REGISTRY)
declare_train_metrics(REGISTRY)
declare_aot_metrics(REGISTRY)
