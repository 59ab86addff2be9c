"""Span trees, the part of ``kubeoperator_tpu/telemetry/tracing.py`` the
serving plane needs: ``Span``, ``Trace``, ``TraceRecord`` and
``DEFAULT_MAX_SPANS``, with private copies of the three helpers they use
(``new_id``, ``iso``, ``get_logger``), so the port imports nothing of the
JAX package. The serialized spans (``Span.to_dict``) and records are the
reference's, key for key.

Spans record monotonic (``perf_counter``) durations plus events, relative
to their trace's origin, so a serialized tree orders deterministically
without wall-clock skew. The execution tracer of the reference's
operation engine (``trace``, ``span``, ``add_event``, ``format_trace``)
belongs to the control plane, which stays the JAX package's, and is not
copied.

``StepPhases`` is the port's own: the phases of a trainer's train step
(``step``, holding ``forward``, ``backward``, ``grad_reduce``,
``optimizer`` and ``metrics``) as profiler ranges, host seconds and, on
the card, device seconds, into the ``ko_train_*`` families of
``metrics.declare_train_metrics``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

import torch

from kubeoperator_tpu_torch.telemetry.metrics import (
    REGISTRY, Registry, declare_train_metrics,
)

DEFAULT_MAX_SPANS = 4000

FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"
_log_lock = threading.Lock()
_log_ready = False


def new_id() -> str:
    """A random hex id (a span's or a record's)."""
    return uuid.uuid4().hex


def iso(dt: datetime | None = None) -> str:
    """``dt`` (default: now, UTC) in ISO 8601."""
    return (dt or datetime.now(timezone.utc)).isoformat()


def get_logger(name: str) -> logging.Logger:
    """A logger under the port's tree, whose root gets one stream handler
    at the level of ``KO_LOG_LEVEL`` (default INFO) on first use."""
    global _log_ready
    if not _log_ready:
        with _log_lock:
            if not _log_ready:
                root = logging.getLogger("kubeoperator_tpu_torch")
                h = logging.StreamHandler()
                h.setFormatter(logging.Formatter(FORMAT))
                root.addHandler(h)
                level = os.environ.get("KO_LOG_LEVEL", "INFO")
                try:
                    root.setLevel(level.upper())
                except (ValueError, TypeError):
                    root.setLevel(logging.INFO)
                _log_ready = True
    return logging.getLogger(name)


class Trace:
    """Span collector of one tree. Offsets are relative to the trace's
    ``perf_counter`` origin; past ``max_spans`` a span is not kept and
    ``dropped`` counts it."""

    def __init__(self, trace_id: str, max_spans: int = DEFAULT_MAX_SPANS):
        self.trace_id = trace_id
        self.t0 = time.perf_counter()
        self.max_spans = max_spans
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def record(self, span: "Span") -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            self._spans.append(span)

    def to_dicts(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in
                    sorted(self._spans, key=lambda s: s.start_offset_s)]


class Span:
    def __init__(self, name: str, kind: str, trace: Trace,
                 parent_id: str = "", attributes: dict | None = None):
        self.name = name
        self.kind = kind
        self.trace_id = trace.trace_id
        self.span_id = new_id()[:16]
        self.parent_id = parent_id
        self.started_at = iso()
        self.status = "ok"
        self.attributes: dict[str, Any] = dict(attributes or {})
        self.events: list[dict] = []
        self.duration_s: float = 0.0
        self._trace = trace
        self._t0 = time.perf_counter()
        self.start_offset_s = round(self._t0 - trace.t0, 6)

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({
            "name": name,
            "offset_s": round(time.perf_counter() - self._trace.t0, 6),
            **attrs,
        })

    def finish(self) -> None:
        self.duration_s = round(time.perf_counter() - self._t0, 6)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "kind": self.kind,
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "started_at": self.started_at,
            "start_offset_s": self.start_offset_s,
            "duration_s": self.duration_s, "status": self.status,
            "attributes": self.attributes, "events": self.events,
        }


@dataclass
class TraceRecord:
    """One finished span tree (``name`` = the trace's id: a serve
    request's id)."""

    KIND = "trace"
    project: str | None = None
    name: str = ""
    operation: str = ""
    spans: list = field(default_factory=list)
    dropped: int = 0
    id: str = field(default_factory=new_id)
    created_at: str = field(default_factory=iso)


# -- train-step phases --------------------------------------------------------

STEP = "step"
RANGE_PREFIX = "ko.train."
EVENT_POOL = 64     # timing events a trainer keeps: nine steps of markers


class _Phase:
    __slots__ = ("owner", "name", "t0", "range")

    def __init__(self, owner: "StepPhases", name: str):
        self.owner, self.name, self.range = owner, name, None

    def __enter__(self) -> "_Phase":
        self.owner._enter(self)
        return self

    def __exit__(self, *exc) -> None:
        self.owner._exit(self)


class StepPhases:
    """The phases of one workload's train steps. ``step()`` opens the
    parent; inside it ``phase(name)`` opens a child (a name may recur in a
    step: its times add). A phase's duration holds its children's; its self
    time is the difference. Each phase is

    * a ``torch.profiler`` range ``ko.train.<name>``, entered only while a
      profiler records (an inactive ``record_function`` costs more than
      the phase's other bookkeeping), so its host span and the kernels it
      launched share the profiler's clock;
    * host seconds (``perf_counter`` from entry to exit), added at the
      step's end to ``ko_train_phase_host_seconds_total{workload, phase}``;
    * on a CUDA device, a timing event from a pool that is reused (made on
      first need, so a trainer built for the card allocates nothing), recorded
      on the step's stream at each phase's entry and at the step's end.
      Each interval from one marker to the next counts towards every phase
      open at its first marker, so on the card the phases tile the step,
      each holding the idle time its host work left; a phase's exit marks
      nothing (one event fewer a phase), so the card's time between two
      phases counts towards the earlier one (between the trainers' phases
      the host only does bookkeeping). A step whose last marker the card
      has passed (``query()``) is read at the next step's entry, or by
      ``flush()``, which the caller runs after a synchronize, into
      ``ko_train_phase_device_seconds_total``. A step that finds the pool
      empty gives its markers back and counts in
      ``ko_train_phase_skipped_total``: a step never waits on the card.

    ``ko_train_steps_total`` counts the steps."""

    def __init__(self, workload: str, device: Any = None,
                 registry: Registry | None = None):
        self.workload = workload
        self.device = torch.device("cpu" if device is None else device)
        fams = declare_train_metrics(REGISTRY if registry is None
                                     else registry)
        self._steps, self._skipped = fams["steps"], fams["phase_skipped"]
        self._host_s, self._device_s = fams["phase_host"], fams["phase_device"]
        self._free: list = []            # events made and not in use
        self._unmade = EVENT_POOL if self.device.type == "cuda" else 0
        self._pending: deque = deque()   # finished steps' markers
        self._open: list[str] = []       # the phases open now, outermost first
        self._marks: list | None = None  # this step's [(event, open phases)]
        self._host: dict[str, float] = {}
        self._stream = None

    def step(self) -> _Phase:
        return _Phase(self, STEP)

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def flush(self) -> None:
        """Count every step whose markers the card has passed; after a
        synchronize, every step."""
        while self._pending and self._pending[0][-1][0].query():
            self._read(self._pending.popleft())

    def mean_step_seconds(self) -> float | None:
        """The mean step of the workload's counters: on the card the
        device seconds over the steps marked (read them after a synchronize
        and ``flush()``), else the host seconds over the steps; None before
        the first step."""
        w = self.workload
        steps = self._steps.value(workload=w)
        if self.device.type == "cuda":
            steps -= self._skipped.value(workload=w)
            spent = self._device_s.value(workload=w, phase=STEP)
        else:
            spent = self._host_s.value(workload=w, phase=STEP)
        return spent / steps if steps > 0 else None

    # -- internals ------------------------------------------------------------
    def _enter(self, p: _Phase) -> None:
        if not self._open:
            self._begin()
        if torch.autograd._profiler_enabled():
            p.range = torch.autograd.profiler.record_function(
                RANGE_PREFIX + p.name)
            p.range.__enter__()
        self._open.append(p.name)
        self._mark()
        p.t0 = time.perf_counter()

    def _exit(self, p: _Phase) -> None:
        dt = time.perf_counter() - p.t0
        self._open.pop()
        if not self._open:
            self._mark()
        if p.range is not None:
            p.range.__exit__(None, None, None)
            p.range = None
        self._host[p.name] = self._host.get(p.name, 0.0) + dt
        if not self._open:
            self._end()

    def _begin(self) -> None:
        self._host = {}
        if self.device.type != "cuda":
            return
        self.flush()
        self._marks = []
        self._stream = torch.cuda.current_stream(self.device)

    def _mark(self) -> None:
        if self._marks is None:
            return
        if not self._free and self._unmade:     # made on first need
            self._unmade -= 1
            self._free.append(torch.cuda.Event(enable_timing=True))
        if not self._free:          # the card is steps behind
            self._free.extend(ev for ev, _ in self._marks)
            self._marks = None
            self._skipped.inc(workload=self.workload)
            return
        ev = self._free.pop()
        ev.record(self._stream)
        self._marks.append((ev, tuple(self._open)))

    def _end(self) -> None:
        w = self.workload
        for name, s in self._host.items():
            self._host_s.inc(s, workload=w, phase=name)
        self._steps.inc(workload=w)
        if self._marks:
            self._pending.append(self._marks)
        self._marks = None

    def _read(self, marks: list) -> None:
        spent: dict[str, float] = {}
        for (a, names), (b, _) in zip(marks, marks[1:]):
            dt = a.elapsed_time(b) / 1e3
            for name in names:
                spent[name] = spent.get(name, 0.0) + dt
        for name, s in spent.items():
            self._device_s.inc(s, workload=self.workload, phase=name)
        self._free.extend(ev for ev, _ in marks)
