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
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

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
