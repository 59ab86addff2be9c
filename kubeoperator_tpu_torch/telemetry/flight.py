"""Incident flight recorder, the counterpart of
``kubeoperator_tpu/telemetry/flight.py``: bounded always-on history,
dumped on demand.

By the time a human looks at a breach, the gateway's shed and preempt
decisions and the slow traces that caused it have aged out of their
per-process rings. The ``FlightRecorder`` keeps a bounded copy of each
(history points, SLO edges, gateway QoS decisions) and on demand
assembles them plus the slowest stitched serve traces into one
diagnostic bundle (``FLIGHT_<ts>.json``, written by ``dump()``). In the
port the gateway records its decisions here (shed, preempt,
drain_replica, readmit_replica); the monitor beat and scenario harness
that also feed and dump it in the reference belong to the control plane,
which stays the JAX package's.

Recording is host-side deque appends under one lock: safe from the
gateway's dispatch thread and its callers at once, and cheap enough to
stay always on (the recorder is a ring, not a log).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any

from kubeoperator_tpu_torch.telemetry.tracing import get_logger, iso

log = get_logger(__name__)

#: ring capacities: a day of 5-min monitor points, and enough QoS
#: decisions/SLO edges to cover the window that produced them
DEFAULT_POINTS = 288
DEFAULT_EVENTS = 128
DEFAULT_DECISIONS = 512
#: stitched traces included per bundle, slowest first
SLOWEST_TRACES = 3


class FlightRecorder:
    """Bounded rings of recent evidence plus the dump that freezes them."""

    def __init__(self, *, points: int = DEFAULT_POINTS,
                 events: int = DEFAULT_EVENTS,
                 decisions: int = DEFAULT_DECISIONS,
                 trace_store=None, out_dir: str | None = None):
        self._lock = threading.Lock()
        self._points: deque[dict] = deque(maxlen=max(1, int(points)))
        self._events: deque[dict] = deque(maxlen=max(1, int(events)))
        self._decisions: deque[dict] = deque(maxlen=max(1, int(decisions)))
        self._trace_store = trace_store
        self.out_dir = out_dir
        self.dumps = 0
        self.last_bundle: str | None = None

    # -- recording edges -----------------------------------------------------
    def record_point(self, point: dict) -> None:
        """One monitor/scenario history point (already time-stamped)."""
        with self._lock:
            self._points.append(dict(point))

    def record_event(self, event: dict) -> None:
        """One SLO state-transition edge from ``evaluate_slos``."""
        with self._lock:
            self._events.append(dict(event))

    def record_decision(self, kind: str, **attrs: Any) -> None:
        """One gateway QoS decision (shed, preempt, drain, readmit…)."""
        with self._lock:
            self._decisions.append({"kind": kind, "at": iso(), **attrs})

    def clear(self) -> None:
        with self._lock:
            self._points.clear()
            self._events.clear()
            self._decisions.clear()
            self.dumps = 0
            self.last_bundle = None

    # -- the bundle ----------------------------------------------------------
    def _store(self):
        if self._trace_store is not None:
            return self._trace_store
        from kubeoperator_tpu_torch.telemetry.serve_trace import SERVE_TRACES
        return SERVE_TRACES

    def snapshot(self, reason: str = "on_demand") -> dict:
        """The bundle as a dict: the three rings frozen plus the slowest
        stitched serve traces, newest evidence last in each list."""
        from kubeoperator_tpu_torch.telemetry.serve_trace import render_record
        with self._lock:
            points = [dict(p) for p in self._points]
            events = [dict(e) for e in self._events]
            decisions = [dict(d) for d in self._decisions]
        return {
            "version": 1,
            "reason": reason,
            "dumped_at": iso(),
            "points": points,
            "events": events,
            "decisions": decisions,
            "slowest_traces": [render_record(r) for r in
                               self._store().slowest(SLOWEST_TRACES)],
        }

    def dump(self, reason: str = "on_demand",
             out_dir: str | None = None) -> str:
        """Write ``FLIGHT_<ts>.json`` and return its path. Telemetry must
        never take the caller down: an unwritable directory logs and
        falls back to the working directory before giving up."""
        bundle = self.snapshot(reason)
        root = out_dir or self.out_dir or os.environ.get(
            "KO_FLIGHT_DIR") or "."
        with self._lock:
            self.dumps += 1
            seq = self.dumps
        ts = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(root, f"FLIGHT_{ts}-{seq:03d}.json")
        try:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, indent=1)
                fh.write("\n")
        except OSError:
            log.exception("flight-recorder dump to %s failed", path)
            path = f"FLIGHT_{ts}-{seq:03d}.json"
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, indent=1)
                fh.write("\n")
        with self._lock:
            self.last_bundle = path
        log.warning("flight recorder dumped %s (reason=%s, %d points, "
                    "%d events, %d decisions)", path, reason,
                    len(bundle["points"]), len(bundle["events"]),
                    len(bundle["decisions"]))
        return path


#: the process-wide recorder every gateway of the process shares — one
#: ring per process, like the serve-trace ring it bundles
FLIGHT = FlightRecorder()
