"""Disaggregated prefill: dedicated workers feed decode replicas pages;
the counterpart of ``kubeoperator_tpu/cluster/disagg.py``.

Chunked prefill is the segment loop's worst tenant: a long prompt's
admission pass runs on the decode worker thread *between* segments, so
every in-flight decode on that replica stalls for the whole prefill —
interference the segment-time attribution measures directly. A
``PrefillWorker`` moves that pass onto its own engine: it admits the
page-aligned prompt prefix there, decodes to the prefix frontier, and
exports the finished KV as **whole pages** (``engine.export_prefix`` —
block-table page lists, never a dense-row copy). The gateway ships the
payload to the routed decode replica (``ContinuousBatcher.handoff`` →
``engine.import_prefix``), whose prefix cache then serves the real
admission as a full/cover hit: the decode replica never runs the long
prefill at all.

Bit-exactness holds because an imported page carries exactly the K/V a
local prefill of the same tokens would have produced (the decode-path
write is the same math the seeded-chunk pass replays), so a handoff is
indistinguishable from a same-replica prefix-cache hit — a path the
engine's signature property already pins.

The worker is engine-agnostic: a real ``SlotPoolEngine`` (or its
``EngineLeader`` over a serving mesh) exports page payloads, which stay
on the engine's device, so a decode replica on the same card lands them
without a host copy; a cost-model engine without ``export_prefix`` (no
KV to ship) pays the prefill on the *worker's* caller instead of the
decode thread and hands over a tokens-only payload — the same
interference removal, priced instead of computed.
"""

from __future__ import annotations

import threading
from typing import Any


def aligned_prefix(prompt: Any, page: int) -> list[int]:
    """The page-aligned prefix of ``prompt`` — the only span a handoff
    may ship (a partial page is still writable by its owner)."""
    n = len(prompt) // page
    return [int(t) for t in prompt[:n * page]]


class PrefillWorker:
    """Runs chunked prefill for page-aligned prefixes on a dedicated
    engine and returns handoff payloads ``{"tokens", "layers", "pages"}``.

    One worker serializes its prefills (it owns one slot pool); scale by
    running more workers. The engine's own prefix cache stays warm across
    calls, so repeated prefixes cost one admission hit, not a re-prefill.
    """

    def __init__(self, engine: Any, *, slot: int = 0):
        self.engine = engine
        self.slot = int(slot)
        self.prefills = 0
        self.pages_exported = 0
        self._lock = threading.Lock()

    def prefill(self, tokens: Any) -> dict:
        toks = [int(t) for t in tokens]
        page = int(self.engine.page)
        if not toks or len(toks) % page:
            raise ValueError(
                f"prefill worker takes a page-aligned prefix "
                f"(page={page}), got {len(toks)} tokens")
        n = len(toks) // page
        with self._lock:
            self.prefills += 1
            if not hasattr(self.engine, "export_prefix"):
                # cost model: pay the prefill price here (the caller's
                # thread), ship tokens — the decode replica's cache entry
                # is the whole payload
                self.engine.admit([(self.slot, toks, 1, 0.0, 0)])
                self.engine.release([self.slot])
                return {"tokens": toks, "layers": None, "pages": n}
            pos = self.engine.admit(
                [(self.slot, toks, 1, 0.0, 0)])[self.slot]
            # decode to the prefix frontier: positions [pos0, plen) fill
            # their pages via forced prompt micro-steps (host-mirrored
            # position math, no device reads — same discipline as the
            # batcher's scheduler)
            last = len(toks)        # plen + max_tokens - 1 with mt=1
            while pos < last:
                self.engine.run_segment()
                pos = min(pos + self.engine.segment, last)
            layers = self.engine.export_prefix(self.slot, n)
            self.engine.release([self.slot])
            self.pages_exported += n
            return {"tokens": toks, "layers": layers, "pages": n}
