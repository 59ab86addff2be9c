"""Persistent slot-pool decode engine for continuous batching, the
counterpart of ``kubeoperator_tpu/workloads/decode_loop.py`` (part 1: one
device, a KV pool in the model dtype, no prefix cache).

``generate()`` runs one fused batch to completion. This module keeps a
fixed pool of S decode *slots* alive on the device instead: one
``run_segment()`` advances every active slot K tokens (K micro-steps),
rows stop at exactly ``prompt_len + max_tokens``, and a per-row
temperature lets mixed-temperature traffic co-batch. Between segments the
host retires finished slots with ONE batched fetch (``poll``) and admits
queued requests via chunked prefill (``admit``).

Paged KV: each layer keeps one page *pool* ``[P, page, H, D]`` and each
slot an int64 *block table* ``[T/page]`` naming the pages behind its
positions. The micro-step gathers ``pool[block_table]`` back into the
dense ``[S, T, H, D]`` view (``_gather_kv``, a permutation copy, so the
attention math sees the operands a dense cache row would hold) and writes
each step's K/V through the ``(page, offset)`` indirection
(``_page_write``, in place). These two are the only code that reads or
writes a pool. Admission reserves ``ceil((plen+max_tokens)/page)`` pages;
the batcher admits against free pages. One *trash page* is never
allocated: empty and finished rows keep writing their no-op K/V there or
at their frozen position, so a recycled page is never corrupted by a
retired slot (``release`` points retired block tables at trash).

The micro-step's math is the port's ``_decode_loop`` (generate.py) op for
op — the same shared helpers (``rms_norm``, ``token_qkv``,
``attn_out_mlp``, ``final_logits``), f32 scores, the -1e30 mask over the
full ``max_seq_len`` width — with the scalar position replaced by a
per-row position vector (``_rope_rows`` is ``rope`` at each row's
position). Greedy rows therefore give the tokens a solo ``generate()`` of
the same request gives. Sampling uses ``generate()``'s own rule
(``gumbel_draw``) keyed on ``(seed, 0, position)``: the draw a solo
``generate()`` of that one request makes at that position, which makes a
sampled row invariant to its slot, its neighbours and when it was
admitted. The draws are seeded on the host, so the engine keeps a host
mirror of each slot's position (exact: admission sets it, and every
micro-step adds 1 while ``pos < last``) and of each slot's temperature
and seed; greedy rows draw nothing.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue 1 item): the prefix cache and copy-on-write [6], quantized KV and
the host spill tier [7], speculative decoding and MoE serving [9], a
device mesh [14] and the AOT compile cache [15].
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.workloads.generate import (
    attn_out_mlp, final_logits, gumbel_draw,
)
from kubeoperator_tpu_torch.workloads.train import MeshSpec, resolve_device
from kubeoperator_tpu_torch.workloads.transformer import (
    Transformer, TransformerConfig, rms_norm, token_qkv,
)


def _pow2_at_most(n: int) -> int:
    v = 1
    while v * 2 <= n:
        v *= 2
    return v


def _default_page(max_total: int) -> int:
    """Largest power of two <= min(16, max_total) dividing max_total: 16
    for the production-shaped 2k context, smaller when a tiny test
    max_seq_len demands it. 16-token pages keep the block table small
    while still splitting a 2k context into 128 allocatable units."""
    p = _pow2_at_most(min(16, max_total))
    while max_total % p:
        p //= 2
    return p


#: legal page-pool element layouts. "bf16" means "the model dtype,
#: unquantized" (pools store cfg.dtype verbatim — float32 in tests);
#: "int8"/"fp8" store 1-byte elements plus per-(page, offset, head)
#: float32 scales (ROADMAP queue 1 item 7; not ported yet).
KV_DTYPES = ("bf16", "int8", "fp8")

#: declared greedy-logit tolerance per KV layout: a bf16 pool gives the
#: logits of solo ``generate()`` (tolerance 0.0); quantized pools promise
#: max |logit delta| below this bound instead.
LOGIT_TOLERANCE = {"bf16": 0.0, "int8": 0.25, "fp8": 0.25}


def validate_page_pool(*, page: int, pages: int, max_seq_len: int,
                       dp: int = 1, kv_dtype: str = "bf16",
                       spill_pages: int = 0) -> None:
    """Reject un-serveable page-pool layouts up front with actionable
    errors instead of an opaque gather/scatter shape failure mid-admit.
    ``kv_dtype`` validates the quantized scale layout in the same
    breath; ``spill_pages`` the host spill-tier bound."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype ({kv_dtype!r}) must be one of {KV_DTYPES}: bf16 "
            f"stores the model dtype verbatim (bit-identical decode), "
            f"int8/fp8 store 1-byte pages with per-page scales")
    if kv_dtype == "fp8" and not hasattr(torch, "float8_e4m3fn"):
        raise ValueError(
            "kv_dtype 'fp8' needs torch.float8_e4m3fn, which this torch "
            "build does not provide; use 'int8'")
    if kv_dtype != "bf16" and page < 2:
        raise ValueError(
            f"page size ({page}) must be >= 2 for the quantized "
            f"({kv_dtype}) layout: each page row carries a float32 "
            f"scale per (offset, head), so a 1-token page spends as "
            f"many scale bytes as a bf16 page spends on K/V and the "
            f"int8 HBM win cancels")
    if spill_pages < 0:
        raise ValueError(
            f"spill_pages ({spill_pages}) must be >= 0 (0 disables the "
            f"host-RAM spill tier)")
    if page < 1 or page & (page - 1):
        raise ValueError(
            f"page size ({page}) must be a power of two: admission "
            f"prefills pow2 prompt chunks, so only pow2 pages keep the "
            f"chunk writes page-aligned")
    if page > max_seq_len:
        raise ValueError(
            f"page size ({page}) must be <= max_seq_len ({max_seq_len}): "
            f"a page larger than the context can never fill")
    if max_seq_len % page:
        raise ValueError(
            f"max_seq_len ({max_seq_len}) must be divisible by the page "
            f"size ({page}): block tables hold max_seq_len/page entries")
    if pages % dp:
        raise ValueError(
            f"pages ({pages}) must be divisible by dp ({dp}): the page "
            f"axis shards over dp, so each dp shard owns pages/dp "
            f"contiguous pages")
    if pages // dp < 2:
        raise ValueError(
            f"pages ({pages}) gives {pages // dp} page(s) per dp shard "
            f"({dp}); each shard needs its reserved trash page plus at "
            f"least one allocatable page")


def _rope_rows(x: torch.Tensor, pos: torch.Tensor,
               base: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings with a *per-row* position. x: [S, 1, H, D],
    pos: [S]. Elementwise identical to ``transformer.rope`` evaluated at
    each row's scalar position (same f32 angle math, same stack/reshape),
    which is what keeps slot tokens equal to the solo decode's."""
    d = x.shape[-1]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    angles = pos[:, None].float() * freqs[None, :]              # [S, D/2]
    cos = torch.cos(angles)[:, None, None, :]
    sin = torch.sin(angles)[:, None, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


class _PageShard:
    """Host-side page allocator for the pool: a free list over its page
    range, per-page refcounts and the reserved trash page. (The prefix
    cache's ``cache_ref``/``prefix`` and the spill tier come with ROADMAP
    items 6 and 7.)"""

    __slots__ = ("index", "base", "span", "trash", "free", "ref")

    def __init__(self, index: int, base: int, span: int):
        self.index = index
        self.base = base
        self.span = span
        self.trash = base           # never allocated; absorbs no-op writes
        self.free = list(range(base + 1, base + span))
        self.ref: dict[int, int] = {}


class SlotPoolEngine:
    """Device side of continuous batching: S persistent decode slots over
    a paged KV pool on one device.

    The host-facing protocol (``ContinuousBatcher`` drives it):

    * ``admit(entries)`` — write queued requests into free slots: pages
      are reserved, one chunked prefill per pow2 prompt bucket fills them,
      and the per-slot state vectors are set. Returns ``{slot: pos}``.
    * ``run_segment()`` — advance every active slot ``segment`` tokens;
      no host-device sync.
    * ``poll()`` — one batched device->host fetch of (token buffers,
      positions) for retirement.
    * ``release(slots)`` — free retired slots' pages and point their
      block tables at the trash page.
    * ``pages_for`` / ``free_pages`` / ``evictable_pages`` /
      ``pages_in_use`` — the page accounting the batcher admits against.

    The protocol is single-writer: one host thread calls admit/release/
    run_segment/poll (the batcher's worker), so allocator state needs no
    lock. ``model`` is the port's ``Transformer`` (weights from
    ``bridge.params_from_jax`` or a trainer) on ``device``.
    """

    def __init__(self, cfg: TransformerConfig, model: Transformer, *,
                 slots: int = 16, segment: int = 8,
                 page: int | None = None, pages: int | None = None,
                 kv_dtype: str = "bf16", spill_pages: int = 0,
                 spec_k: int = 0, draft_layers: int = 0,
                 mesh_spec: MeshSpec | None = None,
                 compile_cache: object = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if slots < 1 or segment < 1:
            raise ValueError("slots and segment must be >= 1")
        if model.embedding.device != self.device:
            raise ValueError(f"model is on {model.embedding.device}, the "
                             f"engine on {self.device}")
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "MoE serving is not ported yet (ROADMAP queue 1, item 9)")
        if spec_k or draft_layers:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP queue 1, "
                "item 9)")
        if mesh_spec is not None and any(s > 1 for _, s in
                                         mesh_spec.sizes()):
            raise NotImplementedError(
                f"mesh {dict(mesh_spec.sizes())}: the slot pool runs on one "
                f"device until ROADMAP queue 1 item 14 (multi-device)")
        if compile_cache is not None:
            raise NotImplementedError(
                "the AOT compile cache is not ported yet (ROADMAP queue 1, "
                "item 15)")
        self.cfg = cfg
        self.model = model
        self.slots = int(slots)
        self.segment = int(segment)
        self.max_total = int(cfg.max_seq_len)
        self._decode_cfg = replace(cfg, decode=True, remat=False)

        # -- paged-KV geometry ----------------------------------------------
        self.page = int(page) if page is not None else _default_page(
            self.max_total)
        # default pool: dense-equivalent capacity (every slot can still go
        # to max_seq_len) plus the trash page; callers cap memory by
        # passing a smaller `pages` and letting admission backpressure work
        self.pages = (int(pages) if pages is not None else
                      self.slots * (self.max_total // max(self.page, 1)) + 1)
        self.kv_dtype = str(kv_dtype)
        validate_page_pool(page=self.page, pages=self.pages,
                           max_seq_len=self.max_total,
                           kv_dtype=self.kv_dtype,
                           spill_pages=int(spill_pages))
        if self.kv_dtype != "bf16":
            raise NotImplementedError(
                f"kv_dtype {self.kv_dtype!r}: quantized KV is not ported yet "
                f"(ROADMAP queue 1, item 7)")
        if spill_pages:
            raise NotImplementedError(
                "the host spill tier is not ported yet (ROADMAP queue 1, "
                "item 7)")
        self.logit_tolerance = LOGIT_TOLERANCE[self.kv_dtype]
        self.blocks = self.max_total // self.page
        self._shards = [_PageShard(0, 0, self.pages)]
        self._slot_pages: dict[int, list[int]] = {}
        self.last_plans: dict[int, dict] = {}   # last wave's admission plans

        s, t, dev = self.slots, self.max_total, self.device
        h, d, dt = cfg.n_heads, cfg.head_dim, cfg.dtype
        self._rows = torch.arange(s, device=dev)
        self._key_pos = torch.arange(t, device=dev)
        self._buf = torch.zeros((s, t), dtype=torch.long, device=dev)
        self._pos = torch.zeros((s,), dtype=torch.long, device=dev)
        # final token index; empty=0, so an empty row never advances
        self._last = torch.zeros((s,), dtype=torch.long, device=dev)
        self._plen = torch.ones((s,), dtype=torch.long, device=dev)
        # host mirrors: the draws are seeded on the host, and their keys
        # must not cost a device read
        self._pos_h = np.zeros(s, np.int64)
        self._last_h = np.zeros(s, np.int64)
        self._plen_h = np.ones(s, np.int64)
        self._temp_h = np.zeros(s, np.float64)
        self._seed_h = np.zeros(s, np.int64)
        self._gen = torch.Generator(device=dev)
        self._pools = [
            (torch.zeros((self.pages, self.page, h, d), dtype=dt, device=dev),
             torch.zeros((self.pages, self.page, h, d), dtype=dt, device=dev))
            for _ in range(cfg.n_layers)]
        self._bt_np = np.full((s, self.blocks), self._shards[0].trash,
                              np.int64)
        self._bt = torch.as_tensor(self._bt_np, device=dev)

    @property
    def pool_bytes(self) -> int:
        """Device bytes of every layer's K and V page pools."""
        return sum(p.numel() * p.element_size()
                   for entry in self._pools for p in entry)

    # -- the pool's write and read paths --------------------------------------
    def _page_write(self, pool: torch.Tensor, pages: torch.Tensor,
                    offsets: torch.Tensor, vals: torch.Tensor) -> None:
        """THE pool write path: one in-place scatter of already
        block-table-routed ``(page, offset)`` pairs. A raw slot- or
        position-indexed write would land in whichever request currently
        owns that page."""
        pool[pages, offsets] = vals

    def _gather_kv(self, pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """THE pool read path: gather pages by index (a permutation copy)."""
        return pool[idx]

    # -- device math ----------------------------------------------------------
    def _forward(self) -> torch.Tensor:
        """One token of every slot through the model: write each layer's
        K/V at the row's position, attend over the gathered page view, and
        return the next-token logits [S, vocab]. ``_decode_loop``'s step
        with the scalar position replaced by the per-slot ``pos`` vector
        and the dense cache row by the gathered pages."""
        cfg, dt, model = self._decode_cfg, self._decode_cfg.dtype, self.model
        s, t = self.slots, self.max_total
        nh, hd = cfg.n_heads, cfg.head_dim
        scale = 1.0 / (cfg.head_dim ** 0.5)
        pos = self._pos
        x = F.embedding(self._buf[self._rows, pos][:, None],
                        model.embedding).to(dt)                   # [S, 1, d]
        # block-table routing of this step's K/V write: a finished row
        # rewrites its frozen position with the identical value; an empty
        # row writes the trash page — both no-ops in effect
        blk = pos // self.page
        pg = self._bt[self._rows, blk]
        off = pos - blk * self.page
        visible = self._key_pos[None, None, None, :] <= pos[:, None, None, None]
        for layer, (kp, vp) in zip(model.layers, self._pools):
            h = rms_norm(x, layer.ln1.scale).to(dt)
            q, k, v = token_qkv(layer.attn, h, dt)
            q, k = _rope_rows(q, pos), _rope_rows(k, pos)
            self._page_write(kp, pg, off, k[:, 0].to(dt))
            self._page_write(vp, pg, off, v[:, 0].to(dt))
            ck = self._gather_kv(kp, self._bt).reshape(s, t, nh, hd)
            cv = self._gather_kv(vp, self._bt).reshape(s, t, nh, hd)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  ck.float()) * scale
            scores = torch.where(visible, scores,
                                 torch.full_like(scores, -1e30))
            x = attn_out_mlp(layer, x, torch.softmax(scores, dim=-1), cv, dt)
        return final_logits(cfg, model, x)[:, 0, :]

    def _choose(self, logits: torch.Tensor) -> None:
        """Per-row choose and advance: the given prompt token while pos+1
        is inside the prompt, argmax at temperature 0, else the
        (seed, 0, pos)-keyed draw. Inactive rows write their CURRENT token
        back at pos, a no-op that keeps the step free of row selection."""
        rows, pos, t = self._rows, self._pos, self.max_total
        nxt = (pos + 1).clamp(max=t - 1)
        choice = torch.argmax(logits, dim=-1)
        for i in np.flatnonzero((self._temp_h > 0)
                                & (self._pos_h < self._last_h)
                                & (self._pos_h + 1 >= self._plen_h)):
            choice[i] = gumbel_draw(
                logits[i:i + 1], float(self._temp_h[i]),
                [(int(self._seed_h[i]), 0, int(self._pos_h[i]))],
                self._gen)[0]
        chosen = torch.where(pos + 1 < self._plen, self._buf[rows, nxt],
                             choice)
        active = pos < self._last
        self._buf[rows, torch.where(active, nxt, pos)] = torch.where(
            active, chosen, self._buf[rows, pos])
        self._pos += active
        self._pos_h += self._pos_h < self._last_h

    @torch.no_grad()
    def run_segment(self) -> None:
        """Advance every active slot ``segment`` tokens (finished and
        empty slots no-op in place). Enqueues device work only: no value
        comes back to the host."""
        for _ in range(self.segment):
            self._choose(self._forward())

    def poll(self) -> tuple[np.ndarray, np.ndarray]:
        """ONE batched device->host fetch: (token buffers [S, max_total],
        positions [S]) — retirement reads rows out of this, never
        per-scalar fetches."""
        both = torch.cat([self._buf, self._pos[:, None]], dim=1).cpu().numpy()
        return both[:, :-1], both[:, -1]

    @torch.no_grad()
    def debug_logits(self) -> np.ndarray:
        """Test hook: the next-token logits ``[S, vocab]`` every slot would
        choose from, by the micro-step's own path, without advancing any
        slot. (Its page writes are the ones the next micro-step makes.)"""
        return self._forward().cpu().numpy()

    # -- host-side page accounting ------------------------------------------
    def pages_for(self, prompt_len: int, max_tokens: int) -> int:
        """Pages one request reserves: its full decode extent, rounded up
        to whole pages."""
        return -(-(int(prompt_len) + int(max_tokens)) // self.page)

    def free_pages(self, shard: int = 0) -> int:
        return len(self._shards[shard].free)

    def evictable_pages(self, shard: int = 0) -> int:
        """Pages only the prefix cache keeps alive: none until the cache
        (ROADMAP queue 1, item 6)."""
        return 0

    def pages_in_use(self, shard: int = 0) -> int:
        """Allocated pages (live slots), excluding the trash page."""
        sh = self._shards[shard]
        return sh.span - 1 - len(sh.free)

    @property
    def max_request_pages(self) -> int:
        """Largest page reservation one request may ask for: the whole
        pool minus its trash page."""
        return self.pages - 1

    def _ensure_free(self, sh: _PageShard, need: int) -> None:
        if len(sh.free) < need:
            raise RuntimeError(
                f"page pool exhausted on dp shard {sh.index}: need {need} "
                f"free pages, {len(sh.free)} available ({sh.span - 1} "
                f"usable pages per shard; raise pages= or admit less "
                f"concurrency)")

    def _release_slot(self, slot: int) -> None:
        pages = self._slot_pages.pop(slot, None)
        if not pages:
            return
        sh = self._shards[0]
        for pg in pages:
            sh.ref[pg] -= 1
            if not sh.ref[pg]:
                del sh.ref[pg]
                sh.free.append(pg)

    def release(self, slots: Sequence[int]) -> None:
        """Hand retired slots' pages back to the allocator and point every
        retired block table at the trash page, so the frozen row's no-op
        K/V writes can never corrupt a page the next admission hands
        out."""
        freed = [int(s) for s in slots if int(s) in self._slot_pages]
        for s in freed:
            self._release_slot(s)
            self._bt_np[s, :] = self._shards[0].trash
        self._push_block_tables(freed)

    # -- admission ----------------------------------------------------------
    @torch.no_grad()
    def admit(self, entries: Sequence[tuple[int, Sequence[int], int, float,
                                            int]]) -> dict[int, int]:
        """Admit ``(slot, prompt_ids, max_tokens, temperature, seed)``
        tuples into their (free) slots: pages are reserved per request,
        one chunked forward pass per pow2 prompt bucket fills them, and
        the per-slot state vectors are set. Returns {slot: pos}."""
        plans = self._plan_entries(entries)
        self.last_plans = {
            pl["slot"]: {
                "shard": pl["shard"], "pages": len(pl["pages"]),
                "bucket": pl["c"], "hit_len": pl["h"], "pos0": pl["pos0"],
                "pages_reused": pl["h"] // self.page, "hit_kind": "miss",
            } for pl in plans}
        groups: dict[int, list[dict]] = {}
        for pl in plans:
            groups.setdefault(pl["c"], []).append(pl)
        out: dict[int, int] = {}
        for c, group in sorted(groups.items()):
            out.update(self._admit_group(c, group))
        self._push_block_tables([pl["slot"] for pl in plans])
        return out

    def _plan_entries(self, entries) -> list[dict]:
        """Validate and reserve pages for one admission wave. Host-only:
        no device work happens here."""
        plans: list[dict] = []
        sh = self._shards[0]
        for slot, prompt_ids, max_tokens, temperature, seed in entries:
            prompt = list(map(int, prompt_ids))
            if not prompt:
                raise ValueError("prompt_ids must be non-empty")
            if len(prompt) + int(max_tokens) > self.max_total:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                    f"exceed max_seq_len ({self.max_total})")
            if not 0 <= int(slot) < self.slots:
                raise ValueError(f"slot {slot} outside pool [0, {self.slots})")
            slot, mt = int(slot), int(max_tokens)
            plen = len(prompt)
            # a re-admitted slot implicitly releases its previous pages
            # (its block table is rewritten below, before any segment runs)
            self._release_slot(slot)
            blocks_needed = self.pages_for(plen, mt)
            # the prefix-cache lookup (ROADMAP queue 1, item 6) slots in
            # here: n_hit cached pages would be shared and their prefill
            # skipped
            n_hit = 0
            c = _pow2_at_most(plen)
            self._ensure_free(sh, blocks_needed)
            pages = [sh.free.pop() for _ in range(blocks_needed)]
            for pg in pages:
                sh.ref[pg] = 1
            self._slot_pages[slot] = pages
            self._bt_np[slot, :] = sh.trash
            self._bt_np[slot, :blocks_needed] = pages
            plans.append(dict(slot=slot, prompt=prompt, plen=plen, mt=mt,
                              temp=float(temperature), seed=int(seed),
                              c=c, h=n_hit * self.page, pos0=c, pages=pages,
                              shard=sh.index))
        return plans

    def _admit_group(self, c: int, group: list[dict]) -> dict[int, int]:
        """One chunked prefill for every plan of prompt bucket c: a
        compact [k, c] pass through the model with c-wide scratch caches
        (the transformer's decode branch masks to the cache width), then
        one page-routed write of positions [0, c) into each pool."""
        cfg, dev = self._decode_cfg, self.device
        nh, hd = cfg.n_heads, cfg.head_dim
        k = len(group)
        chunk = torch.as_tensor(np.array([pl["prompt"][:c] for pl in group]),
                                dtype=torch.long, device=dev)
        scratch = [(torch.zeros((k, c, nh, hd), dtype=cfg.dtype, device=dev),
                    torch.zeros((k, c, nh, hd), dtype=cfg.dtype, device=dev))
                   for _ in range(cfg.n_layers)]
        logits = self.model(chunk, torch.arange(c, device=dev), scratch)

        # route positions [0, c) through each plan's block table into the
        # pools: indices stacked on the host, moved once, one write each
        hpos = np.arange(c)
        pg = torch.as_tensor(np.array([[pl["pages"][p // self.page]
                                        for p in hpos] for pl in group]
                                      ).reshape(-1), device=dev)
        off = torch.as_tensor(np.tile(hpos % self.page, k), device=dev)
        for (kp, vp), (sk, sv) in zip(self._pools, scratch):
            self._page_write(kp, pg, off, sk.reshape(k * c, nh, hd))
            self._page_write(vp, pg, off, sv.reshape(k * c, nh, hd))

        rows = torch.as_tensor(self._prompt_rows(group), device=dev)
        for i, pl in enumerate(group):
            if pl["plen"] == c and c < self.max_total:
                # pow2-length prompt: position c holds the FIRST generated
                # token, chosen from the prefill's last-position logits —
                # generate()'s prefill choose for this one request
                lg = logits[i:i + 1, -1]
                rows[i, c] = (gumbel_draw(lg, pl["temp"],
                                          [(pl["seed"], 0, c - 1)],
                                          self._gen)[0]
                              if pl["temp"] > 0 else torch.argmax(lg[0]))
        self._scatter_state(group, np.full(k, c, np.int64), rows)
        return {pl["slot"]: c for pl in group}

    def _prompt_rows(self, group: list[dict]) -> np.ndarray:
        rows_np = np.zeros((len(group), self.max_total), np.int64)
        for i, pl in enumerate(group):
            rows_np[i, :pl["plen"]] = pl["prompt"]
        return rows_np

    def _scatter_state(self, group: list[dict], pos_np: np.ndarray,
                       rows: torch.Tensor) -> None:
        """One batched transfer and one indexed write per state vector,
        and the same values into the host mirrors."""
        slots_np = np.array([pl["slot"] for pl in group], np.int64)
        plens_np = np.array([pl["plen"] for pl in group], np.int64)
        last_np = plens_np + np.array([pl["mt"] for pl in group]) - 1
        idx = torch.as_tensor(slots_np, device=self.device)
        self._buf[idx] = rows
        self._pos[idx] = torch.as_tensor(pos_np, device=self.device)
        self._last[idx] = torch.as_tensor(last_np, device=self.device)
        self._plen[idx] = torch.as_tensor(plens_np, device=self.device)
        self._pos_h[slots_np] = pos_np
        self._last_h[slots_np] = last_np
        self._plen_h[slots_np] = plens_np
        self._temp_h[slots_np] = [pl["temp"] for pl in group]
        self._seed_h[slots_np] = [pl["seed"] for pl in group]

    def _push_block_tables(self, slots: Sequence[int]) -> None:
        if not slots:
            return
        idx_np = np.asarray(sorted(set(int(s) for s in slots)), np.int64)
        self._bt[torch.as_tensor(idx_np, device=self.device)] = \
            torch.as_tensor(self._bt_np[idx_np], device=self.device)
