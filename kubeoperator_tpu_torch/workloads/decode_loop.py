"""Persistent slot-pool decode engine for continuous batching, the
counterpart of ``kubeoperator_tpu/workloads/decode_loop.py``, on one
device or a serving mesh: paged KV, the prefix cache with copy-on-write
and LRU eviction, int8/fp8 KV pages, the host spill tier and the engine
half of the prefill→decode handoff.

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
dense ``[S, T, H, D]`` view (``_gather_kv``, a permutation copy for
model-dtype pools, so the attention math sees the operands a dense cache
row would hold) and writes each step's K/V through the ``(page, offset)``
indirection (``_page_write``, in place). ``_page_write``, ``_page_copy``
(whole pages: copy-on-write, spill promotion, import), ``_gather_kv`` and
the raw ``_page_export`` are the only code that reads or writes a pool.
Admission reserves ``ceil((plen+max_tokens)/page)`` pages; the batcher
admits against free plus evictable pages. One *trash page* is never
allocated: empty and finished rows keep writing their no-op K/V there or
at their frozen position, so a recycled page is never corrupted by a
retired slot (``release`` points retired block tables at trash).

Prefix cache (always on, as in the reference): admission hashes every
page-aligned prompt prefix into an LRU ``hash(tokens) -> (tokens, pages)``.
A hit maps the cached pages into the new slot's block table read-only
(refcounted: a page frees only when no slot and no cache entry holds it)
and skips their prefill. The page holding the first position the request
itself writes is copied first (copy-on-write), so sharing never shows in
the tokens. Three hit kinds: *full* (the whole prompt cached: re-decode
its last token, ``pos0 = plen-1``), *cover* (the hit reaches the pow2
prefill bucket: no prefill pass), *partial* (prefill ``[h, c)`` over a
scratch cache seeded from the shared pages). When the pool runs dry,
admission evicts LRU entries whose pages no live slot pins.

Quantized KV: ``kv_dtype="int8"`` or ``"fp8"`` stores 1-byte pages plus a
float32 scale per (page, offset, head). ``_page_write`` quantizes on
write, ``_gather_kv`` dequantizes on read (an eager multiply into an f32
intermediate, where XLA fuses it into the gather), and copies move raw
codes and scale rows. fp8 codes are held as ``uint8`` and viewed as
``float8_e4m3fn`` only to convert, so no indexing op ever touches the
float8 dtype. Greedy logits then stay within ``LOGIT_TOLERANCE`` of the
model-dtype pool instead of equal to it.

Host spill tier (``spill_pages=N``): LRU eviction of an entry whose pages
only the cache holds first *demotes* its raw pages (codes and scales) into
a bounded host LRU (pinned memory on the card); a later hit there is
*promoted* host→device into fresh pages instead of recomputed, bit for
bit what was demoted. Demotion and promotion happen inside ``admit``,
never inside ``run_segment``.

The micro-step's math is the port's ``_decode_loop`` (generate.py) op for
op — the same shared helpers (``rms_norm``, ``token_qkv``,
``attn_out_mlp``, ``final_logits``), f32 scores, the -1e30 mask over the
full ``max_seq_len`` width — with the scalar position replaced by a
per-row position vector (``_rope_grid`` is ``rope`` at each row's
position). Greedy rows therefore give the tokens a solo ``generate()`` of
the same request gives, on prefix hits too (the seeded chunk attends over
exactly the K/V a cold prefill computes). Sampling uses ``generate()``'s
own rule (``gumbel_draw``) keyed on ``(seed, 0, position)``: the draw a
solo ``generate()`` of that one request makes at that position, which
makes a sampled row invariant to its slot, its neighbours, when it was
admitted and what it shared. The draws are seeded on the host, so the
engine keeps a host mirror of each slot's position (exact: admission sets
it, and every micro-step adds 1 while ``pos < last``) and of each slot's
temperature and seed; greedy rows draw nothing.

Speculative decoding (``spec_k=K, draft_layers=N``): each
``run_segment`` is one round of K draft micro-steps through the target's
own first N layers (a strict-prefix draft: no second parameter set),
whose KV lives in the same page pool behind per-slot draft block tables
(``_dbt``), then ONE K-wide verify pass through all layers. Each row
commits the leading run of proposals that match the target's own choice
plus the target's correction at the first mismatch, so 1..K tokens a
round, and ``_rewind`` (the only code that moves ``pos`` back) sets each
row's position to its accepted frontier. ``pages_for`` reserves the
K-token lookahead and mirrors the reservation for the draft.
Admission seeds the draft pages from the target's pages below the write
frontier (``_seed_draft``): the draft's layer-l KV over a prefix IS the
target's. Draft pages are always fresh and never prefix-cached;
``release`` points them back at the trash page. A sampled row's K Gumbel
noise vectors are drawn once a round, keyed ``(seed, 0, pos0 + i)`` from
the host mirror, and used by draft step i and verify step i alike, so a
sampled row emits exactly the non-speculative engine's stream. The
advance is data-dependent, so the mirror is stale after a round until
``poll_spec()`` (one batched fetch of positions and the ``[drafted,
accepted]`` stats) refreshes it; ``ContinuousBatcher`` calls it after
every dispatch. A round that would need the mirror while it is stale (a
live sampled row, by the host's last knowledge) raises ``RuntimeError``
before any device work instead of syncing, so a dispatch never reads the
device.

MoE serving (``moe_experts > 0``): each layer's FFN is the model's
``MoEMlp`` at this pass's width (``attn_out_mlp``'s MoE branch, the
reference's ``_layer_tail``), streaming every expert for every row (the
dense dispatch). The per-expert load of the micro-steps accumulates on
the device; ``expert_load()`` fetches it on demand. Admission prefills
are not counted. GShard capacity depends on the pass's width, so a pool
row equals solo ``generate()`` for power-of-two prompts, whose admission
chunk is the whole prompt; at one token a step nothing is ever dropped.
Speculation over MoE is refused (``ValueError``), as in the reference.

The serving mesh (``mesh_spec=MeshSpec(dp=…, tp=…[, ep=…])``, one
process per device in a ``torch.distributed`` group,
``validate_serve_mesh``): the slots and the pages split over dp, each dp
shard owning slots/dp contiguous slots (slot s on shard s // (slots/dp))
and pages/dp contiguous pages with its own trash page, its own
allocator, prefix cache and spill tier; a slot's block table names only
its shard's pages. Attention heads split over tp and each layer's output
projection and MLP down product are summed over tp (the reference's two
all-reduces a block); MoE experts split over ep, routing stays whole,
and the combine is summed over ep (``moe.py``). ``sharding.place_decode``
cuts the weights; the embedding stays whole, so the logits and the
draws are every rank's own. A rank holds on the device only its shard's
rows, pages and heads.

The host protocol is the one-device engine's, run by every rank: the
host state (allocators, prefix caches, block tables, mirrors) is the
same on every rank because every rank makes the same calls in the same
order, and each rank does the device work of its own shard. The ranks
of a dp shard (its tp and ep ranks) share its rows, so the collectives
inside a forward pass stay within a shard; only ``poll``,
``poll_spec``, ``expert_load`` and ``debug_logits`` gather or sum over
dp, so every rank returns every slot. One process serves: rank 0 holds
an ``EngineLeader``, which sends each call that touches the engine
(admit, run_segment, poll, poll_spec, release, expert_load,
debug_logits, export_prefix, import_prefix) to the other ranks, over a
gloo control group, before it runs it itself; they run
``follow(engine)``, making the same calls until the leader's ``stop()``.
The handoff's pages never ride the control group: ``export_prefix``
gathers the slot's row's head slices to rank 0, and ``import_prefix``
broadcasts rank 0's payload, as device tensors of the world's group
(NCCL on the cards), each rank of the target row landing its heads.
The allocator's read-only accounting (``pages_for``, ``free_pages``, …)
needs no message: every rank holds the same. Greedy rows on a mesh
equal the one-device pool's.

``compile_cache`` (an ``aot.CompileCache``) is consulted at
construction, as the reference's engine consults its segment executable:
the pool launches no port kernel, so the result (``engine.aot``) says
``source`` "none" and nothing is built or written.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import replace
from datetime import timedelta
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads import sharding
from kubeoperator_tpu_torch.workloads.generate import (
    attn_out_mlp, final_logits, gumbel_draw, gumbel_noise, gumbel_pick,
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
#: float32 scales.
KV_DTYPES = ("bf16", "int8", "fp8")

#: declared greedy-logit tolerance per KV layout: a bf16 pool gives the
#: logits of solo ``generate()`` (tolerance 0.0); quantized pools promise
#: max |logit delta| below this bound instead.
LOGIT_TOLERANCE = {"bf16": 0.0, "int8": 0.25, "fp8": 0.25}

#: symmetric quantization range per quantized dtype
_QMAX = {"int8": 127.0, "fp8": 448.0}


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


def validate_serve_mesh(spec: MeshSpec, *, slots: int, n_heads: int,
                        page: int | None = None, pages: int | None = None,
                        max_seq_len: int | None = None,
                        moe_experts: int = 0) -> None:
    """Reject un-shardable serving layouts up front with actionable
    errors. The serving pool shards exactly two ways: the page pool (and
    with it the slot axis) over dp, attention heads over tp — plus, for
    MoE models (``moe_experts > 0``), expert weights over ep. Pass
    ``page``/``pages``/``max_seq_len`` to validate the paged-KV layout in
    the same breath. The reference's checks and messages."""
    allowed = ("dp", "tp", "ep") if moe_experts else ("dp", "tp")
    extra = {n: s for n, s in spec.sizes()
             if n not in allowed and s > 1}
    if extra:
        raise ValueError(
            f"serving mesh shards slots over dp and heads over tp only; "
            f"got {', '.join(f'{n}={s}' for n, s in extra.items())} "
            f"(use --mesh dp:N,tp:M)")
    if moe_experts and spec.ep > 1 and moe_experts % spec.ep:
        raise ValueError(
            f"moe_experts ({moe_experts}) must be divisible by ep "
            f"({spec.ep}): expert weights shard over ep, so each shard "
            f"owns moe_experts/ep experts")
    if slots % spec.dp:
        raise ValueError(
            f"slots ({slots}) must be divisible by dp ({spec.dp}): the "
            f"slot axis shards over dp, so each shard owns slots/dp rows")
    if n_heads % spec.tp:
        raise ValueError(
            f"n_heads ({n_heads}) must be divisible by tp ({spec.tp}): "
            f"attention heads shard over tp, so each shard owns "
            f"n_heads/tp heads")
    if page is not None:
        validate_page_pool(page=page, pages=int(pages or 0),
                           max_seq_len=int(max_seq_len or 0), dp=spec.dp)


def _rope_grid(x: torch.Tensor, pos: torch.Tensor,
               base: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings over a per-(row, step) position grid. x:
    [S, K, H, D], pos: [S, K]. Elementwise identical to
    ``transformer.rope`` evaluated at each element's scalar position (same
    f32 angle math, same stack/reshape), which is what keeps slot tokens
    equal to the solo decode's."""
    d = x.shape[-1]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    angles = pos[..., None].float() * freqs                     # [S, K, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)



class _PageShard:
    """Host-side page allocator for the pool: a free list over its page
    range, per-page refcounts (``ref`` counts every holder, ``cache_ref``
    the prefix cache's share of it — a page is evictable exactly when the
    two are equal), the LRU prefix cache ``hash(tokens) -> (tokens,
    pages)``, the reserved trash page, and the bounded host spill tier
    ``hash(tokens) -> (tokens, payload, n_pages)`` holding raw demoted
    pages (``spill_used`` counts its pages)."""

    __slots__ = ("index", "base", "span", "trash", "free", "ref",
                 "cache_ref", "prefix", "spill", "spill_used")

    def __init__(self, index: int, base: int, span: int):
        self.index = index
        self.base = base
        self.span = span
        self.trash = base           # never allocated; absorbs no-op writes
        self.free = list(range(base + 1, base + span))
        self.ref: dict[int, int] = {}
        self.cache_ref: dict[int, int] = {}
        self.prefix: OrderedDict[int, tuple[tuple[int, ...],
                                            tuple[int, ...]]] = OrderedDict()
        self.spill: OrderedDict[int, tuple[tuple[int, ...], tuple,
                                           int]] = OrderedDict()
        self.spill_used = 0


class SlotPoolEngine:
    """Device side of continuous batching: S persistent decode slots over
    a paged KV pool on one device.

    The host-facing protocol (``ContinuousBatcher`` drives it):

    * ``admit(entries)`` — write queued requests into free slots: pages
      are reserved (prefix-cache hits map shared pages in and skip their
      prefill), one chunked prefill per (bucket, hit length) pair fills
      the fresh pages, and the per-slot state vectors are set. Returns
      ``{slot: pos}``.
    * ``run_segment()`` — advance every active slot ``segment`` tokens;
      no host-device sync.
    * ``poll()`` — one batched device->host fetch of (token buffers,
      positions) for retirement.
    * ``release(slots)`` — free retired slots' pages (prefix-cache
      entries keep theirs alive) and point their block tables at the
      trash page.
    * ``pages_for`` / ``free_pages`` / ``evictable_pages`` /
      ``pages_in_use`` / ``spill_pages_used`` — the page accounting the
      batcher admits against and reports.
    * ``poll_spec()`` (``spec_k > 0``) — after each speculative round, one
      batched fetch of (positions, drafted, accepted); ``expert_load()``
      (MoE configs) — the per-expert load accumulated on the device.

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
                 compile_cache: Any = None,
                 device: str | torch.device | None = None,
                 slices: Sequence[int] | None = None):
        self.device = resolve_device(device)
        if slots < 1 or segment < 1:
            raise ValueError("slots and segment must be >= 1")
        if model.embedding.device != self.device:
            raise ValueError(f"model is on {model.embedding.device}, the "
                             f"engine on {self.device}")
        self.spec_k = int(spec_k)
        self.draft_layers = int(draft_layers)
        if self.spec_k:
            if not 1 <= self.draft_layers < cfg.n_layers:
                raise ValueError(
                    f"draft_layers ({draft_layers}) must satisfy 1 <= "
                    f"draft_layers < n_layers ({cfg.n_layers}) when "
                    f"spec_k > 0: the draft is the target's own first "
                    f"layers, so it must be a strict, non-empty prefix")
            if cfg.moe_experts:
                raise ValueError(
                    "speculative decoding over MoE models is not "
                    "supported: the truncated draft stack has no router "
                    "state to propose with (serve MoE with spec_k=0)")
        elif self.draft_layers:
            raise ValueError(
                f"draft_layers ({draft_layers}) requires spec_k > 0 "
                f"(speculation is disabled at spec_k=0)")
        self.cfg = cfg
        self.slots = int(slots)
        self.segment = int(segment)
        self.max_total = int(cfg.max_seq_len)
        self._decode_cfg = replace(cfg, decode=True, remat=False)

        # -- the mesh: slots and pages over dp, heads over tp, experts over
        # ep; a 1-device spec is the one-device engine
        self.spec = (mesh_spec if mesh_spec is not None
                     and mesh_spec.n_devices > 1 else None)
        if self.spec is not None:
            validate_serve_mesh(self.spec, slots=self.slots,
                                n_heads=cfg.n_heads,
                                moe_experts=cfg.moe_experts)
            self.mesh = sharding.build_mesh(self.spec, self.device.type,
                                            slices)
            model = sharding.place_decode(model, cfg, self.mesh, self.spec)
            # the engine commands' channel (EngineLeader, follow): a gloo
            # group every rank's engine makes, in the same order
            self.control = dist.new_group(backend="gloo",
                                          timeout=_CONTROL_TIMEOUT)
        else:
            self.mesh = self.control = None
        self.model = model
        self.dp = self.spec.dp if self.spec is not None else 1
        self._dp_group = sharding.axis_group(self.mesh, "dp")
        self._shard_slots = self.slots // self.dp
        # this rank's dp shard: its slots [lo, lo + shard_slots) and pages
        self._my_shard = sharding.axis_index(self.mesh, "dp")
        self._lo = self._my_shard * self._shard_slots

        # -- paged-KV geometry ----------------------------------------------
        self.page = int(page) if page is not None else _default_page(
            self.max_total)
        # default pool: dense-equivalent capacity (every slot can still go
        # to max_seq_len) plus the trash page; callers cap memory by
        # passing a smaller `pages` and letting admission backpressure work
        # (one trash page per dp shard)
        self.pages = (int(pages) if pages is not None else
                      self.slots * (self.max_total // max(self.page, 1))
                      + self.dp)
        self.kv_dtype = str(kv_dtype)
        self.spill_pages = int(spill_pages)
        validate_page_pool(page=self.page, pages=self.pages,
                           max_seq_len=self.max_total, dp=self.dp,
                           kv_dtype=self.kv_dtype,
                           spill_pages=self.spill_pages)
        self._quantized = self.kv_dtype != "bf16"
        # codes are stored in _store_dt and converted through _qdt: fp8
        # lives in uint8 so that indexing never meets the float8 dtype
        self._qdt = (None if not self._quantized
                     else torch.int8 if self.kv_dtype == "int8"
                     else torch.float8_e4m3fn)
        self._store_dt = (None if not self._quantized
                          else torch.int8 if self.kv_dtype == "int8"
                          else torch.uint8)
        self._qmax = _QMAX.get(self.kv_dtype)
        self.logit_tolerance = LOGIT_TOLERANCE[self.kv_dtype]
        self.blocks = self.max_total // self.page
        # one allocator per dp shard over its contiguous page range, each
        # with its own trash page; this rank's device pool holds its own
        # shard's pages (local page = global page - _base)
        self._span = self.pages // self.dp
        self._shards = [_PageShard(i, i * self._span, self._span)
                        for i in range(self.dp)]
        self._base = self._my_shard * self._span
        self._slot_pages: dict[int, list[int]] = {}
        self.prefix_hits = 0          # admissions that reused cached pages
        self.prefix_pages_reused = 0  # pages whose prefill was skipped
        self.cow_copies = 0           # copy-on-write page duplications
        self.demotions = 0            # prefix entries demoted to host RAM
        self.promoted_hits = 0        # admissions served from the spill tier
        self.last_plans: dict[int, dict] = {}   # last wave's admission plans

        # device state covers this rank's shard: its slots' rows, its pages,
        # its heads; the host mirrors and block tables cover every slot
        s, t, dev = self._shard_slots, self.max_total, self.device
        h = cfg.n_heads // (self.spec.tp if self.spec is not None else 1)
        d, dt = cfg.head_dim, cfg.dtype
        self._rows = torch.arange(s, device=dev)
        self._key_pos = torch.arange(t, device=dev)
        self._buf = torch.zeros((s, t), dtype=torch.long, device=dev)
        self._pos = torch.zeros((s,), dtype=torch.long, device=dev)
        # final token index; empty=0, so an empty row never advances
        self._last = torch.zeros((s,), dtype=torch.long, device=dev)
        self._plen = torch.ones((s,), dtype=torch.long, device=dev)
        # host mirrors of every slot: the draws are seeded on the host, and
        # their keys must not cost a device read
        n = self.slots
        self._pos_h = np.zeros(n, np.int64)
        self._last_h = np.zeros(n, np.int64)
        self._plen_h = np.ones(n, np.int64)
        self._temp_h = np.zeros(n, np.float64)
        self._seed_h = np.zeros(n, np.int64)
        self._gen = torch.Generator(device=dev)
        # model-dtype pools keep 2-tuples; quantized ones widen each layer
        # entry to (k_pool, v_pool, k_scale, v_scale): 1-byte pools plus
        # per-(page, offset, head) float32 scales that start at 1
        shape = (self._span, self.page, h, d)

        def entry():
            if not self._quantized:
                return (torch.zeros(shape, dtype=dt, device=dev),
                        torch.zeros(shape, dtype=dt, device=dev))
            return (torch.zeros(shape, dtype=self._store_dt, device=dev),
                    torch.zeros(shape, dtype=self._store_dt, device=dev),
                    torch.ones(shape[:3], dtype=torch.float32, device=dev),
                    torch.ones(shape[:3], dtype=torch.float32, device=dev))

        self._pools = [entry() for _ in range(cfg.n_layers)]
        # block tables of every slot in global page ids (each slot its own
        # shard's trash page); the device holds this shard's rows in its
        # local ids
        self._bt_np = np.repeat(
            np.array([sh.trash for sh in self._shards], np.int64),
            self._shard_slots)[:, None].repeat(self.blocks, 1)
        self._bt = torch.as_tensor(self._local_pages(self._mine(self._bt_np)),
                                   device=dev)
        # draft block tables: the draft's KV pages live in the same pool
        # (one allocator, one backpressure signal) behind their own
        # [S, blocks] tables, trash-initialised like the target's
        self._dbt_np = self._bt_np.copy() if self.spec_k else None
        self._dbt = self._bt.clone() if self.spec_k else None
        # speculative accounting: [drafted, accepted] summed on the device
        # over the rounds since the last poll_spec, which drains it into
        # the host counters; _stale_h marks the rows whose position mirror
        # a round has outdated (poll_spec and admission refresh it)
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self._spec_stats = None
        self._stale_h = np.zeros(n, bool)
        # MoE per-expert load of every micro-step, summed on the device
        # (empty for a dense model)
        self._expert_load = torch.zeros(cfg.moe_experts, device=dev)
        # the compile cache: the pool's gathers, scatters and einsums are
        # PyTorch's, so it launches no port library and the consult says so
        self.aot = (compile_cache.consult("SlotPoolEngine", [],
                                          mesh_spec=self.spec)
                    if compile_cache is not None else None)

    # -- this rank's share of the mesh ----------------------------------------
    def _mine(self, host: np.ndarray) -> np.ndarray:
        """This rank's rows (its dp shard's slots) of a per-slot host
        array."""
        return host[self._lo:self._lo + self._shard_slots]

    def _local_pages(self, pages) -> np.ndarray:
        """Global page ids of this rank's shard as indices into its
        device pool."""
        return np.asarray(pages, np.int64) - self._base

    def _owns(self, shard: int) -> bool:
        return shard == self._my_shard

    def _shard_of(self, slot: int) -> int:
        """The dp shard slot ``slot`` lives on."""
        return int(slot) // self._shard_slots

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every slot's rows from each dp shard's [shard_slots, ...] block
        (a gather over dp; this rank's block on one device)."""
        return cl.all_gather(local, self._dp_group, 0)

    @property
    def pool_bytes(self) -> int:
        """Device bytes of every layer's K and V page pools and, for a
        quantized pool, their scale buffers."""
        return sum(p.numel() * p.element_size()
                   for entry in self._pools for p in entry)

    # -- quantized-entry plumbing -------------------------------------------
    def _split(self, entry):
        """Normalize one per-layer pool entry to (k_pool, v_pool, k_scale,
        v_scale); model-dtype entries carry ``None`` scales."""
        if self._quantized:
            return entry
        kp, vp = entry
        return kp, vp, None, None

    def _quantize(self, vals: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Symmetric per-(row, head) quantization over the head dim:
        scale = amax/qmax, so dequantizing is one multiply. The division
        stays a division (a reciprocal multiply changes codes), and int8
        rounds half to even. Returns (stored codes, float32 scales)."""
        v32 = vals.float()
        amax = v32.abs().amax(dim=-1)                       # [..., H]
        qscale = torch.clamp_min(amax, 1e-30) / self._qmax
        q = v32 / qscale[..., None]
        if self._qdt == torch.int8:
            q = torch.clamp(torch.round(q), -self._qmax, self._qmax)
        return q.to(self._qdt).view(self._store_dt), qscale

    # -- the pool's write and read paths --------------------------------------
    def _page_write(self, pool: torch.Tensor, pages: torch.Tensor,
                    offsets: torch.Tensor, vals: torch.Tensor,
                    scale: torch.Tensor | None = None) -> None:
        """THE pool write path: one in-place scatter of already
        block-table-routed ``(page, offset)`` pairs. A raw slot- or
        position-indexed write would land in whichever request currently
        owns that page. With a ``scale`` buffer (quantized pools) the
        values are quantized here and their scale rows land beside
        them."""
        if scale is None:
            pool[pages, offsets] = vals
            return
        q, s = self._quantize(vals)
        pool[pages, offsets] = q
        scale[pages, offsets] = s

    def _page_copy(self, pool: torch.Tensor, dst: torch.Tensor,
                   src: torch.Tensor, src_pool: torch.Tensor | None = None,
                   *, scale: torch.Tensor | None = None,
                   src_scale: torch.Tensor | None = None) -> None:
        """Whole-page duplication, one gather then one scatter: copy-on-
        write within the pool and — with ``src_pool`` — landing demoted
        or imported pages (``src`` indexes ``src_pool``) in freshly
        allocated ``dst`` pages. Quantized pools move raw codes plus their
        scale rows, so copy-on-write and spill promotion are bit-exact; a
        model-dtype payload landing in a quantized pool (``src_pool``
        without ``src_scale``: the import) is quantized on land. All
        sources are read before any destination is written, so a source
        page that is also a destination of the same call is copied
        intact."""
        sp = pool if src_pool is None else src_pool
        if scale is None:                       # model-dtype pool
            pool[dst] = sp[src]
            return
        if src_pool is not None and src_scale is None:
            q, s = self._quantize(sp[src])
            pool[dst] = q
            scale[dst] = s
            return
        ss = scale if src_scale is None else src_scale
        pool[dst] = sp[src]
        scale[dst] = ss[src]

    def _gather_kv(self, pool: torch.Tensor, scale: torch.Tensor | None,
                   idx: torch.Tensor) -> torch.Tensor:
        """THE pool read path: gather pages by index (a permutation copy
        for model-dtype pools); a quantized pool is dequantized in the same
        expression, so attention always sees model-dtype operands."""
        if scale is None:
            return pool[idx]
        return (pool[idx].view(self._qdt).float()
                * scale[idx][..., None]).to(self.cfg.dtype)

    def _page_export(self, buf: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
        """Raw page gather for the spill tier: demotion keeps the stored
        bits (quantized codes AND their scale rows), so a demote→promote
        round trip is bit-exact."""
        return buf[idx]

    # -- device math ----------------------------------------------------------
    def _layers(self, layers, x: torch.Tensor, pos: torch.Tensor,
                bt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``x`` [S, Q, d] at positions ``pos`` [S, Q] through ``layers``
        (with their pool entries): each writes its K/V through the block
        tables ``bt`` at each (row, position), attends over the gathered
        page view with a causal mask per query, and runs its FFN. Returns
        (x, load): the MoE layers' per-expert load summed, None for a
        dense model. A finished row rewrites its frozen position with the
        value it holds and an empty row writes the trash page, both no-ops
        in effect. Q is 1 for a micro-step, K for the speculative verify;
        the math is ``_decode_loop``'s step with the scalar position
        replaced by ``pos`` and the dense cache row by the gathered
        pages."""
        cfg, dt = self._decode_cfg, self._decode_cfg.dtype
        s, t = self._shard_slots, self.max_total
        nh, hd = self._pools[0][0].shape[2], cfg.head_dim     # heads here
        scale = 1.0 / (cfg.head_dim ** 0.5)
        blk = pos // self.page
        pg = bt[self._rows[:, None], blk]
        off = pos - blk * self.page
        visible = (self._key_pos[None, None, None, :]
                   <= pos[:, None, :, None])                     # [S,1,Q,T]
        load = None
        for layer, entry in zip(layers, self._pools):
            kp, vp, ks, vs = self._split(entry)
            h = rms_norm(x, layer.ln1.scale).to(dt)
            q, k, v = token_qkv(layer.attn, h, dt)               # [S,Q,H,D]
            q, k = _rope_grid(q, pos), _rope_grid(k, pos)
            self._page_write(kp, pg, off, k.to(dt), ks)
            self._page_write(vp, pg, off, v.to(dt), vs)
            ck = self._gather_kv(kp, ks, bt).reshape(s, t, nh, hd)
            cv = self._gather_kv(vp, vs, bt).reshape(s, t, nh, hd)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  ck.float()) * scale
            scores = torch.where(visible, scores,
                                 torch.full_like(scores, -1e30))
            x, ld = attn_out_mlp(layer, x, torch.softmax(scores, dim=-1), cv,
                                 dt)
            if ld is not None:
                load = ld if load is None else load + ld
        return x, load

    def _forward(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One token of every slot through the model at its position: the
        next-token logits [S, vocab] and the MoE load (``_layers``)."""
        pos = self._pos[:, None]                                 # [S, 1]
        x = F.embedding(self._buf[self._rows[:, None], pos],
                        self.model.embedding).to(self._decode_cfg.dtype)
        x, load = self._layers(self.model.layers, x, pos, self._bt)
        return final_logits(self._decode_cfg, self.model, x)[:, 0, :], load

    def _choose(self, logits: torch.Tensor) -> None:
        """Per-row choose and advance: the given prompt token while pos+1
        is inside the prompt, argmax at temperature 0, else the
        (seed, 0, pos)-keyed draw. Inactive rows write their CURRENT token
        back at pos, a no-op that keeps the step free of row selection."""
        rows, pos, t = self._rows, self._pos, self.max_total
        nxt = (pos + 1).clamp(max=t - 1)
        choice = torch.argmax(logits, dim=-1)
        temp, pos_h, seed = (self._mine(a) for a in (
            self._temp_h, self._pos_h, self._seed_h))
        for i in np.flatnonzero((temp > 0)
                                & (pos_h < self._mine(self._last_h))
                                & (pos_h + 1 >= self._mine(self._plen_h))):
            choice[i] = gumbel_draw(
                logits[i:i + 1], float(temp[i]),
                [(int(seed[i]), 0, int(pos_h[i]))], self._gen)[0]
        chosen = torch.where(pos + 1 < self._plen, self._buf[rows, nxt],
                             choice)
        active = pos < self._last
        self._buf[rows, torch.where(active, nxt, pos)] = torch.where(
            active, chosen, self._buf[rows, pos])
        self._pos += active
        self._pos_h += self._pos_h < self._last_h

    @torch.no_grad()
    def run_segment(self) -> None:
        """One dispatch. A plain engine advances every active slot
        ``segment`` tokens (finished and empty slots no-op in place); a
        speculative one runs ONE draft-K + K-wide-verify round instead,
        moving each row 1..K tokens (``poll_spec`` reads how far).
        Enqueues device work only: no value comes back to the host."""
        if self.spec_k:
            self._spec_round()
            return
        for _ in range(self.segment):
            logits, load = self._forward()
            if load is not None:
                self._expert_load += load
            self._choose(logits)

    @torch.no_grad()
    def poll(self) -> tuple[np.ndarray, np.ndarray]:
        """ONE batched device->host fetch: (token buffers [S, max_total],
        positions [S]) — retirement reads rows out of this, never
        per-scalar fetches. Under a mesh the dp shards' rows are gathered
        first, so every rank returns every slot."""
        both = self._gather_rows(torch.cat([self._buf, self._pos[:, None]],
                                           dim=1)).cpu().numpy()
        return both[:, :-1], both[:, -1]

    def poll_spec(self) -> tuple[np.ndarray, int, int]:
        """After speculative rounds: ONE batched device->host fetch of
        (positions [S], drafted, accepted), the counts summed over the
        rounds since the last call. Refreshes the host mirror of the
        positions and adds the counts to ``spec_draft_tokens`` /
        ``spec_accepted_tokens``."""
        stats = (self._spec_stats if self._spec_stats is not None
                 else torch.zeros(2, dtype=torch.long, device=self.device))
        # each dp shard's positions and counts: [shards, shard_slots + 2]
        both = self._gather_rows(torch.cat([self._pos, stats])[None])
        both = both.cpu().numpy()
        pos = both[:, :-2].reshape(-1)
        drafted, accepted = (int(v) for v in both[:, -2:].sum(0))
        self._spec_stats = None
        self._stale_h[:] = False
        self._pos_h[:] = pos
        self.spec_draft_tokens += drafted
        self.spec_accepted_tokens += accepted
        return pos, drafted, accepted

    @torch.no_grad()
    def expert_load(self) -> np.ndarray:
        """Per-expert dispatched-token counts ([moe_experts] float32) of
        every micro-step since the engine started, summed over layers (and
        over the dp shards: each routes its own rows whole); zeros before
        the first segment. One device->host fetch."""
        return cl.reduce_from(self._expert_load,
                              self._dp_group).cpu().numpy()

    @torch.no_grad()
    def debug_logits(self) -> np.ndarray:
        """Test hook: the next-token logits ``[S, vocab]`` every slot would
        choose from, by the micro-step's own path (the same quantizing
        write and dequantizing gather), without advancing any slot. (Its
        page writes are the ones the next micro-step makes.)"""
        return self._gather_rows(self._forward()[0]).cpu().numpy()

    # -- speculative decoding ---------------------------------------------------
    def _rewind(self, pos0: torch.Tensor, adv: torch.Tensor,
                last: torch.Tensor, live: torch.Tensor) -> None:
        """THE position rollback path: after a verify, every live row's
        ``pos`` moves to its accepted frontier (dispatch position plus
        its advance, clamped at ``last``); rows inactive at dispatch keep
        theirs. Pages above the frontier are not touched: the next round
        rewrites them before any mask exposes them, and ``release``
        returns the lookahead with the rest of the reservation."""
        self._pos.copy_(torch.where(live, torch.minimum(pos0 + adv, last),
                                    pos0))

    def _spec_noise(self) -> dict[int, tuple[float, torch.Tensor]]:
        """{row: (temperature, noise [K, vocab])} for every live sampled
        row: its Gumbel noise of positions pos0 .. pos0+K-1, keyed
        ``(seed, 0, position)`` from the host mirror and drawn once for
        both phases. Raises while a round has outdated the mirror."""
        temp, pos_h, seed = (self._mine(a) for a in (
            self._temp_h, self._pos_h, self._seed_h))
        rows = np.flatnonzero((temp > 0) & (pos_h < self._mine(self._last_h)))
        if self._mine(self._stale_h)[rows].any():
            raise RuntimeError(
                "speculative run_segment with live sampled rows needs "
                "poll_spec() after the previous round: their draws are "
                "keyed by the positions it fetches")
        vocab = self.cfg.vocab_size
        return {int(i): (float(temp[i]), gumbel_noise(
                    [(int(seed[i]), 0, int(pos_h[i]) + j)
                     for j in range(self.spec_k)],
                    vocab, self._gen, self.device))
                for i in rows}

    @staticmethod
    def _keyed_choice(logits: torch.Tensor, noise: dict,
                      step: int | None = None) -> torch.Tensor:
        """The model's choice from ``logits`` [S, V] (draft step ``step``)
        or [S, K, V] (the verify, all steps): argmax at temperature 0, a
        sampled row's Gumbel pick with its round's noise otherwise — the
        same noise in both phases, which makes a sampled proposal
        verifiable."""
        choice = torch.argmax(logits, dim=-1)
        for i, (temp, nz) in noise.items():
            choice[i] = gumbel_pick(logits[i], temp,
                                    nz if step is None else nz[step])
        return choice

    def _spec_round(self) -> None:
        """One speculative round (the reference's ``_spec_segment_body``):
        K draft micro-steps over layers < ``draft_layers`` through the
        draft block tables propose positions pos+1..pos+K; ONE K-wide
        verify pass through all layers scores them; each row commits its
        accepted prefix plus the target's correction and ``_rewind`` moves
        it to that frontier. Draft or verify steps past a row's ``last``
        write their KV into the reserved lookahead and commit nothing."""
        noise = self._spec_noise()
        cfg, model, K = self._decode_cfg, self.model, self.spec_k
        rows, buf, edge = self._rows, self._buf, self.max_total - 1
        last, plen = self._last, self._plen
        pos0 = self._pos.clone()
        live = pos0 < last
        steps = torch.arange(K, device=self.device)

        # -- draft: K cheap micro-steps through the first draft_layers ------
        for i in range(K):
            dq = torch.where(live, (pos0 + i).clamp(max=edge), pos0)
            x = F.embedding(buf[rows, dq][:, None],
                            model.embedding).to(cfg.dtype)
            x, _ = self._layers(model.layers[:self.draft_layers], x,
                                dq[:, None], self._dbt)
            logits = final_logits(cfg, model, x)[:, 0, :]
            widx = (dq + 1).clamp(max=edge)
            chosen = torch.where(dq + 1 < plen, buf[rows, widx],
                                 self._keyed_choice(logits, noise, i))
            # only proposals at or below `last` enter the buffer; the
            # overshoot steps rewrite widx with itself
            keep = live & (pos0 + i < last)
            buf[rows, widx] = torch.where(keep, chosen, buf[rows, widx])

        # -- verify: ONE K-wide pass through every layer ---------------------
        # (step i sees positions <= vq_i, earlier steps' K/V included)
        vq = torch.where(live[:, None],
                         (pos0[:, None] + steps[None, :]).clamp(max=edge),
                         pos0[:, None])                          # [S, K]
        x = F.embedding(buf[rows[:, None], vq], model.embedding).to(cfg.dtype)
        x, _ = self._layers(model.layers, x, vq, self._bt)
        logits = final_logits(cfg, model, x)                     # [S, K, V]

        # -- acceptance and commit ------------------------------------------
        widx = (vq + 1).clamp(max=edge)
        proposal = buf[rows[:, None], widx]
        target = torch.where(vq + 1 < plen[:, None], proposal,
                             self._keyed_choice(logits, noise))
        step_live = (pos0[:, None] + steps[None, :] < last[:, None]) \
            & live[:, None]
        match = (proposal == target) & step_live
        a = torch.cumprod(match.long(), dim=1).sum(dim=1)       # [S] in [0, K]
        adv = torch.where(a == K, K, a + 1)
        # the accepted-prefix+1 correction: the target's own choice at the
        # first mismatch, through the ordinary masked buffer write
        corr_tok = target[rows, a.clamp(max=K - 1)]
        corr = live & (a < K) & (pos0 + a + 1 <= last)
        wc = (pos0 + a + 1).clamp(max=edge)
        buf[rows, wc] = torch.where(corr, corr_tok, buf[rows, wc])
        self._rewind(pos0, adv, last, live)
        drafted = torch.where(live, (last - pos0).clamp(max=K), 0).sum()
        accepted = torch.where(live, a, 0).sum()
        stats = torch.stack([drafted, accepted])
        self._spec_stats = (stats if self._spec_stats is None
                            else self._spec_stats + stats)
        self._stale_h |= self._pos_h < self._last_h

    # -- host-side page accounting ------------------------------------------
    def _target_blocks(self, prompt_len: int, max_tokens: int) -> int:
        """Target blocks one request needs: its decode extent, plus under
        speculation the K-token lookahead (clamped at the context), since
        a verify dispatched near ``last`` still writes K KV rows."""
        extent = prompt_len + max_tokens
        if self.spec_k:
            extent = min(extent + self.spec_k, self.max_total)
        return -(-extent // self.page)

    def pages_for(self, prompt_len: int, max_tokens: int) -> int:
        """Pages one request reserves: its full decode extent, rounded up
        to whole pages, doubled under speculation for the draft's
        mirrored run. Prefix hits only ever need fewer, so admitting
        against this number never over-commits."""
        n = self._target_blocks(int(prompt_len), int(max_tokens))
        return 2 * n if self.spec_k else n

    def free_pages(self, shard: int = 0) -> int:
        return len(self._shards[shard].free)

    def evictable_pages(self, shard: int = 0) -> int:
        """Pages only the prefix cache is keeping alive (ref == cache_ref):
        exactly the pages a full LRU drain would hand back."""
        sh = self._shards[shard]
        return sum(1 for pg, r in sh.ref.items()
                   if r == sh.cache_ref.get(pg, 0))

    def pages_in_use(self, shard: int = 0) -> int:
        """Allocated pages (live slots + prefix cache), excluding the
        trash page."""
        sh = self._shards[shard]
        return sh.span - 1 - len(sh.free)

    @property
    def max_request_pages(self) -> int:
        """Largest page reservation one request may ask for: a whole dp
        shard's pool minus its trash page."""
        return self._span - 1

    def spill_pages_used(self, shard: int = 0) -> int:
        """Host pages the spill tier currently holds (bounded by
        ``spill_pages``)."""
        return self._shards[shard].spill_used

    def _lookup_prefix(self, shard_i: int, prompt: list[int]
                       ) -> tuple[int, tuple[int, ...]]:
        """Longest cached page-aligned prefix of ``prompt``. Returns
        (n_pages, pages); token equality is checked, so a hash collision
        becomes a miss, never wrong tokens."""
        sh = self._shards[shard_i]
        for n in range(len(prompt) // self.page, 0, -1):
            toks = tuple(prompt[:n * self.page])
            key = hash(toks)
            ent = sh.prefix.get(key)
            if ent is not None and ent[0] == toks:
                sh.prefix.move_to_end(key)      # LRU touch
                return n, ent[1]
        return 0, ()

    def _demote(self, sh: _PageShard, toks: tuple[int, ...],
                pgs: tuple[int, ...]) -> None:
        """Demote one cold cache-only prefix entry into the host spill
        tier before LRU eviction frees its device pages: one raw gather
        per kind of buffer (codes, and scale rows for a quantized pool,
        so the round trip is bit-exact) stacked over layers, and one
        device→host copy of each into host tensors (pinned on the card).
        The host LRU evicts its own cold entries until the newcomer fits
        ``spill_pages``; an entry larger than the whole bound is
        dropped."""
        n = len(pgs)
        if not self.spill_pages or n > self.spill_pages:
            return
        key = hash(toks)
        if key in sh.spill:
            sh.spill.move_to_end(key)
            return
        while sh.spill_used + n > self.spill_pages and sh.spill:
            _k, (_t, _p, m) = sh.spill.popitem(last=False)
            sh.spill_used -= m
        payload = []
        if self._owns(sh.index):    # another shard's pages are not here
            idx = torch.as_tensor(self._local_pages(pgs), device=self.device)
            parts = [self._split(e) for e in self._pools]
            pin = self.device.type == "cuda"
            for kind in range(4 if self._quantized else 2):
                dev = torch.stack([self._page_export(p[kind], idx)
                                   for p in parts])
                host = torch.empty(dev.shape, dtype=dev.dtype,
                                   pin_memory=pin)
                host.copy_(dev)
                payload.append(host)
        sh.spill[key] = (toks, tuple(payload), n)
        sh.spill_used += n
        self.demotions += 1

    def _ensure_free(self, sh: _PageShard, need: int) -> None:
        """Evict LRU prefix entries until ``need`` pages are free. Pages a
        live slot still pins survive eviction (ref stays > 0). Entries
        whose pages are ALL cache-only — the cold ones whose K/V would
        otherwise be lost — demote into the host spill tier first."""
        while len(sh.free) < need and sh.prefix:
            _key, (toks, pgs) = sh.prefix.popitem(last=False)
            if all(sh.ref[pg] == sh.cache_ref.get(pg, 0) for pg in pgs):
                self._demote(sh, toks, pgs)
            for pg in pgs:
                sh.cache_ref[pg] -= 1
                if not sh.cache_ref[pg]:
                    del sh.cache_ref[pg]
                sh.ref[pg] -= 1
                if not sh.ref[pg]:
                    del sh.ref[pg]
                    sh.free.append(pg)
        if len(sh.free) < need:
            raise RuntimeError(
                f"page pool exhausted on dp shard {sh.index}: need {need} "
                f"free pages, {len(sh.free)} available after draining the "
                f"prefix cache ({sh.span - 1} usable pages per shard; "
                f"raise pages= or admit less concurrency)")

    def _promote_spill(self, sh: _PageShard, prompt: list[int],
                       n_hit: int, hit_pages: tuple[int, ...]
                       ) -> tuple[int, tuple[int, ...]]:
        """Promote the longest spilled prefix of ``prompt`` that beats the
        device cache's hit: land its raw pages host→device in freshly
        allocated pages and publish them as cache-only prefix entries, so
        the caller's plan shares them like any other hit. The entry is
        popped BEFORE ``_ensure_free`` runs: eviction inside the
        allocation may demote OTHER entries into the spill LRU, and the
        one mid-promotion must not be evicted from under us. If the pool
        cannot host the promotion even after draining the prefix cache,
        the entry goes back and the plan falls back to the device hit,
        looked up again (the failed drain may have evicted it) — the
        spill tier never deadlocks admission."""
        best_key = None
        for n in range(len(prompt) // self.page, n_hit, -1):
            toks = tuple(prompt[:n * self.page])
            key = hash(toks)
            ent = sh.spill.get(key)
            if ent is not None and ent[0] == toks:
                best_key = key
                break
        if best_key is None:
            return n_hit, hit_pages
        toks, payload, n = sh.spill.pop(best_key)
        sh.spill_used -= n
        try:
            self._ensure_free(sh, n)
        except RuntimeError:
            sh.spill[best_key] = (toks, payload, n)
            sh.spill_used += n
            return self._lookup_prefix(sh.index, prompt)
        pages = [sh.free.pop() for _ in range(n)]
        if self._owns(sh.index):
            self._land_pages(pages, payload)
        self._publish_prefix(sh, list(toks), pages)
        self.promoted_hits += 1
        return n, tuple(pages)

    def _land_pages(self, pages: list[int], payload: tuple) -> None:
        """Land one spill payload (per kind of buffer, stacked over
        layers) in freshly allocated device pages: one host→device
        transfer per kind, then ``_page_copy`` per layer."""
        dst = torch.as_tensor(self._local_pages(pages), device=self.device)
        src = torch.arange(len(pages), device=self.device)
        # ko: lint-ok[KO101] one copy per kind of buffer (K, V and, for a quantized pool, their scales), each already stacked over the layers
        kinds = [b.to(self.device) for b in payload]
        for li, entry in enumerate(self._pools):
            kp, vp, ks, vs = self._split(entry)
            if ks is None:
                self._page_copy(kp, dst, src, kinds[0][li])
                self._page_copy(vp, dst, src, kinds[1][li])
            else:
                self._page_copy(kp, dst, src, kinds[0][li], scale=ks,
                                src_scale=kinds[2][li])
                self._page_copy(vp, dst, src, kinds[1][li], scale=vs,
                                src_scale=kinds[3][li])

    def _publish_prefix(self, sh: _PageShard, toks: list[int],
                        pages: list[int]) -> None:
        """Register every page-aligned prefix of ``toks`` over freshly
        landed ``pages`` as cache-only entries (ref == cache_ref), i.e.
        evictable under pool pressure like any other prefix entry —
        shared by the import and spill-tier promotion."""
        for m in range(1, len(pages) + 1):
            ptoks = tuple(toks[:m * self.page])
            key = hash(ptoks)
            ent = sh.prefix.get(key)
            if ent is not None:
                if ent[0] == ptoks:
                    sh.prefix.move_to_end(key)
                continue        # hash collision: keep the resident entry
            pgs = tuple(pages[:m])
            sh.prefix[key] = (ptoks, pgs)
            for pg in pgs:
                sh.ref[pg] = sh.ref.get(pg, 0) + 1
                sh.cache_ref[pg] = sh.cache_ref.get(pg, 0) + 1

    def _release_slot(self, slot: int) -> None:
        pages = self._slot_pages.pop(slot, None)
        if not pages:
            return
        sh = self._shards[self._shard_of(slot)]
        for pg in pages:
            sh.ref[pg] -= 1
            if not sh.ref[pg]:
                del sh.ref[pg]
                sh.free.append(pg)

    def release(self, slots: Sequence[int]) -> None:
        """Hand retired slots' pages back to the allocator (pages the
        prefix cache also holds stay resident for future hits) and point
        every retired block table at the trash page, so the frozen row's
        no-op K/V writes can never corrupt a page the next admission
        hands out."""
        freed = [int(s) for s in slots if int(s) in self._slot_pages]
        for s in freed:
            self._release_slot(s)
            trash = self._shards[self._shard_of(s)].trash
            self._bt_np[s, :] = trash
            if self.spec_k:
                # the draft run and the over-speculated lookahead go back
                # with the tables: no data moves
                self._dbt_np[s, :] = trash
        self._push_block_tables(freed)

    # -- admission ----------------------------------------------------------
    @torch.no_grad()
    def admit(self, entries: Sequence[tuple[int, Sequence[int], int, float,
                                            int]]) -> dict[int, int]:
        """Admit ``(slot, prompt_ids, max_tokens, temperature, seed)``
        tuples into their (free) slots. Pages are reserved per request
        (prefix-cache hits map shared pages in and skip their prefill;
        copy-on-write duplicates the first page the request writes), then
        one chunked forward pass per distinct (bucket, hit length) pair
        fills the fresh pages and the per-slot state vectors are set.
        Returns {slot: pos}.

        The order is fixed: plan/allocate -> copy-on-write -> prefill
        writes -> state vectors -> block tables -> prefix registration.
        Copy-on-write reads its source pages before any write of this wave
        can touch a recycled page, so even a source that eviction freed
        mid-wave (and another plan of the wave took) is copied intact."""
        plans, cow_pairs = self._plan_entries(entries)
        self.last_plans = {
            pl["slot"]: {
                "shard": pl["shard"], "pages": len(pl["pages"]),
                "bucket": pl["c"], "hit_len": pl["h"], "pos0": pl["pos0"],
                "pages_reused": pl["h"] // self.page,
                "hit_kind": ("full" if pl["h"] == pl["plen"]
                             else "cover" if pl["h"] >= pl["c"]
                             else "partial" if pl["h"] else "miss"),
            } for pl in plans}
        # the device work is this rank's shard's: its plans, its pages
        mine = [pl for pl in plans if self._owns(pl["shard"])]
        self._apply_cow([pair for pair, shard in cow_pairs
                         if self._owns(shard)])
        groups: dict[tuple[int, int], list[dict]] = {}
        nopass: list[dict] = []
        for pl in mine:
            if pl["h"] < pl["c"]:
                groups.setdefault((pl["c"], pl["h"]), []).append(pl)
            else:
                nopass.append(pl)
        for (c, h), group in sorted(groups.items()):
            self._admit_group(c, h, group)
        if nopass:
            self._admit_nopass(nopass)
        self._set_mirrors(plans)
        if self.spec_k:
            self._seed_draft(mine)
        self._push_block_tables([pl["slot"] for pl in plans])
        self._register_prefixes(plans)
        return {pl["slot"]: pl["pos0"] for pl in plans}

    def _seed_draft(self, plans: list[dict]) -> None:
        """Seed each admitted slot's draft pages: the draft IS the
        target's first ``draft_layers`` layers, so its layer-l KV over the
        prompt equals the target's. One whole-page ``_page_copy`` of the
        target blocks below the write frontier, for those layers (raw
        codes and scales, so quantized pools stay bit-exact)."""
        dst, src = [], []
        for pl in plans:
            n = -(-pl["pos0"] // self.page)
            dst.extend(pl["dpages"][:n])
            src.extend(pl["pages"][:n])
        if not dst:
            return
        dj = torch.as_tensor(self._local_pages(dst), device=self.device)
        sj = torch.as_tensor(self._local_pages(src), device=self.device)
        for entry in self._pools[:self.draft_layers]:
            kp, vp, ks, vs = self._split(entry)
            self._page_copy(kp, dj, sj, scale=ks)
            self._page_copy(vp, dj, sj, scale=vs)

    def _plan_entries(self, entries) -> tuple[list[dict], list]:
        """Validate, look up prefixes, and reserve pages for one admission
        wave, each slot on its dp shard's allocator. Host-only, apart from
        a spill promotion's page landing. Returns the plans and the
        copy-on-write ((dst, src), shard) pairs."""
        plans: list[dict] = []
        cow_pairs: list[tuple[tuple[int, int], int]] = []
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
            sh = self._shards[self._shard_of(slot)]
            plen = len(prompt)
            # a re-admitted slot implicitly releases its previous pages
            # (its block table is rewritten below, before any segment runs)
            self._release_slot(slot)
            blocks_needed = self._target_blocks(plen, mt)
            n_hit, hit_pages = self._lookup_prefix(sh.index, prompt)
            if sh.spill and n_hit * self.page < plen:
                # a demoted prefix may cover more of the prompt than the
                # device cache still does: promote it instead of
                # recomputing that share of the prefill
                n_hit, hit_pages = self._promote_spill(
                    sh, prompt, n_hit, hit_pages)
            c = _pow2_at_most(plen)
            h = n_hit * self.page
            if h == plen:
                # the whole prompt is cached: re-decode its last token (one
                # micro-step) to recover its logits, in a copy-on-write page
                pos0 = plen - 1
            elif h >= c:
                pos0 = h        # the hit covers the prefill bucket: skip it
            else:
                pos0 = c        # prefill [h, c), seeded from shared pages
            first_write_blk = pos0 // self.page
            cow_blk = first_write_blk if first_write_blk < n_hit else None
            # pin the pages about to be shared BEFORE eviction can free
            # them, then make room for the fresh ones
            shared = [hit_pages[b] for b in range(n_hit) if b != cow_blk]
            for pg in shared:
                sh.ref[pg] += 1
            # the draft's mirrored run is always freshly allocated (never
            # prefix-cached or shared), so it adds blocks_needed
            need = blocks_needed - len(shared)
            if self.spec_k:
                need += blocks_needed
            self._ensure_free(sh, need)
            if n_hit:
                self.prefix_hits += 1
                self.prefix_pages_reused += n_hit
            pages: list[int] = []
            for b in range(blocks_needed):
                if b < n_hit and b != cow_blk:
                    pages.append(hit_pages[b])
                else:
                    pg = sh.free.pop()
                    sh.ref[pg] = 1
                    if b == cow_blk:
                        cow_pairs.append(((pg, hit_pages[b]), sh.index))
                        self.cow_copies += 1
                    pages.append(pg)
            dpages: list[int] = []
            if self.spec_k:
                for _ in range(blocks_needed):
                    dpg = sh.free.pop()
                    sh.ref[dpg] = 1
                    dpages.append(dpg)
                self._dbt_np[slot, :] = sh.trash
                self._dbt_np[slot, :blocks_needed] = dpages
            self._slot_pages[slot] = pages + dpages
            self._bt_np[slot, :] = sh.trash
            self._bt_np[slot, :blocks_needed] = pages
            plans.append(dict(slot=slot, prompt=prompt, plen=plen, mt=mt,
                              temp=float(temperature), seed=int(seed),
                              c=c, h=h, pos0=pos0, pages=pages,
                              dpages=dpages, shard=sh.index))
        return plans, cow_pairs

    def _apply_cow(self, cow_pairs: list[tuple[int, int]]) -> None:
        """Every copy-on-write of the wave as one gather of all sources and
        one scatter into all destinations per buffer."""
        if not cow_pairs:
            return
        dst = torch.as_tensor(self._local_pages([d for d, _ in cow_pairs]),
                              device=self.device)
        src = torch.as_tensor(self._local_pages([s for _, s in cow_pairs]),
                              device=self.device)
        for entry in self._pools:
            kp, vp, ks, vs = self._split(entry)
            self._page_copy(kp, dst, src, scale=ks)
            self._page_copy(vp, dst, src, scale=vs)

    def _admit_group(self, c: int, h: int, group: list[dict]
                     ) -> dict[int, int]:
        """One chunked prefill for every plan of (bucket c, hit h): a
        compact [k, c-h] pass over positions [h, c) with c-wide scratch
        caches (the transformer's decode branch masks to the cache width),
        seeded at [0, h) from the shared pages through ``_gather_kv`` — so
        the pass attends over exactly the K/V the micro-step would see —
        then one page-routed write of positions [h, c) into each pool."""
        cfg, dev = self._decode_cfg, self.device
        nh, hd = self._pools[0][0].shape[2], cfg.head_dim     # heads here
        k, w = len(group), c - h
        chunk = torch.as_tensor(np.array([pl["prompt"][h:c] for pl in group]),
                                dtype=torch.long, device=dev)
        parts = [self._split(e) for e in self._pools]
        scratch = [(torch.zeros((k, c, nh, hd), dtype=cfg.dtype, device=dev),
                    torch.zeros((k, c, nh, hd), dtype=cfg.dtype, device=dev))
                   for _ in range(cfg.n_layers)]
        if h:
            blk = torch.as_tensor(self._local_pages(
                [pl["pages"][:h // self.page] for pl in group]), device=dev)
            for (sk, sv), (kp, vp, ks, vs) in zip(scratch, parts):
                sk[:, :h] = self._gather_kv(kp, ks, blk).reshape(k, h, nh, hd)
                sv[:, :h] = self._gather_kv(vp, vs, blk).reshape(k, h, nh, hd)
        logits = self.model(chunk, torch.arange(h, c, device=dev), scratch)

        # route positions [h, c) through each plan's block table into the
        # pools: indices stacked on the host, moved once, one write each
        hpos = np.arange(h, c)
        pg = torch.as_tensor(self._local_pages(
            [[pl["pages"][p // self.page] for p in hpos] for pl in group]
        ).reshape(-1), device=dev)
        off = torch.as_tensor(np.tile(hpos % self.page, k), device=dev)
        for (kp, vp, ks, vs), (sk, sv) in zip(parts, scratch):
            self._page_write(kp, pg, off, sk[:, h:c].reshape(k * w, nh, hd),
                             ks)
            self._page_write(vp, pg, off, sv[:, h:c].reshape(k * w, nh, hd),
                             vs)

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

    def _admit_nopass(self, group: list[dict]) -> None:
        """Plans whose prefill the prefix cache covers: no forward pass at
        all. A full-prompt hit starts one position back (pos = plen-1) and
        re-decodes the boundary token inside its copy-on-write page to
        recover the first generated token's logits."""
        pos_np = np.array([pl["pos0"] for pl in group], np.int64)
        rows = torch.as_tensor(self._prompt_rows(group), device=self.device)
        self._scatter_state(group, pos_np, rows)

    def _prompt_rows(self, group: list[dict]) -> np.ndarray:
        rows_np = np.zeros((len(group), self.max_total), np.int64)
        for i, pl in enumerate(group):
            rows_np[i, :pl["plen"]] = pl["prompt"]
        return rows_np

    def _scatter_state(self, group: list[dict], pos_np: np.ndarray,
                       rows: torch.Tensor) -> None:
        """One batched transfer and one indexed write per state vector of
        this shard's admitted rows."""
        slots_np = np.array([pl["slot"] for pl in group], np.int64)
        plens_np = np.array([pl["plen"] for pl in group], np.int64)
        last_np = plens_np + np.array([pl["mt"] for pl in group]) - 1
        idx = torch.as_tensor(slots_np - self._lo, device=self.device)
        self._buf[idx] = rows
        self._pos[idx] = torch.as_tensor(pos_np, device=self.device)
        self._last[idx] = torch.as_tensor(last_np, device=self.device)
        self._plen[idx] = torch.as_tensor(plens_np, device=self.device)

    def _set_mirrors(self, plans: list[dict]) -> None:
        """The host mirrors of every admitted slot, on every shard: the
        values ``_scatter_state`` wrote on the device."""
        slots_np = np.array([pl["slot"] for pl in plans], np.int64)
        plens_np = np.array([pl["plen"] for pl in plans], np.int64)
        self._pos_h[slots_np] = [pl["pos0"] for pl in plans]
        self._last_h[slots_np] = plens_np + np.array(
            [pl["mt"] for pl in plans]) - 1
        self._plen_h[slots_np] = plens_np
        self._temp_h[slots_np] = [pl["temp"] for pl in plans]
        self._seed_h[slots_np] = [pl["seed"] for pl in plans]
        self._stale_h[slots_np] = False

    def _push_block_tables(self, slots: Sequence[int]) -> None:
        """Copy the host block tables of ``slots`` that live on this
        rank's shard to the device, in its local page ids."""
        idx_np = np.asarray(sorted(set(int(s) for s in slots
                                       if self._owns(self._shard_of(s)))),
                            np.int64)
        if not len(idx_np):
            return
        idx = torch.as_tensor(idx_np - self._lo, device=self.device)
        self._bt[idx] = torch.as_tensor(
            self._local_pages(self._bt_np[idx_np]), device=self.device)
        if self.spec_k:
            self._dbt[idx] = torch.as_tensor(
                self._local_pages(self._dbt_np[idx_np]), device=self.device)

    def _register_prefixes(self, plans: list[dict]) -> None:
        """Publish every page-aligned prefix strictly below each plan's
        write frontier (pages at or above pos0 may still be written by the
        slot and must never be shared)."""
        for pl in plans:
            sh = self._shards[pl["shard"]]
            for n in range(1, pl["pos0"] // self.page + 1):
                toks = tuple(pl["prompt"][:n * self.page])
                key = hash(toks)
                ent = sh.prefix.get(key)
                if ent is not None:
                    if ent[0] == toks:
                        sh.prefix.move_to_end(key)
                    continue        # hash collision: keep the resident entry
                pgs = tuple(pl["pages"][:n])
                sh.prefix[key] = (toks, pgs)
                for pg in pgs:
                    sh.ref[pg] += 1
                    sh.cache_ref[pg] = sh.cache_ref.get(pg, 0) + 1

    # -- prefill→decode handoff, engine half ----------------------------------
    def _row_ranks(self, shard: int) -> list[int]:
        """The global ranks of dp shard ``shard``'s row in tp order (its
        first ep rank's: the ep ranks of a row hold the same KV)."""
        names = self.mesh.mesh_dim_names
        at = tuple(shard if a == "dp" else slice(None) if a == "tp" else 0
                   for a in names)
        return [int(r) for r in self.mesh.mesh[at].reshape(-1).tolist()]

    def _heads(self) -> slice:
        """This rank's heads of the pool: [t·H/tp, (t+1)·H/tp)."""
        h = self.cfg.n_heads // (self.spec.tp if self.spec else 1)
        t = sharding.axis_index(self.mesh, "tp")
        return slice(t * h, (t + 1) * h)

    def check_payload(self, tokens: Sequence[int], layers: Any) -> None:
        """Raise, before any page moves, for a handoff payload this engine
        cannot import: a prefix that is not a non-empty multiple of the
        page, or a payload that is missing or whose layer count is not
        the model's. On a meshed rank other than 0 only the tokens are
        checked: rank 0's payload is the one landed."""
        if not tokens or len(tokens) % self.page:
            raise ValueError(
                f"imported prefix must be a non-empty multiple of the "
                f"page size ({self.page}), got {len(tokens)} tokens")
        if self.spec is not None and dist.get_rank() != 0:
            return
        if layers is None:
            raise ValueError("handoff payload is None: no pages to land")
        if len(layers) != self.cfg.n_layers:
            raise ValueError(
                f"handoff payload has {len(layers)} layers, engine has "
                f"{self.cfg.n_layers}")

    @torch.no_grad()
    def export_prefix(self, slot: int, n_pages: int
                      ) -> list[tuple[torch.Tensor, torch.Tensor]] | None:
        """Whole-page gather of ``slot``'s first ``n_pages`` KV pages, the
        prefill worker's half of a handoff. The caller guarantees the pages
        are final (the slot's position has passed ``n_pages * page``).
        Returns one ``(k_pages, v_pages)`` pair per layer, each ``[n,
        page, H, D]`` with every head, in the model dtype and on the
        engine's device: a quantized pool exports dequantized pages, so
        any pool layout can import them.

        Over a serving mesh every rank calls it (``EngineLeader`` sends
        it as a command): the ranks of the slot's dp row gather their
        head slices of its pages, every rank's block goes to rank 0 in one
        ``gather`` of device tensors over the world, and rank 0 joins its
        row's slices in tp order and returns the payload; the other ranks
        return None."""
        pages = self._slot_pages.get(int(slot), [])
        if n_pages > len(pages):
            raise ValueError(
                f"slot {slot} holds {len(pages)} pages, cannot export "
                f"{n_pages}")
        pages = pages[:n_pages]
        shard = self._shard_of(slot)
        if self.spec is None or self._owns(shard):
            idx = torch.as_tensor(self._local_pages(pages),
                                  device=self.device)
            mine = [(self._gather_kv(kp, ks, idx),
                     self._gather_kv(vp, vs, idx))
                    for kp, vp, ks, vs in map(self._split, self._pools)]
            if self.spec is None:
                return mine
            block = torch.stack([torch.stack(kv) for kv in mine])
        else:
            heads = self._heads()
            h = heads.stop - heads.start
            block = torch.zeros(
                (self.cfg.n_layers, 2, n_pages, self.page, h,
                 self.cfg.head_dim), dtype=self.cfg.dtype,
                device=self.device)
        lead = dist.get_rank() == 0
        parts = ([torch.empty_like(block)
                  for _ in range(dist.get_world_size())] if lead else None)
        dist.gather(block, parts, dst=0)
        if not lead:
            return None
        whole = torch.cat([parts[r] for r in self._row_ranks(shard)], dim=4)
        return [(whole[li, 0], whole[li, 1])
                for li in range(self.cfg.n_layers)]

    @torch.no_grad()
    def import_prefix(self, tokens: Sequence[int], layers: Any,
                      shard: int = 0) -> int:
        """Decode-side half of the handoff: land exported KV pages in this
        pool and publish them to the prefix cache, so the next ``admit``
        of a prompt opening with ``tokens`` hits and skips that share of
        prefill. ``tokens`` must be page-aligned; ``layers`` is one
        ``(k_pages, v_pages)`` pair per layer in the model dtype (a
        quantized pool quantizes them on land). The entries start
        cache-only, i.e. evictable. Returns the pages newly imported (0
        when the cache already covers the prefix). Call from the thread
        that drives admit/release.

        Over a serving mesh every rank calls it with the same tokens
        (``EngineLeader`` sends it as a command carrying no payload):
        rank 0's ``layers`` is broadcast as one device tensor over the
        world, the ranks of dp shard ``shard``'s row land their heads of
        it, and every rank publishes the same prefix entry, so the host
        state stays the same on every rank. The other ranks' ``layers``
        are not read (None will do)."""
        toks = [int(t) for t in tokens]
        meshed = self.spec is not None
        self.check_payload(toks, layers)
        n = len(toks) // self.page
        sh = self._shards[shard]
        n_hit, _ = self._lookup_prefix(shard, toks)
        if n_hit >= n:
            return 0
        self._ensure_free(sh, n)
        pages = [sh.free.pop() for _ in range(n)]
        dt = self.cfg.dtype
        if not meshed or dist.get_rank() == 0:
            # every layer's K and V stacked where they are, moved once
            whole = torch.stack([torch.stack([lk, lv]) for lk, lv in layers]
                                ).to(self.device, dt)
        else:
            whole = torch.empty(
                (self.cfg.n_layers, 2, n, self.page, self.cfg.n_heads,
                 self.cfg.head_dim), dtype=dt, device=self.device)
        if meshed:
            dist.broadcast(whole, src=0)
        if not meshed or self._owns(shard):
            heads = self._heads() if meshed else slice(None)
            dst = torch.as_tensor(self._local_pages(pages),
                                  device=self.device)
            src = torch.arange(n, device=self.device)
            for li, entry in enumerate(self._pools):
                kp, vp, ks, vs = self._split(entry)
                self._page_copy(kp, dst, src, whole[li, 0, :, :, heads],
                                scale=ks)
                self._page_copy(vp, dst, src, whole[li, 1, :, :, heads],
                                scale=vs)
        self._publish_prefix(sh, toks, pages)
        return n


# ---------------------------------------------------------------------------
# the host protocol across the ranks of a serving mesh
# ---------------------------------------------------------------------------

#: the engine calls the leader sends to every rank before running them
ENGINE_COMMANDS = ("admit", "run_segment", "poll", "poll_spec", "release",
                   "expert_load", "debug_logits", "export_prefix",
                   "import_prefix")

# a follower waits for the leader's next command as long as the server
# idles, so the control group's collectives must outlast any idle spell
_CONTROL_TIMEOUT = timedelta(days=30)


def _import_call(tokens, layers, shard: int = 0) -> dict:
    """``import_prefix``'s arguments by name."""
    return {"tokens": [int(t) for t in tokens], "layers": layers,
            "shard": int(shard)}


class EngineLeader:
    """Rank 0's handle on a ``SlotPoolEngine`` over a serving mesh, for
    ``ContinuousBatcher``: each of ``ENGINE_COMMANDS`` is broadcast to the
    other ranks (which run ``follow``) and then run here; everything else
    is the engine's own attribute. One lock orders the commands, so the
    batcher's worker and ``stop()`` never interleave theirs."""

    def __init__(self, engine: SlotPoolEngine):
        if engine.control is None:
            raise ValueError("EngineLeader needs an engine on a serving "
                             "mesh")
        self.engine = engine
        self._group = engine.control
        self._lock = threading.Lock()
        self._stopped = False

    def _command(self, name: str, args: tuple, kwargs: dict):
        with self._lock:
            if self._stopped:
                raise RuntimeError("the serving mesh has stopped")
            sent = args, kwargs
            if name == "import_prefix":
                # the command carries the tokens only: the payload moves
                # inside the call, as a broadcast of device tensors. A bad
                # payload raises here, before any rank is told
                call = _import_call(*args, **kwargs)
                self.engine.check_payload(call["tokens"], call["layers"])
                sent = (call["tokens"], None), {"shard": call["shard"]}
            dist.broadcast_object_list([(name, *sent)], src=0,
                                       group=self._group)
            return getattr(self.engine, name)(*args, **kwargs)

    def __getattr__(self, name: str):
        if name in ENGINE_COMMANDS:
            return lambda *a, **kw: self._command(name, a, kw)
        return getattr(self.engine, name)

    def stop(self) -> None:
        """Release the followers (idempotent)."""
        with self._lock:
            if not self._stopped:
                self._stopped = True
                dist.broadcast_object_list([("stop", (), {})], src=0,
                                           group=self._group)


def follow(engine: SlotPoolEngine) -> None:
    """A rank other than 0 of a serving mesh: run each engine command the
    leader broadcasts, in order, until its ``stop()``. A command that
    raises here raises on the leader too (every rank holds the same host
    state), where the batcher fails its requests and resets the pool with
    further commands, so the follower goes on to the next one."""
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=engine.control)
        name, args, kwargs = box[0]
        if name == "stop":
            return
        if name not in ENGINE_COMMANDS:
            raise RuntimeError(f"unknown engine command {name!r}")
        try:
            getattr(engine, name)(*args, **kwargs)
        except Exception:  # noqa: BLE001 — the leader meets the same error
            continue
