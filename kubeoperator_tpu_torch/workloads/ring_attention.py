"""Sequence-parallel attention, the counterpart of
``kubeoperator_tpu/workloads/ring_attention.py``.

The sequence is split over the mesh's ``sp`` group. Ring attention keeps
each rank's Q block and passes K/V blocks one hop around the group
(``collectives.ppermute``), merging block results with an online softmax,
so each rank holds O(T/sp) of the sequence. Ulysses attention instead
regroups [seq-split, all heads] into [whole seq, head-split] with one
``all_to_all`` each way and runs blockwise attention on its head group.

As in the reference these are einsums, not kernels: scores in f32,
probabilities cast to V's dtype, the ``-1e30`` guard on all-masked rows
and ``l == 0 → 1`` kept. Functions take per-rank blocks
[B, T_local, H, D] and the sp process group (None: one rank), or the
mesh (``sharded_*``).
"""

from __future__ import annotations

import torch

from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads.sharding import axis_group


def _block_attn(q, k, v, q_pos, kv_pos, scale, causal):
    """One Q block × one K/V block. Returns unnormalised (o, l, m): o
    [B, Tq, H, D] f32, l and m [B, H, Tq]. Positions are global."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[None, None, :, None] >= kv_pos[None, None, None, :]
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1)
    # all-masked rows: keep m finite so exp() below is well-defined
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, -1e30))
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    # P in V's dtype, then products and sums in f32 (the reference's
    # preferred_element_type=f32)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, l, m


def _merge(o1, l1, m1, o2, l2, m2):
    """Combine two online-softmax partials."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = (o1 * a1.transpose(1, 2)[..., None]
         + o2 * a2.transpose(1, 2)[..., None])
    return o, l, m


def _normalise(o, l, dtype):
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l.transpose(1, 2)[..., None]).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """Attention over a sequence split over ``group`` (None: plain
    attention). q, k, v: this rank's [B, T_local, H, D] blocks, in rank
    order along the sequence. Returns [B, T_local, H, D] in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    t_local = q.shape[1]
    pos = torch.arange(t_local, device=q.device)
    n, me = cl.group_size(group), cl.group_rank(group)
    if n == 1:
        o, l, m = _block_attn(q, k, v, pos, pos, scale, causal)
        return (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    q_pos = me * t_local + pos
    b, _, h, d = q.shape
    o = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t_local), -1e30, dtype=torch.float32,
                   device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        # after i hops of "send to next" we hold rank me - i's block
        kv_pos = ((me - i) % n) * t_local + pos
        bo, bl, bm = _block_attn(q, kv[0], kv[1], q_pos, kv_pos, scale,
                                 causal)
        o, l, m = _merge(o, l, m, bo, bl, bm)
        if i + 1 < n:
            kv = cl.ppermute(kv, group, 1)
    return _normalise(o, l, q.dtype)


def sharded_ring_attention(mesh, q, k, v, causal: bool = True):
    """The reference's shard_map wrapper, per rank: q/k/v are this rank's
    blocks (rows over the data axes, the sequence over sp, heads over tp)
    and the ring runs over the mesh's sp group."""
    return ring_attention(q, k, v, axis_group(mesh, "sp"), causal=causal)


def blockwise_attention(q, k, v, causal: bool = True,
                        chunk: int = 1024) -> torch.Tensor:
    """Unsplit attention with K/V taken in chunks (online softmax):
    O(T·chunk) score memory. The local step of Ulysses."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    b, t, h, d = q.shape
    chunk = min(chunk, t)
    pos = torch.arange(t, device=q.device)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), -1e30, dtype=torch.float32, device=q.device)
    for start in range(0, t, chunk):
        bo, bl, bm = _block_attn(q, k[:, start:start + chunk],
                                 v[:, start:start + chunk], pos,
                                 pos[start:start + chunk], scale, causal)
        o, l, m = _merge(o, l, m, bo, bl, bm)
    return _normalise(o, l, q.dtype)


def ulysses_attention(q, k, v, group, causal: bool = True) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: an all-to-all turns
    [B, T/sp, H, D] blocks into [B, T, H/sp, D], blockwise attention runs
    on the head group, and the inverse all-to-all turns it back. Heads
    must divide by sp."""
    n = cl.group_size(group)
    b, t_local, h, d = q.shape
    if h % n:
        raise ValueError(f"ulysses needs heads ({h}) divisible by sp ({n})")

    def seq_to_heads(x):
        # chunk j of the heads goes to rank j; the received sequence
        # blocks concatenate in rank order (= global order)
        x = x.reshape(b, t_local, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = cl.all_to_all(x, group)
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * t_local, h // n, d)

    def heads_to_seq(x):
        x = x.reshape(b, n, t_local, h // n, d).permute(1, 0, 2, 3, 4)
        x = cl.all_to_all(x, group)
        return x.permute(1, 2, 0, 3, 4).reshape(b, t_local, h, d)

    out = blockwise_attention(seq_to_heads(q), seq_to_heads(k),
                              seq_to_heads(v), causal=causal)
    return heads_to_seq(out)


def sharded_ulysses_attention(mesh, q, k, v, causal: bool = True):
    """``sharded_ring_attention``'s counterpart for Ulysses."""
    return ulysses_attention(q, k, v, axis_group(mesh, "sp"), causal=causal)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """O(S²)-memory attention. q/k/v: [B, T, H, D]. Scores in f32, masked
    with -inf; probabilities cast to v's dtype, the output to q's."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
