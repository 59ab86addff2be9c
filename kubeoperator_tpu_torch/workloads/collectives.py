"""Collectives that carry gradients, for the port's multi-device paths.

In JAX, autodiff transposes every collective: ``ppermute`` into the
reverse permute, a tiled ``all_gather`` into a reduce-scatter,
``all_to_all`` into the inverse ``all_to_all`` and ``psum`` into a
broadcast. ``torch.distributed``'s calls have no autograd, so each one
here is a ``torch.autograd.Function`` whose backward is its transpose:

* ``ppermute(x, group, shift)``: every rank sends ``x`` to rank + shift
  of ``group`` and returns what rank − shift sent
  (``dist.batch_isend_irecv``); backward the reverse shift. Ring
  attention and GPipe hop with it.
* ``all_to_all(x, group)``: chunk j of dim 0 goes to rank j
  (``all_to_all_single``); its own transpose. Ulysses regroups with it.
* ``all_gather(x, group, dim)``: tiled gather along ``dim``; backward
  the reduce-scatter that sums each rank's gradient into its shard.
  ``gather_start`` issues the same gather asynchronously and its handle's
  ``wait()`` joins the result to the graph: the overlapped ZeRO-3 step
  prefetches layer i+1 with it while layer i computes.
* ``gather_alike(x, group, dim)``: the same tiled gather, for ranks
  that go on to compute alike with the whole tensor (the ep ranks of an
  MoE router, which route the same tokens): their gradients of it are
  equal, so the backward keeps this rank's block of it instead of
  summing them.
* ``reduce_from(x, group)``: ``psum``; backward the identity (Megatron's
  "g", after a row-parallel product).
* ``copy_to(x, group)``: the identity; backward ``psum`` (Megatron's
  "f", before a column-parallel product, and on a replicated parameter
  whose per-rank gradients must be summed).
* ``psum(x, group)``: ``psum``; backward ``psum`` too, the transpose JAX
  gives it. A statistic of the global batch (BatchNorm's moments under
  dp×fsdp) needs it: each rank's rows feed a value that every rank's loss
  reads, so each rank's gradient of it is the sum of all ranks'.
  ``reduce_from``'s identity backward is right only where the value is
  replicated downstream under tp.

``group`` is a process group, or None for an axis of one rank; then each
function is the identity, so the same code runs on one device with no
process group at all. Every rank of a group must call the same
collectives in the same order, forward and backward: the callers keep
their graphs rank-independent in structure (values may differ).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor-in, tensor-out gather and scatter and
# deprecated the old names; the card's torch has only the old ones
_gather_single = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)
_scatter_single = getattr(dist, "reduce_scatter_single", None) or (
    dist.reduce_scatter_tensor)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for w in works:
        w.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _PPermute.apply(x, group, shift)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()          # empty_like would copy a view's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x: [n, ...] with n the group's size; chunk j goes to rank j and
    the result's chunk i came from rank i."""
    if group_size(group) == 1:
        return x
    if x.shape[0] != group_size(group):
        raise ValueError(f"all_to_all: dim 0 is {x.shape[0]}, the group "
                         f"has {group_size(group)} ranks")
    return _AllToAll.apply(x, group)


def _stacked(shard: torch.Tensor, n: int) -> torch.Tensor:
    """The gather's buffer: the n shards one after another along dim 0
    (the layout both backends fill)."""
    return shard.new_empty((n * shard.shape[0], *shard.shape[1:]))


def _concat(stacked: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """The n shards of ``stacked`` concatenated along ``dim`` instead."""
    parts = stacked.unflatten(0, (n, stacked.shape[0] // n))
    return parts.movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    parts = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
    out = parts.new_empty(parts.shape[1:])
    _scatter_single(out, parts.flatten(0, 1).contiguous(), group=group)
    return out


class _Gathered(torch.autograd.Function):
    """The result of a gather already issued: forward waits for it,
    backward reduce-scatters the gradient into the shard's."""

    @staticmethod
    def forward(ctx, shard, handle):
        ctx.group, ctx.dim = handle.group, handle.dim
        handle.work.wait()
        return _concat(handle.out, group_size(handle.group), handle.dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None


class GatherHandle:
    """An all-gather in flight; ``wait()`` returns its differentiable
    result."""

    def __init__(self, shard: torch.Tensor, group, dim: int):
        self.shard, self.group, self.dim = shard, group, dim
        self.out = _stacked(shard, group_size(group))
        self.work = _gather_single(self.out, shard.detach().contiguous(),
                                   group=group, async_op=True)

    def wait(self) -> torch.Tensor:
        return _Gathered.apply(self.shard, self)


class _Ready:
    def __init__(self, x: torch.Tensor):
        self.x = x

    def wait(self) -> torch.Tensor:
        return self.x


def gather_start(shard: torch.Tensor, group, dim: int = 0):
    """Issue the tiled gather of ``shard`` along ``dim`` without waiting."""
    if group_size(group) == 1:
        return _Ready(shard)
    return GatherHandle(shard, group, dim)


def all_gather(shard: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The shards of ``group`` concatenated along ``dim`` in rank order."""
    return gather_start(shard, group, dim).wait()


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        handle = GatherHandle(shard, group, dim)
        handle.work.wait()
        return _concat(handle.out, group_size(group), dim)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        return g.chunk(n, ctx.dim)[group_rank(ctx.group)].contiguous(), \
            None, None


def gather_alike(shard: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The shards of ``group`` concatenated along ``dim``, for ranks that
    all compute the same function of the whole: the gradient comes back
    as this rank's block of the (equal) whole gradient, not summed."""
    if group_size(group) == 1:
        return shard
    return _GatherAlike.apply(shard, group, dim)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Psum.apply(x, group)


def psum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``psum`` over several groups (over their product)."""
    for g in groups:
        x = psum(x, g)
    return x


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group``, outside the graph."""
    out = x.detach().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``reduce_from`` over several groups (a psum over their product)."""
    for g in groups:
        x = reduce_from(x, g)
    return x


def grads_summed_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``copy_to`` over several groups: a replicated value whose
    gradient is summed over their product."""
    for g in groups:
        x = copy_to(x, g)
    return x
