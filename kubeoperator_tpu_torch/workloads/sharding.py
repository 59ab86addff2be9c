"""Mesh construction and placement policy, the counterpart of
``kubeoperator_tpu/workloads/sharding.py``.

The JAX package annotates arrays with ``NamedSharding``s and lets GSPMD
derive every collective. PyTorch derives none, so the port's meshes are
``torch.distributed`` process groups (one process per device, under
``torchrun`` or ``torch.multiprocessing``), placements are tuples of mesh
axis names per dimension (``PartitionSpec``'s shape), and each collective
that carries a gradient is written out (``collectives.py``). The axes and
their order are the reference's: dp, fsdp, pp, ep, tp, sp, outer to
inner, and only those above 1 are in the mesh.

* ``dp``   — data parallel: gradients summed over it after the backward.
* ``fsdp`` — ZeRO-3: each parameter's ``embed`` dimension is split over
             it and gathered at use; the gather's backward reduce-scatters
             the gradient.
* ``tp``   — Megatron: heads, MLP and vocab split over it
             (``logical_axis_rules``), one all-reduce after each
             row-parallel product.
* ``sp``   — the sequence split over it: ring or Ulysses attention.
* ``pp``   — pipeline stages (``pipeline.py``).
* ``ep``   — experts: each rank keeps E/ep of every MoE layer's experts.
             The batch is not split over ep, so the ranks of an ep group
             route the same tokens, each runs its own experts, and the
             combine is a sum over ep (``moe.py``).

``parallelize`` places a model built and loaded whole on every rank:
it keeps each rank's tp and ep shard of every parameter and replaces
fsdp-split parameters by their shard, gathered on access through a
parametrization.
A parameter's placement comes from its logical names (the LM, the ViT) or
from its shape (``place_by_shape``, the ResNet's rule).
Across slices (``slices=``, one id a rank: the nodes of a ``torchrun``
job by default, or ``with_virtual_slices``) only the outermost data axis
spans them (``mesh_ranks``), as in the reference's multi-slice meshes.
``set_data_groups`` hands the data groups to the BatchNorm modules, whose
statistics cover the global batch. ``place_decode`` cuts a whole model
for the serving mesh (dp × tp × ep) by ``decode_axis_rules``.
The ZeRO-3 step with explicit gather/compute overlap
(``fsdp_overlapped_loss_fn``) follows at the end.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize
from torch.utils.checkpoint import checkpoint

from kubeoperator_tpu_torch.workloads import collectives as cl

AXES = ("dp", "fsdp", "pp", "ep", "tp", "sp")


@dataclass(frozen=True)
class MeshSpec:
    """Parallelism degrees. Their product must equal the world size."""
    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, s in self.sizes() if s > 1) or ("dp",)

    def sizes(self) -> tuple[tuple[str, int], ...]:
        return (("dp", self.dp), ("fsdp", self.fsdp), ("pp", self.pp),
                ("ep", self.ep), ("tp", self.tp), ("sp", self.sp))

    @property
    def n_devices(self) -> int:
        return self.dp * self.fsdp * self.pp * self.ep * self.tp * self.sp

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Mesh axes the global batch is split over."""
        return tuple(n for n in ("dp", "fsdp")
                     if dict(self.sizes())[n] > 1) or ("dp",)

    @staticmethod
    def for_devices(n: int, *, model_parallel: int = 1,
                    sequence_parallel: int = 1, expert_parallel: int = 1,
                    zero3: bool = True) -> "MeshSpec":
        """Fill the data axes with whatever devices remain after model
        axes."""
        model = model_parallel * sequence_parallel * expert_parallel
        if n % model:
            raise ValueError(f"{n} devices not divisible by tp="
                             f"{model_parallel} × sp={sequence_parallel} × "
                             f"ep={expert_parallel}")
        data = n // model
        return MeshSpec(dp=1 if zero3 else data, fsdp=data if zero3 else 1,
                        ep=expert_parallel, tp=model_parallel,
                        sp=sequence_parallel)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def with_virtual_slices(world: int, n_slices: int) -> list[int]:
    """The slice of each of ``world`` ranks when they are split into
    ``n_slices`` contiguous synthetic slices (the reference's
    ``with_virtual_slices`` over devices): what ``build_mesh(...,
    slices=)`` takes, so a multi-slice layout runs on hosts with one."""
    if world % n_slices:
        raise ValueError(f"{world} devices do not split into "
                         f"{n_slices} equal slices")
    per = world // n_slices
    return [r // per for r in range(world)]


def node_slices() -> list[int]:
    """Each rank's slice when none is given: its node. Under ``torchrun``
    a node's ranks share NVLink and nodes talk over the network, the part
    of a TPU pod that DCN separates, so each rank's ``GROUP_RANK`` is
    gathered over the world. Outside ``torchrun``, or when one node holds
    the whole world, every rank is in slice 0 and nothing is gathered."""
    world = world_size()
    if (world == 1 or "GROUP_RANK" not in os.environ
            or int(os.environ.get("LOCAL_WORLD_SIZE", world)) == world):
        return [0] * world
    out: list = [None] * world
    dist.all_gather_object(out, int(os.environ["GROUP_RANK"]))
    return [int(s) for s in out]


def mesh_ranks(spec: MeshSpec, slices: Sequence[int]) -> np.ndarray:
    """The rank at each coordinate of the spec's mesh (axes above 1, outer
    to inner; [1] for a single device) over ranks whose slices are
    ``slices[rank]``. Several slices are the reference's multi-slice
    mesh: only the outermost axis may span them, it must be a data axis
    (dp, or fsdp when dp is 1) and a multiple of the slice count, so each
    of its rows holds ranks of one slice and the model axes stay inside
    one. Raises, with the reference's messages, for a layout that would
    put model axes across slices.

    Each slice's ranks, ascending, fill its rows of the outermost axis,
    row-major; the rows come in the order of their lowest rank. Where the
    slice ids ascend with the ranks, as ``with_virtual_slices`` and
    ``torchrun``'s nodes give them, that is the reference's slice-major
    layout. A process group numbers its ranks in rank order
    (``torch.distributed.new_group`` sorts them) and an axis's index is a
    rank's place in its group, so the ranks must ascend along every axis:
    slices whose ranks interleave so that no order of the rows ascends
    raise."""
    if spec.n_devices != len(slices):
        raise ValueError(f"MeshSpec wants {spec.n_devices} devices, got "
                         f"{len(slices)}")
    names = [n for n, s in spec.sizes() if s > 1] or ["dp"]
    shape = [s for _, s in spec.sizes() if s > 1] or [1]
    members: dict[int, list[int]] = {}
    for rank, s in enumerate(slices):
        members.setdefault(s, []).append(rank)
    if len(members) > 1:
        if names[0] not in ("dp", "fsdp"):
            raise ValueError(
                f"multi-slice mesh: outermost axis is {names[0]!r} but only "
                "a data axis (dp/fsdp) may span slices — model-parallel "
                "collectives must stay on ICI")
        if shape[0] % len(members):
            raise ValueError(
                f"multi-slice mesh: outermost axis {names[0]}={shape[0]} "
                f"must be a multiple of the slice count {len(members)}")
        if len({len(m) for m in members.values()}) > 1:
            raise ValueError(
                f"multi-slice mesh: slices of "
                f"{sorted(len(m) for m in members.values())} ranks; each "
                f"must hold as many")
    row = len(slices) // shape[0]
    rows = sorted((m[i:i + row] for m in members.values()
                   for i in range(0, len(m), row)), key=lambda r: r[0])
    ranks = np.asarray(rows).reshape(shape)
    for axis in range(ranks.ndim):
        if not (np.diff(ranks, axis=axis) > 0).all():
            raise ValueError(
                f"multi-slice mesh: slices {list(slices)} interleave their "
                f"ranks, so {names[axis]}'s ranks cannot ascend along it "
                f"as its process groups number them (in rank order)")
    return ranks


def build_mesh(spec: MeshSpec, device_type: str | None = None,
               slices: Sequence[int] | None = None):
    """A ``DeviceMesh`` over the world with the spec's axes above 1, outer
    to inner (dp, fsdp, pp, ep, tp, sp; ("dp",) of 1 for a single device),
    its ranks placed by ``mesh_ranks`` over ``slices`` (one slice per
    rank; default ``node_slices()``). Raises when the spec's device count
    is not the world size, or for a multi-slice layout the reference
    refuses, before any process group is made. In a process with no
    process group the world is one device and the mesh is None: every
    axis then has one rank and every collective is the identity."""
    world = world_size()
    if spec.n_devices != world:
        raise ValueError(f"MeshSpec wants {spec.n_devices} devices, got "
                         f"{world}")
    if slices is not None and len(slices) != world:
        raise ValueError(f"{len(slices)} slice ids for a world of {world}")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh_ranks(spec, node_slices() if slices is None else slices)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.as_tensor(ranks),
                      mesh_dim_names=spec.axis_names)


def _has(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis)) if _has(mesh, axis) else 1


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if _has(mesh, axis) else 0


def axis_group(mesh, axis: str):
    """The process group of ``axis``, None when it has one rank."""
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def data_groups(mesh) -> list:
    return [g for g in (axis_group(mesh, "dp"), axis_group(mesh, "fsdp"))
            if g is not None]


def logical_axis_rules(spec: MeshSpec) -> tuple[tuple[str, Any], ...]:
    """Logical names → mesh axes, the reference's table; a rule maps to
    None (replicate) when its mesh axis is size 1, so the same model code
    runs at any scale."""
    has = {n for n, s in spec.sizes() if s > 1}
    pick = lambda a: a if a in has else None  # noqa: E731
    return (
        ("batch", tuple(a for a in ("dp", "fsdp") if a in has) or None),
        ("embed", pick("fsdp")),       # ZeRO-3: shard params along fsdp
        ("mlp", pick("tp")),           # megatron column/row split
        ("heads", pick("tp")),
        ("qkv_stack", None),           # fused-QKV leading 3
        ("kv", None),
        ("seq", pick("sp")),           # ring-attention sequence shards
        ("vocab", pick("tp")),
        ("expert", pick("ep")),        # MoE experts shard over ep
    )


def decode_axis_rules(spec: MeshSpec) -> tuple[tuple[str, Any], ...]:
    """The serving placement (the reference's ``shard_params_decode_tp``):
    heads and the MLP's d_ff over tp, experts over ep (their d_ff over tp
    too); the router, the norms and the tied embedding stay whole, so
    routing and the vocabulary matmul, and with them sampling, do not
    depend on the layout."""
    has = {n for n, s in spec.sizes() if s > 1}
    pick = lambda a: a if a in has else None  # noqa: E731
    return (("mlp", pick("tp")), ("heads", pick("tp")),
            ("expert", pick("ep")))


def placement(logical: Sequence[str], spec: MeshSpec,
              rules: Sequence | None = None) -> tuple:
    """The mesh axis (or None) of each dimension named ``logical`` under
    ``rules`` (default ``logical_axis_rules``)."""
    rules = dict(rules if rules is not None else logical_axis_rules(spec))
    return tuple(rules.get(name) for name in logical)


def batch_index(mesh) -> tuple[int, int]:
    """(this rank's block, number of blocks) of the global batch's rows:
    split over dp then fsdp, dp outer, as ``batch_sharding`` splits them."""
    dp, fsdp = axis_size(mesh, "dp"), axis_size(mesh, "fsdp")
    return axis_index(mesh, "dp") * fsdp + axis_index(mesh, "fsdp"), dp * fsdp


def local_block(x: torch.Tensor, index: int, count: int, dim: int = 0):
    """Block ``index`` of ``count`` equal blocks of ``x`` along ``dim``."""
    if x.shape[dim] % count:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"into {count} equal blocks")
    return x.chunk(count, dim)[index]


def shard_batch(mesh, x: torch.Tensor, seq_dim: int | None = None):
    """This rank's part of a global batch: rows over dp×fsdp and, with
    ``seq_dim``, the sequence over sp."""
    x = local_block(x, *batch_index(mesh))
    if seq_dim is not None:
        x = local_block(x, axis_index(mesh, "sp"), axis_size(mesh, "sp"),
                        seq_dim)
    return x


def place_by_shape(x: Any, spec: MeshSpec, min_size: int = 2 ** 14) -> tuple:
    """ZeRO-3 placement rule for one array (a tensor, or its shape): split
    the largest fsdp-divisible dim of big arrays over fsdp, replicate
    everything else (``()``). Ties go to the last dim."""
    if spec.fsdp <= 1:
        return ()
    shape = tuple(getattr(x, "shape", x) or ())
    if not shape or math.prod(shape) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % spec.fsdp == 0 and (best is None or d >= shape[best]):
            best = i
    if best is None:
        return ()
    return tuple("fsdp" if i == best else None for i in range(len(shape)))


def shard_params_fsdp(params: dict, spec: MeshSpec,
                      min_size: int = 2 ** 14) -> dict:
    """``place_by_shape`` over a flat {name: tensor} dict."""
    return {k: place_by_shape(v, spec, min_size) for k, v in params.items()}


def shard_tensor(x: torch.Tensor, spec_dims: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor under a placement."""
    for dim, axis in enumerate(spec_dims):
        if axis is not None:
            x = local_block(x, axis_index(mesh, axis), axis_size(mesh, axis),
                            dim)
    return x.contiguous()


def unshard_tensor(x: torch.Tensor, spec_dims: tuple, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block (a collective over the
    placement's axes; outside the graph)."""
    x = x.detach()
    for dim, axis in reversed(list(enumerate(spec_dims))):
        if axis is not None:
            x = cl.all_gather(x, axis_group(mesh, axis), dim)
    return x


class FsdpGather(nn.Module):
    """Parametrization of an fsdp-split parameter: the module holds this
    rank's shard and sees the whole (tp-local) tensor, gathered on each
    access; the gather's backward reduce-scatters the gradient."""

    def __init__(self, group, dim: int):
        super().__init__()
        self.group, self.dim = group, dim

    def forward(self, shard):
        # contiguous: a kernel takes the gathered weight as it is (K7, K8)
        return cl.all_gather(shard, self.group, self.dim).contiguous()

    def right_inverse(self, whole):
        return local_block(whole, cl.group_rank(self.group),
                           cl.group_size(self.group), self.dim).clone()


def parallelize(model: nn.Module, mesh, spec: MeshSpec,
                axes_of: Callable[[str], Sequence[str]] | None = None,
                rules: Sequence | None = None) -> dict:
    """Place a model that every rank built and loaded whole: each
    parameter ``name`` has the logical names ``axes_of(name)`` or, with no
    ``axes_of``, the placement ``place_by_shape`` gives its shape; a dim
    ruled to tp keeps this rank's block, a dim ruled to fsdp becomes an
    ``FsdpGather`` parametrization over this rank's block. Returns {name:
    placement} for ``unshard_tensor`` and the gradient reduction. The
    modules read their tp, sp and ep groups from the mesh themselves.
    ``rules`` replaces ``logical_axis_rules`` (``decode_axis_rules`` for
    the serving placement)."""
    placements = {}
    fsdp = axis_group(mesh, "fsdp")
    for name, p in list(model.named_parameters()):
        spec_dims = (place_by_shape(p, spec) if axes_of is None
                     else placement(axes_of(name), spec, rules))
        placements[name] = spec_dims
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        kept = tuple(a if a in ("tp", "ep") else None for a in spec_dims)
        if any(kept):
            setattr(module, leaf, nn.Parameter(shard_tensor(
                p.detach(), kept, mesh)))
        if "fsdp" in spec_dims and fsdp is not None:
            parametrize.register_parametrization(
                module, leaf, FsdpGather(fsdp, spec_dims.index("fsdp")),
                unsafe=True)
    return placements


def place_decode(model: nn.Module, cfg, mesh, spec: MeshSpec) -> nn.Module:
    """A serving copy of the whole ``Transformer`` ``model`` (the same on
    every rank) on a dp×tp(×ep) mesh: built with the mesh's tp and ep
    groups and cut by ``decode_axis_rules``, each rank keeping its slices
    (q/k/v and gate/up by column, o and down by row, E/ep experts with
    d_ff/tp each); the embedding stays whole. Its MoE layers compute no
    aux over the batch: the pool's rows are not one batch."""
    from kubeoperator_tpu_torch.workloads.transformer import (
        Transformer, param_axes,
    )

    def axes_of(name: str) -> tuple:
        # the router stays whole: its expert axis is not the experts'
        return (None, None) if name.endswith(".router") else param_axes(name)

    with torch.device(model.embedding.device):
        placed = Transformer(cfg, mesh, vocab_parallel=False)
    placed.load_state_dict(model.state_dict())
    parallelize(placed, mesh, spec, axes_of, decode_axis_rules(spec))
    for m in placed.modules():
        if hasattr(m, "batch_groups"):
            m.batch_groups = []
    return placed.eval()


def set_data_groups(model: nn.Module, mesh) -> None:
    """Hand the data groups (dp, fsdp) to every module with
    ``stat_groups`` (``BatchNorm``, ``FusedConvBN``): their batch
    statistics then cover the global batch."""
    groups = data_groups(mesh)
    for m in model.modules():
        if hasattr(m, "stat_groups"):
            m.stat_groups = groups


def reduce_grads(model: nn.Module, placements: dict, mesh,
                 axes: Sequence[str] = ("dp", "fsdp", "sp")) -> None:
    """Sum every gradient over the ``axes`` that split the work (dp and sp
    for the LM; the ViT's sp ranks compute alike and pass dp and fsdp),
    each where its parameter is replicated: fsdp only where the parameter
    is not split over it (the gather's reduce-scatter summed it then).
    Parameters replicated over tp need no sum: their gradients are equal
    on every tp rank. One flat all-reduce per group and set of
    parameters."""
    buckets: dict[tuple, list] = {}
    params = dict(placed_params(model))
    for name, spec_dims in placements.items():
        axes_here = tuple(a for a in axes
                          if axis_size(mesh, a) > 1 and a not in spec_dims)
        if axes_here:
            buckets.setdefault(axes_here, []).append(params[name])
    for axes, ps in buckets.items():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps]
        flat = torch.cat([g.reshape(-1) for g in grads])
        for a in axes:
            dist.all_reduce(flat, group=axis_group(mesh, a))
        for p, g in zip(ps, flat.split([g.numel() for g in grads])):
            p.grad = g.view_as(p).clone()


def placed_params(model: nn.Module):
    """(name before parametrization, local parameter) pairs."""
    for name, p in model.named_parameters():
        yield name.replace("parametrizations.", "").replace(
            ".original", ""), p


def full_state(model: nn.Module, placements: dict, mesh,
               grads: bool = False) -> dict:
    """{name: whole tensor} of the parameters (or their gradients) on
    every rank, from each rank's shards (a collective; a parameter with no
    placement is whole already)."""
    out = {}
    for name, p in placed_params(model):
        x = p.grad if grads else p
        out[name] = unshard_tensor(x, placements.get(name, ()), mesh)
    return out


# ---------------------------------------------------------------------------
# ZeRO-3 with explicit gather/compute overlap
# ---------------------------------------------------------------------------
#
# Each layer's params live as one flat fsdp-split chunk. With prefetch the
# loop issues the gather of layer i+1's chunk (asynchronously) before layer
# i's compute and joins it after, so on NCCL the two overlap; without it
# each layer gathers in the tick that consumes it. The backward
# reduce-scatters each chunk's gradient as autograd reaches it. Numerics
# equal the eager ZeRO-3 step's.

def pack_stages(stage_params: Sequence[dict], multiple: int = 1
                ) -> tuple[torch.Tensor, Callable[[torch.Tensor], dict]]:
    """Flatten per-stage {name: tensor} dicts (same names and shapes) into
    one ``[S, P]`` tensor plus ``unpack(flat) -> dict``. ``P`` is
    right-padded to a multiple of ``multiple`` (the fsdp size) so the flat
    axis splits evenly. Leaves are raveled in sorted-name order, as
    ``ravel_pytree`` orders a dict."""
    if not stage_params:
        raise ValueError("need at least one stage")
    names = sorted(stage_params[0])
    shapes = [tuple(stage_params[0][k].shape) for k in names]
    sizes = [math.prod(s) for s in shapes]
    n = sum(sizes)
    flats = []
    for p in stage_params:
        if sorted(p) != names or [tuple(p[k].shape) for k in names] != shapes:
            raise ValueError("stages must share parameter shapes")
        flats.append(torch.cat([p[k].reshape(-1) for k in names]))
    pad = (-n) % max(multiple, 1)
    stacked = torch.stack([torch.nn.functional.pad(f, (0, pad))
                           for f in flats])

    def unpack(flat: torch.Tensor) -> dict:
        parts = flat[:n].split(sizes)
        return {k: v.view(s) for k, v, s in zip(names, parts, shapes)}

    return stacked, unpack


def fsdp_overlapped_shardings(mesh) -> dict:
    """Placements of the overlapped step's params: stage chunks split their
    flat axis over fsdp, embed and head replicate."""
    ax = "fsdp" if _has(mesh, "fsdp") else None
    return {"embed": (), "stages": (None, ax), "head": ()}


def fsdp_overlapped_loss_fn(mesh, embed_fn: Callable, stage_fn: Callable,
                            head_fn: Callable, loss_fn: Callable,
                            unpack: Callable[[torch.Tensor], dict],
                            axis: str = "fsdp", remat: bool = True,
                            prefetch: bool = True) -> Callable:
    """``loss(params, x, y) -> scalar`` running the chunked ZeRO-3
    schedule over the mesh's ``axis``: the mean of ``loss_fn`` over the
    global batch, every rank's result the same.

    params = {"embed": replicated, "stages": this rank's ``[S, P/fsdp]``
    block of ``pack_stages``' matrix, "head": replicated}; x/y the global
    batch (each rank takes its rows over dp×fsdp). Its gradients are the
    whole step's: summed over the data axes (embed and head), and over dp
    then reduce-scattered over fsdp (the stage chunks). In a world of one
    device every axis has one rank: the gathers are the chunks themselves
    and the schedule is the layers in order."""
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if axis not in names and world_size() > 1:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {names})")
    extra = set(names) - {"dp", "fsdp"}
    if extra:
        raise ValueError(f"overlapped fsdp supports dp/fsdp meshes only, "
                         f"mesh also has {sorted(extra)}")
    group = axis_group(mesh, axis)
    data = data_groups(mesh)
    dp = [g for g in (axis_group(mesh, "dp"),) if g is not None]
    n_data = batch_index(mesh)[1]

    def stage(p, h):
        if remat:
            return checkpoint(stage_fn, p, h, use_reentrant=False)
        return stage_fn(p, h)

    def loss(params, x, y):
        embed_p = cl.grads_summed_over(params["embed"], data)
        head_p = cl.grads_summed_over(params["head"], data)
        shards = cl.grads_summed_over(params["stages"], dp)
        h = embed_fn(embed_p, shard_batch(mesh, x))
        if prefetch:
            nxt = cl.gather_start(shards[0], group)
            for i in range(shards.shape[0]):
                p_flat = nxt.wait()
                if i + 1 < shards.shape[0]:
                    nxt = cl.gather_start(shards[i + 1], group)  # in flight
                h = stage(unpack(p_flat), h)                      # ...while i
        else:
            for i in range(shards.shape[0]):
                h = stage(unpack(cl.all_gather(shards[i], group)), h)
        local = loss_fn(head_fn(head_p, h), shard_batch(mesh, y)).mean()
        return cl.sum_over(local, data) / n_data

    return loss
