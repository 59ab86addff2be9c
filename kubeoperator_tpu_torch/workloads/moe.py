"""Mixture-of-Experts FFN, the counterpart of
``kubeoperator_tpu/workloads/moe.py::MoEMlp``, on one device or under a
mesh.

The GShard dense-dispatch formulation, as the reference computes it: the
router's top-k choices become dense one-hot dispatch/combine tensors with a
fixed per-expert capacity, so every shape is static and every product is
an einsum (``torch.einsum``, with the reference's strings and cast points;
the reference runs them as XLA einsums, outside any Pallas kernel).

Cast points: the router runs in f32 on the *uncast* input (the LM's
RMSNorm output, f32 when the model dtype is bf16), the experts on the
input cast to the model dtype, expert weights are f32 masters cast at
use, ``combine`` is f32 until the last einsum, and ``y`` comes back in the
model dtype.

The load-balancing aux loss (Shazeer et al.), ``aux_weight · E ·
Σ_e(frac_e · mass_e)`` with ``frac_e`` from the top-1 one-hot, is returned
beside ``y``: the flax module sows it into ``intermediates``, the port
carries no value in module state.

Under a mesh (``MoEMlp(..., mesh=mesh)``, placed by
``sharding.parallelize``), as the reference's placement computes it
(``logical_axis_rules``: expert weights [E, D, F] with E over ep, D over
fsdp and F over tp; the router [D, E] with D over fsdp and E over ep):

* The batch is split over dp and fsdp only, so the ranks of an ep group
  hold the same tokens. Routing is whole on every rank: the router's ep
  shards are gathered at use (``gather_alike``: the ep ranks' gradients
  of it are equal, so none is summed) and so are its fsdp shards (the
  parameter's ``FsdpGather``). Capacity is per row, so splitting the
  batch leaves it unchanged.
* Each ep rank runs its E/ep experts on the rows of the dispatch it owns,
  and the combine, a contraction over E, is a sum over ep: Megatron's
  f/g pair over the ep group (``copy_to`` on the experts' input and on
  the combine weights, ``reduce_from`` on the output). No all-to-all:
  the tokens never move.
* Inside an expert the SwiGLU is split over tp as the dense ``Mlp`` is:
  gate/up by column, down by row, one all-reduce of its output.
* Under sp the sequence is split, so a token's queue position needs the
  counts of the sp ranks before it: each top-k slot's per-row counts are
  gathered over sp (``_slot_counts``), giving the exclusive prefix and the
  total; the capacity is that of the whole sequence.
* The aux loss is the global batch's: ``token_frac`` and ``prob_mass``
  are sums all-reduced over dp, fsdp and sp (``psum``, whose backward is
  a psum) before the product. Every rank then holds the global aux; the
  trainer adds its share of it to each rank's loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads.sharding import (
    axis_group, axis_index, axis_size, data_groups,
)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in f32: an index outside [0, n) gives a
    row of zeros (``F.one_hot`` would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoEMlp(nn.Module):
    """Top-k routed experts, each a SwiGLU of width ``d_ff``: a drop-in
    for the dense ``Mlp`` whose ``forward`` returns ``(y, aux)``. With a
    ``mesh`` the parameters are built whole and ``parallelize`` cuts them;
    ``sp`` says whether the sequence is split over the mesh's sp axis."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 aux_weight: float = 1e-2, mesh=None, sp: bool = False):
        super().__init__()
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.aux_weight = aux_weight
        self.ep, self.tp = axis_group(mesh, "ep"), axis_group(mesh, "tp")
        self.sp = axis_group(mesh, "sp") if sp else None
        ep = axis_size(mesh, "ep")
        if n_experts % ep:
            raise ValueError(f"moe_experts ({n_experts}) must be divisible "
                             f"by ep ({ep}): each ep rank owns "
                             f"moe_experts/ep experts")
        self.local_experts = n_experts // ep
        self.first_expert = axis_index(mesh, "ep") * self.local_experts
        # the groups the global batch is split over: the aux loss's means
        # are sums over them
        self.batch_groups = [g for g in data_groups(mesh) + [self.sp]
                             if g is not None]
        self.router = nn.Parameter(torch.empty(d_model, n_experts))
        self.w_gate = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.w_up = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.w_down = nn.Parameter(torch.empty(n_experts, d_ff, d_model))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax ``lecun_normal`` with its fan rule for any rank: fan_in is
        the input axis times every axis but the last two, so an expert
        stack [E, D, F] has fan_in E·D."""
        # transformer.py imports this module, so its helper is reached here
        from kubeoperator_tpu_torch.workloads.transformer import (
            _lecun_normal_,
        )
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            _lecun_normal_(w, math.prod(w.shape[:-1]), gen)

    def capacity(self, t: int) -> int:
        """Per-expert queue length of one row at ``t`` tokens."""
        return max(1, int(self.capacity_factor * self.top_k * t
                          / self.n_experts))

    def route(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Router and GShard capacity for ``x`` [B, T, D]: returns (probs
        [B, T, E] f32, gate_idx [B, T, K], combine [B, T, E, C] f32,
        dispatch [B, T, E, C] in the model dtype).

        Cumulative priority: a token's place in its expert's queue counts
        every assignment of the earlier top-k slots too (``counts``, per
        row), so two tokens reaching one expert through different slots
        never share a capacity slot. Assignments past the capacity are
        dropped."""
        E, K = self.n_experts, self.top_k
        b, t, _ = x.shape
        cap = self.capacity(t * cl.group_size(self.sp))
        logits = torch.matmul(x.float(), self.whole_router())   # [B, T, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)      # [B, T, K]
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        combine = torch.zeros((b, t, E, cap), dtype=torch.float32,
                              device=x.device)
        counts = torch.zeros((b, E), dtype=torch.float32, device=x.device)
        for slot in range(K):
            onehot_e = _one_hot(gate_idx[..., slot], E)         # [B, T, E]
            in_slot = torch.cumsum(onehot_e, dim=1) - onehot_e
            before, total = self._slot_counts(onehot_e.sum(dim=1))
            pos = (in_slot + (counts + before)[:, None, :]).long()
            within = (pos < cap).float()
            combine = combine + (gate_vals[..., slot, None, None]
                                 * (onehot_e * within)[..., None]
                                 * _one_hot(pos, cap))
            counts = counts + total
        return probs, gate_idx, combine, (combine > 0).to(self.dtype)

    def whole_router(self) -> torch.Tensor:
        """The router [D, E] with every expert's column: gathered over ep
        where the placement split it (training), as it is where it stayed
        whole (serving)."""
        router = self.router        # an fsdp parametrization gathers once
        if router.shape[1] == self.n_experts:
            return router
        return cl.gather_alike(router, self.ep, 1)

    def _slot_counts(self, local: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(assignments of one top-k slot on the sp ranks before this one,
        on all of them) per row and expert, from this rank's [B, E]
        counts: zeros and ``local`` when the sequence is whole."""
        if self.sp is None:
            return torch.zeros_like(local), local
        every = cl.all_gather(local.detach()[None], self.sp, 0)
        return (every[:cl.group_rank(self.sp)].sum(0), every.sum(0))

    def experts(self, x: torch.Tensor, combine: torch.Tensor,
                dispatch: torch.Tensor) -> torch.Tensor:
        """Regroup tokens by expert, run each expert's SwiGLU, combine
        back to token order; ``y`` [B, T, D] in the model dtype. Under ep
        this rank's experts take their columns of ``dispatch`` and
        ``combine`` and the output is summed over ep; under tp each
        expert's SwiGLU is split on F and its output summed over tp."""
        dt = self.dtype
        x = cl.copy_to(cl.copy_to(x.to(dt), self.ep), self.tp)
        if self.ep is not None:
            mine = slice(self.first_expert,
                         self.first_expert + self.local_experts)
            dispatch = dispatch[:, :, mine]
            combine = cl.copy_to(combine, self.ep)[:, :, mine]
        expert_in = torch.einsum("btec,btd->ebcd", dispatch, x)
        h = (F.silu(torch.einsum("ebcd,edf->ebcf", expert_in,
                                 self.w_gate.to(dt)))
             * torch.einsum("ebcd,edf->ebcf", expert_in, self.w_up.to(dt)))
        out_e = cl.reduce_from(
            torch.einsum("ebcf,efd->ebcd", h, self.w_down.to(dt)), self.tp)
        y = torch.einsum("btec,ebcd->btd", combine.to(dt), out_e)
        return cl.reduce_from(y, self.ep).to(dt)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(y, aux)``: the FFN output and the layer's aux loss (0-d f32)."""
        probs, gate_idx, combine, dispatch = self.route(x)
        top1 = _one_hot(gate_idx[..., 0], self.n_experts)
        if self.batch_groups:
            # means over the global batch: sums over the ranks that split
            # it, divided by its token count
            n = probs.shape[0] * probs.shape[1]
            for g in self.batch_groups:
                n *= cl.group_size(g)
            token_frac = cl.sum_over(top1.sum((0, 1)), self.batch_groups) / n
            prob_mass = cl.psum_over(probs.sum((0, 1)), self.batch_groups) / n
        else:
            token_frac, prob_mass = top1.mean((0, 1)), probs.mean((0, 1))
        aux = self.aux_weight * self.n_experts * torch.sum(token_frac
                                                           * prob_mass)
        return self.experts(x, combine, dispatch), aux

    def serve(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The decode form: ``(y, load)``, where load [E] f32 counts the
        tokens each expert was dispatched (``dispatch.sum((0, 1, 3))``)."""
        _, _, combine, dispatch = self.route(x)
        load = dispatch.float().sum((0, 1, 3))
        return self.experts(x, combine, dispatch), load
