"""Mixture-of-Experts FFN, the counterpart of
``kubeoperator_tpu/workloads/moe.py::MoEMlp`` on one device.

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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in f32: an index outside [0, n) gives a
    row of zeros (``F.one_hot`` would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoEMlp(nn.Module):
    """Top-k routed experts, each a SwiGLU of width ``d_ff``: a drop-in
    for the dense ``Mlp`` whose ``forward`` returns ``(y, aux)``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 aux_weight: float = 1e-2):
        super().__init__()
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.aux_weight = aux_weight
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
        cap = self.capacity(t)
        logits = torch.matmul(x.float(), self.router)           # [B, T, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)      # [B, T, K]
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        combine = torch.zeros((b, t, E, cap), dtype=torch.float32,
                              device=x.device)
        counts = torch.zeros((b, E), dtype=torch.float32, device=x.device)
        for slot in range(K):
            onehot_e = _one_hot(gate_idx[..., slot], E)         # [B, T, E]
            in_slot = torch.cumsum(onehot_e, dim=1) - onehot_e
            pos = (in_slot + counts[:, None, :]).long()
            within = (pos < cap).float()
            combine = combine + (gate_vals[..., slot, None, None]
                                 * (onehot_e * within)[..., None]
                                 * _one_hot(pos, cap))
            counts = counts + onehot_e.sum(dim=1)
        return probs, gate_idx, combine, (combine > 0).to(self.dtype)

    def experts(self, x: torch.Tensor, combine: torch.Tensor,
                dispatch: torch.Tensor) -> torch.Tensor:
        """Regroup tokens by expert, run each expert's SwiGLU, combine
        back to token order; ``y`` [B, T, D] in the model dtype."""
        dt = self.dtype
        expert_in = torch.einsum("btec,btd->ebcd", dispatch, x.to(dt))
        h = (F.silu(torch.einsum("ebcd,edf->ebcf", expert_in,
                                 self.w_gate.to(dt)))
             * torch.einsum("ebcd,edf->ebcf", expert_in, self.w_up.to(dt)))
        out_e = torch.einsum("ebcf,efd->ebcd", h, self.w_down.to(dt))
        y = torch.einsum("btec,ebcd->btd", combine.to(dt), out_e)
        return y.to(dt)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(y, aux)``: the FFN output and the layer's aux loss (0-d f32)."""
        probs, gate_idx, combine, dispatch = self.route(x)
        token_frac = _one_hot(gate_idx[..., 0], self.n_experts).mean((0, 1))
        prob_mass = probs.mean((0, 1))
        aux = self.aux_weight * self.n_experts * torch.sum(token_frac
                                                           * prob_mass)
        return self.experts(x, combine, dispatch), aux

    def serve(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The decode form: ``(y, load)``, where load [E] f32 counts the
        tokens each expert was dispatched (``dispatch.sum((0, 1, 3))``)."""
        _, _, combine, dispatch = self.route(x)
        load = dispatch.float().sum((0, 1, 3))
        return self.experts(x, combine, dispatch), load
