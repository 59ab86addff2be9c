"""Dense attention, the counterpart of
``kubeoperator_tpu/workloads/ring_attention.py::reference_attention``.

Only the single-device function is ported in this slice: ring, blockwise
and Ulysses attention wait for the multi-device slice (ROADMAP queue 1).
"""

from __future__ import annotations

import torch


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
