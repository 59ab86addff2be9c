"""Decoder-only transformer LM, the counterpart of
``kubeoperator_tpu/workloads/transformer.py``.

Parameters keep the JAX package's layouts (q/k/v ``[d, H, Dh]``, fused qkv
``[d, 3, H, Dh]``, o ``[H, Dh, d]``, gate/up ``[d, f]``, down ``[f, d]``,
tied embedding ``[V, d]``) and stay f32 masters, so ``bridge.py`` is a copy
and every projection is one matmul on a reshaped weight. Activations run in
``cfg.dtype`` with the same cast points as the flax modules: RMSNorm
returns f32 (its f32 scale promotes), each dense layer casts operand and
weight to ``cfg.dtype``, rope works in f32 and casts back, softmax is f32.

Layers are an ``nn.ModuleList`` (the port has no ``nn.scan``); ``remat``
wraps each block in ``torch.utils.checkpoint`` with the selective policy
that ``remat_policy`` names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from kubeoperator_tpu_torch.workloads import ring_attention as ra
from kubeoperator_tpu_torch.workloads.flash_attention import (
    DEFAULT_BLOCK, FLASH_OP, FLASH_PACKED_OP, flash_attention,
)


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1376            # ~8/3 · d_model, multiple of 32
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    ring: bool = False          # sequence sharding: multi-device slice
    sp_attention: str = "ring"
    moe_experts: int = 0        # >0: MoE slice, not ported yet
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    decode: bool = False        # KV-cached decode (generate.py)
    causal: bool = True
    attention: str = "auto"     # auto | flash | dense — auto takes the
                                # flash kernels on CUDA at seq >= 2048
    logits_bf16: bool = False   # logits from bf16 operands, f32 output
    remat_policy: str = "dots"  # dots | dots+attn | attn | all
    fused_qkv: bool = False
    flash_block: int = 0        # 0 = auto; sets the padded length only
    flash_layout: str = "bh"    # bh (K1-K3) | packed (K4-K6, the ViT's)
    scan_layers: bool = True    # layout of the JAX param tree; the port
                                # always holds one module per layer

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings, interleaved pairs (x[..., ::2], x[..., 1::2]).
    x: [B, T, H, D], positions: [T] global indices. f32 inside."""
    d = x.shape[-1]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    angles = positions.to(x.device)[:, None].float() * freqs[None, :]
    cos = torch.cos(angles)[None, :, None]
    sin = torch.sin(angles)[None, :, None]
    x1, x2 = x[..., ::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """(x · rsqrt(mean(x²) + eps)) cast to x's dtype, times the f32 scale:
    the result is f32 when x is bf16, as in the flax RMSNorm."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def dense(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype,
          n_in: int = 1) -> torch.Tensor:
    """flax Dense/DenseGeneral without bias: contract the last ``n_in`` axes
    of x with the first ``n_in`` axes of w, operands cast to ``dt``."""
    lead = x.shape[:x.dim() - n_in]
    k = math.prod(w.shape[:n_in])
    out = torch.matmul(x.to(dt).reshape(-1, k), w.to(dt).reshape(k, -1))
    return out.reshape(*lead, *w.shape[n_in:])


class _MatmulF32Out(torch.autograd.Function):
    """a · bᵀ from low-precision operands with an f32 result, as an einsum
    with ``preferred_element_type=f32``. On the card cuBLAS accumulates in
    f32 and writes f32 (``out_dtype``); on the CPU the operands are widened
    (their products are exact in f32)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b.t(), out_dtype=torch.float32)
        return a.float() @ b.float().t()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if a.is_cuda:
            g = g.to(a.dtype)
            return g @ b, g.t() @ a
        return (g @ b.float()).to(a.dtype), (g.t() @ a.float()).to(b.dtype)


def tied_logits(cfg: TransformerConfig, x: torch.Tensor,
                emb: torch.Tensor) -> torch.Tensor:
    """Logits against the tied embedding: bf16 operands with f32 output
    under ``logits_bf16``, else all f32."""
    if cfg.logits_bf16 and cfg.dtype != torch.float32:
        lead = x.shape[:-1]
        out = _MatmulF32Out.apply(x.to(cfg.dtype).reshape(-1, x.shape[-1]),
                                  emb.to(cfg.dtype))
        return out.reshape(*lead, emb.shape[0])
    return torch.matmul(x.float(), emb.float().t())


# the attention output of the dense path, tagged so remat policies naming
# "attn" can save it (the flash path saves the flash op's output instead)
@torch.library.custom_op("kubeoperator_tpu_torch::attn_out", mutates_args=())
def _attn_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_attn_out.register_fake
def _(x):
    return torch.empty_like(x)


_attn_out.register_autograd(lambda ctx, g: g)
ATTN_OUT_OP = torch.ops.kubeoperator_tpu_torch.attn_out.default


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: truncated normal at ±2σ, σ = √(1/fan_in)
    divided by the truncation's std correction."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def reset_parameters(self, gen=None):
        nn.init.ones_(self.scale)

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        if cfg.fused_qkv:
            self.qkv = nn.Parameter(torch.empty(d, 3, h, hd))
        else:
            self.q = nn.Parameter(torch.empty(d, h, hd))
            self.k = nn.Parameter(torch.empty(d, h, hd))
            self.v = nn.Parameter(torch.empty(d, h, hd))
        self.o = nn.Parameter(torch.empty(h, hd, d))

    def reset_parameters(self, gen):
        d = self.cfg.d_model
        for name in ("qkv", "q", "k", "v"):
            if hasattr(self, name):
                _lecun_normal_(getattr(self, name), d, gen)
        _lecun_normal_(self.o, self.o.shape[0] * self.o.shape[1], gen)

    def flash_block(self, seq_len: int, on_cuda: bool) -> int | None:
        """Flash block for this sequence, or None for the dense path.
        ``auto`` takes flash on CUDA from seq 2048 up (the counterpart of
        the JAX package's TPU-only test)."""
        cfg = self.cfg
        block = cfg.flash_block or next(
            (b for b in (DEFAULT_BLOCK, 128)
             if seq_len >= b and seq_len % b == 0), 128)
        if cfg.attention == "flash":
            return block
        if cfg.attention == "auto" and on_cuda and seq_len >= 2048:
            return block
        return None

    def forward(self, x, positions, cache=None):
        cfg = self.cfg
        q, k, v = token_qkv(self, x, cfg.dtype)
        q, k = rope(q, positions), rope(k, positions)
        if cache is not None:
            out = decode_attention(q, k, v, cache, positions, cfg.dtype)
        elif (blk := self.flash_block(q.shape[1], q.is_cuda)) is not None:
            out = flash_attention(q, k, v, causal=cfg.causal, block=blk,
                                  layout=cfg.flash_layout)
        else:
            out = ATTN_OUT_OP(ra.reference_attention(q, k, v,
                                                     causal=cfg.causal))
        return dense(out, self.o, cfg.dtype, n_in=2)


def token_qkv(a: Attention, h: torch.Tensor, dt: torch.dtype) -> tuple:
    """q/k/v projections of one layer's attention, fused or split; shared
    by the forward and the decode loop (generate.py)."""
    if a.cfg.fused_qkv:
        qkv = dense(h, a.qkv, dt)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return dense(h, a.q, dt), dense(h, a.k, dt), dense(h, a.v, dt)


def decode_attention(q, k, v, cache, positions, dt):
    """The KV-cache branch (transformer.py decode=True): write this chunk's
    k/v into the [B, S, H, D] cache at positions[0] — in place, where the
    JAX module returned an updated buffer — and attend each query to cache
    slots <= its position, masked with -1e30, softmax in f32."""
    ck, cv = cache
    idx = int(positions[0])
    ck[:, idx:idx + k.shape[1]] = k.to(dt)
    cv[:, idx:idx + v.shape[1]] = v.to(dt)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    slots = torch.arange(ck.shape[1], device=q.device)
    mask = slots[None, None, None, :] <= positions.to(q.device)[None, None, :, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), cv)


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff))
        self.up = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff))
        self.down = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model))

    def reset_parameters(self, gen):
        _lecun_normal_(self.gate, self.cfg.d_model, gen)
        _lecun_normal_(self.up, self.cfg.d_model, gen)
        _lecun_normal_(self.down, self.cfg.d_ff, gen)

    def forward(self, x):
        dt = self.cfg.dtype
        return dense(F.silu(dense(x, self.gate, dt)) * dense(x, self.up, dt),
                     self.down, dt)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model)
        self.attn = Attention(cfg)
        self.ln2 = RMSNorm(cfg.d_model)
        self.mlp = Mlp(cfg)

    def forward(self, x, positions, cache=None):
        x = x + self.attn(self.ln1(x), positions, cache)
        return x + self.mlp(self.ln2(x))


# ops whose outputs each remat policy saves; the rest is recomputed in the
# backward. "dots" is jax's checkpoint_dots_with_no_batch_dims: the
# projection matmuls are aten.mm, attention's batched products are not.
_DOTS = (torch.ops.aten.mm.default,)
_ATTN = (FLASH_OP, FLASH_PACKED_OP, ATTN_OUT_OP)
REMAT_SAVES = {"dots": _DOTS, "dots+attn": _DOTS + _ATTN, "attn": _ATTN,
               "all": ()}


def _policy(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context_fn(policy: str):
    if policy not in REMAT_SAVES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    saved = REMAT_SAVES[policy]
    return partial(create_selective_checkpoint_contexts,
                   partial(_policy, saved))


def run_blocks(layers: nn.ModuleList, x: torch.Tensor,
               positions: torch.Tensor, remat: bool, context_fn,
               caches: list | None = None) -> torch.Tensor:
    """The layer loop shared by the LM and the ViT encoder: each block
    with its decode cache, under selective checkpointing (``context_fn``
    from ``remat_context_fn``), or plain."""
    for i, blk in enumerate(layers):
        if caches is not None:
            x = blk(x, positions, caches[i])
        elif remat:
            x = checkpoint(blk, x, positions, use_reentrant=False,
                           context_fn=context_fn)
        else:
            x = blk(x, positions)
    return x


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError("MoE FFNs are not ported yet "
                                      "(ROADMAP queue 1, MoE slice)")
        if cfg.ring:
            raise NotImplementedError("sequence-sharded attention is not "
                                      "ported yet (ROADMAP queue 1, "
                                      "multi-device)")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model)
        self._remat_ctx = remat_context_fn(cfg.remat_policy)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "Transformer":
        """Seeded init with flax's initializers (normal(0.02) embedding,
        lecun_normal kernels, unit norms). Draws differ from JAX's."""
        gen = torch.Generator(device=self.embedding.device).manual_seed(seed)
        nn.init.normal_(self.embedding, 0.0, 0.02, generator=gen)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        return self

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None,
                caches: list | None = None) -> torch.Tensor:
        """tokens: [B, T] integer; positions: [T] global indices (default
        0..T-1); caches: per-layer (k, v) [B, S, H, D] buffers for the
        decode branch, updated in place. Returns f32 logits [B, T, V]."""
        cfg = self.cfg
        if cfg.decode and caches is None:
            raise ValueError("decode=True needs per-layer caches")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = F.embedding(tokens, self.embedding).to(cfg.dtype)
        remat = cfg.remat and caches is None and torch.is_grad_enabled()
        x = run_blocks(self.layers, x, positions, remat, self._remat_ctx,
                       caches)
        return tied_logits(cfg, self.ln_f(x), self.embedding)


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """Forward FLOPs/token: matmul term + attention term (dense FFN)."""
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    ffn = 2 * 3 * d * f
    per_layer = 2 * 4 * d * d + ffn
    attn = 2 * 2 * seq_len * d
    embed = 2 * d * cfg.vocab_size
    return l * (per_layer + attn) + embed
