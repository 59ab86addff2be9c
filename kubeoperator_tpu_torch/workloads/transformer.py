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
that ``remat_policy`` names. With ``moe_experts > 0`` each block's FFN is
``moe.MoEMlp``, whose load-balancing aux loss each block returns beside
its output and the model sums over layers (``return_aux``), as the flax
model sows it.

Under a mesh (``Transformer(cfg, mesh)``, placed by
``sharding.parallelize`` with ``param_axes``) the model is Megatron over
tp, the reference's ``logical_axis_rules`` split: each rank holds H/tp
heads, d_ff/tp of the MLP and V/tp rows of the tied embedding, so the
embedding lookup, the attention and MLP outputs and (in the trainer) the
softmax's sums are all-reduced over tp. An MoE FFN keeps E/ep experts a
rank, each split over tp like the dense MLP (``moe.py``). With
``cfg.ring`` and an sp axis
the sequence is split over sp: positions are global and attention is
ring or Ulysses (``sp_attention``), as the reference dispatches it. With
neither axis the flash dispatch is the one-device one.
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

from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads import ring_attention as ra
from kubeoperator_tpu_torch.workloads.flash_attention import (
    DEFAULT_BLOCK, FLASH_OP, FLASH_PACKED_OP, flash_attention,
)
from kubeoperator_tpu_torch.workloads.moe import MoEMlp
from kubeoperator_tpu_torch.workloads.sharding import axis_group


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
    ring: bool = False          # sequence split over the mesh's sp axis
    sp_attention: str = "ring"  # ring (ppermute K/V hops) | ulysses (two
                                # all-to-alls; heads/tp % sp == 0)
    moe_experts: int = 0        # >0: MoEMlp FFNs (moe.py)
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


def _groups(mesh) -> tuple:
    """(tp group, sp group) of a mesh; None for an axis of one rank."""
    return axis_group(mesh, "tp"), axis_group(mesh, "sp")


def flash_block(cfg: TransformerConfig, seq_len: int,
                on_cuda: bool) -> int | None:
    """Flash block for this sequence, or None for the dense path.
    ``auto`` takes flash on CUDA from seq 2048 up (the counterpart of the
    JAX package's TPU-only test)."""
    block = cfg.flash_block or next(
        (b for b in (DEFAULT_BLOCK, 128)
         if seq_len >= b and seq_len % b == 0), 128)
    if cfg.attention == "flash":
        return block
    if cfg.attention == "auto" and on_cuda and seq_len >= 2048:
        return block
    return None


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.tp, self.sp = _groups(mesh)
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
        return flash_block(self.cfg, seq_len, on_cuda)

    def forward(self, x, positions, cache=None):
        cfg = self.cfg
        q, k, v = token_qkv(self, cl.copy_to(x, self.tp), cfg.dtype)
        q, k = rope(q, positions), rope(k, positions)
        if cache is not None:
            out = decode_attention(q, k, v, cache, positions, cfg.dtype)
        elif cfg.ring and self.sp is not None:
            attend = (ra.ulysses_attention if cfg.sp_attention == "ulysses"
                      else ra.ring_attention)
            out = ATTN_OUT_OP(attend(q, k, v, self.sp, causal=cfg.causal))
        elif (blk := self.flash_block(q.shape[1], q.is_cuda)) is not None:
            out = flash_attention(q, k, v, causal=cfg.causal, block=blk,
                                  layout=cfg.flash_layout)
        else:
            out = ATTN_OUT_OP(ra.reference_attention(q, k, v,
                                                     causal=cfg.causal))
        return cl.reduce_from(dense(out, self.o, cfg.dtype, n_in=2), self.tp)


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
    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.tp = _groups(mesh)[0]
        self.gate = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff))
        self.up = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff))
        self.down = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model))

    def reset_parameters(self, gen):
        _lecun_normal_(self.gate, self.cfg.d_model, gen)
        _lecun_normal_(self.up, self.cfg.d_model, gen)
        _lecun_normal_(self.down, self.cfg.d_ff, gen)

    def forward(self, x):
        dt = self.cfg.dtype
        x = cl.copy_to(x, self.tp)
        return cl.reduce_from(
            dense(F.silu(dense(x, self.gate, dt)) * dense(x, self.up, dt),
                  self.down, dt), self.tp)


class Block(nn.Module):
    """One decoder layer: a dense SwiGLU ``mlp``, or with ``moe_experts >
    0`` a routed ``moe`` FFN. ``forward`` returns ``(x, aux)``: the MoE
    layer's aux loss, None for a dense layer."""

    def __init__(self, cfg: TransformerConfig, mesh=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model)
        self.attn = Attention(cfg, mesh)
        self.ln2 = RMSNorm(cfg.d_model)
        if cfg.moe_experts > 0:
            self.moe = MoEMlp(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                              top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              dtype=cfg.dtype, mesh=mesh, sp=cfg.ring)
        else:
            self.mlp = Mlp(cfg, mesh)

    def forward(self, x, positions, cache=None):
        x = x + self.attn(self.ln1(x), positions, cache)
        if hasattr(self, "moe"):
            # flax hands the MoE FFN the uncast RMSNorm output
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        return x + self.mlp(self.ln2(x)), None


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
               caches: list | None = None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer loop shared by the LM and the ViT encoder: each block
    with its decode cache, under selective checkpointing (``context_fn``
    from ``remat_context_fn``), or plain. Returns ``(x, aux)``: the sum of
    the MoE layers' aux losses in layer order, None when no layer has
    one."""
    aux = None
    for i, blk in enumerate(layers):
        if caches is not None:
            x, a = blk(x, positions, caches[i])
        elif remat:
            x, a = checkpoint(blk, x, positions, use_reentrant=False,
                              context_fn=context_fn)
        else:
            x, a = blk(x, positions)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


# logical axis names of each parameter, by its own name: the flax
# model's ``with_logical_partitioning`` annotations
PARAM_AXES = {
    "embedding": ("vocab", "embed"), "scale": ("embed",),
    "qkv": ("embed", "qkv_stack", "heads", "kv"),
    "q": ("embed", "heads", "kv"), "k": ("embed", "heads", "kv"),
    "v": ("embed", "heads", "kv"), "o": ("heads", "kv", "embed"),
    "gate": ("embed", "mlp"), "up": ("embed", "mlp"), "down": ("mlp", "embed"),
    "router": ("embed", "expert"), "w_gate": ("expert", "embed", "mlp"),
    "w_up": ("expert", "embed", "mlp"), "w_down": ("expert", "mlp", "embed"),
}


def param_axes(name: str) -> tuple[str, ...]:
    """Logical axes of the parameter called ``name`` (a dotted path)."""
    return PARAM_AXES[name.rpartition(".")[2]]


def vocab_parallel_embed(tokens: torch.Tensor, emb: torch.Tensor,
                         group) -> torch.Tensor:
    """Rows of the tied embedding for ``tokens`` when each tp rank holds
    V/tp of them in rank order: this rank's rows, zeros elsewhere,
    summed over tp."""
    if group is None:
        return F.embedding(tokens, emb)
    rows = emb.shape[0]
    local = tokens - cl.group_rank(group) * rows
    inside = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), emb)
    return cl.reduce_from(x * inside[..., None], group)


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None,
                 vocab_parallel: bool = True):
        super().__init__()
        self.cfg = cfg
        self.tp, self.sp = _groups(mesh)
        if not vocab_parallel:
            # the embedding stays whole under tp (the serving placement)
            self.tp = None
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.layers = nn.ModuleList(Block(cfg, mesh)
                                    for _ in range(cfg.n_layers))
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
                caches: list | None = None, return_aux: bool = False):
        """tokens: [B, T] integer; positions: [T] global indices (default
        0..T-1); caches: per-layer (k, v) [B, S, H, D] buffers for the
        decode branch, updated in place. Returns f32 logits [B, T, V], or
        with ``return_aux`` the pair (logits, aux): the MoE layers' summed
        aux loss, a 0-d zero for a dense model. Under a mesh, tokens are
        this rank's block, positions default to its global ones and the
        logits are its tp block of the vocabulary."""
        cfg = self.cfg
        if cfg.decode and caches is None:
            raise ValueError("decode=True needs per-layer caches")
        if positions is None:
            t = tokens.shape[1]
            positions = (cl.group_rank(self.sp) * t
                         + torch.arange(t, device=tokens.device))
        emb = self.embedding            # one fsdp gather for both uses
        x = vocab_parallel_embed(tokens, emb, self.tp).to(cfg.dtype)
        remat = cfg.remat and caches is None and torch.is_grad_enabled()
        x, aux = run_blocks(self.layers, x, positions, remat,
                            self._remat_ctx, caches)
        logits = tied_logits(cfg, cl.copy_to(self.ln_f(x), self.tp), emb)
        if not return_aux:
            return logits
        return logits, (aux if aux is not None
                        else torch.zeros((), device=logits.device))


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """Forward FLOPs/token: matmul term + attention term. MoE configs
    count top_k SwiGLUs per token plus the router matmul; as in the
    reference, the dense dispatch and combine einsums are left out."""
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    if cfg.moe_experts > 0:
        ffn = cfg.moe_top_k * (2 * 3 * d * f) + 2 * d * cfg.moe_experts
    else:
        ffn = 2 * 3 * d * f
    per_layer = 2 * 4 * d * d + ffn
    attn = 2 * 2 * seq_len * d
    embed = 2 * d * cfg.vocab_size
    return l * (per_layer + attn) + embed
