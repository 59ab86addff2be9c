"""Autoregressive generation with a KV cache, the counterpart of
``kubeoperator_tpu/workloads/generate.py``.

The prompt's shared prefix (``prefill_len`` tokens) goes through one
chunked forward pass that fills the per-layer [B, max_seq_len, H, D]
caches (the transformer's decode branch); the remaining positions run one
token at a time. Right-padded prompts of mixed lengths share a batch:
each row keeps its given tokens until its prompt ends (``prompt_lens``).

Sampling: greedy at temperature 0, else one Gumbel-max draw per row from a
generator seeded by (seed, row, position), so a row's draw depends only on
those three, never on the batch it shares. The draws are not JAX's.

MoE configs decode through the same loop: each layer's tail runs the
``MoEMlp`` at one token a step (the reference's flax token loop computes
the same module at T = 1).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads.train import resolve_device
from kubeoperator_tpu_torch.workloads.transformer import (
    Block, Transformer, TransformerConfig, dense, rms_norm, rope, tied_logits,
    token_qkv,
)

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def row_seed(seed: int, row: int, pos: int) -> int:
    """Seed of the draw for (seed, row, position): splitmix64 over each."""
    h = 0
    for v in (seed, row, pos):
        h = _splitmix64(h ^ (v & _M64))
    return h


def gumbel_noise(keys: Sequence[tuple[int, int, int]], vocab: int,
                 gen: torch.Generator, device) -> torch.Tensor:
    """Gumbel noise [len(keys), vocab]: row i from ``gen`` seeded with
    ``row_seed(*keys[i])``."""
    noise = []
    for key in keys:
        gen.manual_seed(row_seed(*key))
        u = torch.rand(vocab, generator=gen, device=device)
        noise.append(-torch.log(-torch.log(u)))
    return torch.stack(noise)


def gumbel_pick(logits: torch.Tensor, temperature: float,
                noise: torch.Tensor) -> torch.Tensor:
    """argmax(logits / temperature + noise) over the last axis."""
    return torch.argmax(logits / temperature + noise, -1)


def gumbel_draw(logits: torch.Tensor, temperature: float,
                keys: Sequence[tuple[int, int, int]],
                gen: torch.Generator) -> torch.Tensor:
    """Temperature sample of each row of ``logits`` [B, V] by Gumbel-max:
    row i's noise is ``gumbel_noise`` of its (seed, row, position) key, so
    a row's draw depends on that key and its own logits only. The one
    sampling rule of ``generate()`` and the slot-pool engine
    (decode_loop.py, whose speculative dispatch draws the noise once and
    picks with it in both of its phases)."""
    return gumbel_pick(logits, temperature,
                       gumbel_noise(keys, logits.shape[-1], gen,
                                    logits.device))


def generate(cfg: TransformerConfig, model: Transformer, prompt,
             max_new_tokens: int, temperature: float = 0.0, seed: int = 0,
             prompt_lens: Sequence[int] | None = None,
             prefill_len: int | None = None,
             device: str | torch.device | None = None) -> torch.Tensor:
    """Greedy (temperature=0) or temperature sampling from ``model`` (the
    port's Transformer built from ``cfg``, on ``device``).

    prompt: [B, P] integers (P >= 1), right-padded when rows differ;
    prompt_lens: [B] true lengths (default all P). prefill_len: tokens
    processed in one forward pass; must not exceed the shortest prompt;
    defaults to P for uniform prompts, else 1. Returns [B, P +
    max_new_tokens] int64 on ``device``.
    """
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, p = prompt.shape
    total = p + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt ({p}) + new tokens ({max_new_tokens}) "
                         f"exceed max_seq_len ({cfg.max_seq_len})")
    if prefill_len is None:
        prefill_len = p if prompt_lens is None else 1
    if not 1 <= prefill_len <= p:
        raise ValueError(f"prefill_len {prefill_len} outside [1, {p}]")
    if prompt_lens is not None:
        # the chunk positions must all hold GIVEN tokens: a prefill past
        # the shortest prompt would feed row padding through the model
        shortest = int(min(int(n) for n in prompt_lens))
        if prefill_len > shortest:
            raise ValueError(
                f"prefill_len {prefill_len} exceeds shortest prompt "
                f"({shortest}): every prefilled position needs a given "
                f"token in all rows")
    if model.embedding.device != dev:
        raise ValueError(f"model is on {model.embedding.device}, "
                         f"generation on {dev}")
    decode_cfg = replace(cfg, decode=True, remat=False)
    p_vec = (torch.as_tensor([int(n) for n in prompt_lens], device=dev)
             if prompt_lens is not None
             else torch.full((b,), p, device=dev))

    buf = torch.zeros((b, total), dtype=torch.long, device=dev)
    buf[:, :p] = prompt
    if max_new_tokens == 0:
        # nothing to generate: the output IS the prompt (the prefill would
        # otherwise overwrite the last prompt token)
        return buf

    gen = torch.Generator(device=dev)

    def choose(logits: torch.Tensor, pos: int) -> None:
        """Write the token for position pos+1 from position pos's logits:
        the given prompt token while pos+1 is inside a row's prompt, the
        model's choice after."""
        if temperature > 0:
            nxt = gumbel_draw(logits, temperature,
                              [(seed, row, pos) for row in range(b)], gen)
        else:
            nxt = torch.argmax(logits, dim=-1)
        at = min(pos + 1, total - 1)
        keep_prompt = pos + 1 < p_vec
        buf[:, at] = torch.where(keep_prompt, buf[:, at], nxt)

    caches = [(torch.zeros((b, cfg.max_seq_len, cfg.n_heads, cfg.head_dim),
                           dtype=cfg.dtype, device=dev),
               torch.zeros((b, cfg.max_seq_len, cfg.n_heads, cfg.head_dim),
                           dtype=cfg.dtype, device=dev))
              for _ in range(cfg.n_layers)]
    with torch.no_grad():
        # -- prefill: the shared prefix in one chunked pass ------------------
        start = prefill_len - 1
        if prefill_len > 1:
            logits = model(buf[:, :prefill_len],
                           torch.arange(prefill_len, device=dev), caches)
            choose(logits[:, -1, :], start)
            start += 1
        # -- decode: one token per step --------------------------------------
        if start < total - 1:
            _decode_loop(decode_cfg, model, caches, buf,
                         range(start, total - 1), choose)
    return buf


def attn_out_mlp(blk: Block, x: torch.Tensor, probs: torch.Tensor,
                 cv: torch.Tensor, dt: torch.dtype
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Post-softmax tail of one decode layer: attention output projection,
    residual add, ln2 + FFN, residual add. Returns ``(x, load)``: for an
    MoE layer (``_layer_tail`` of the reference's engine) the FFN is the
    ``MoEMlp`` on the UNCAST norm output, as the flax block feeds it, and
    load [E] f32 counts the tokens dispatched to each expert; a dense
    layer's load is None. On a serving mesh (``sharding.place_decode``)
    the block holds H/tp heads and d_ff/tp of its MLP, so the output
    projection and the MLP's down product are summed over tp: the
    reference's two all-reduces a block."""
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), cv)
    x = x + cl.reduce_from(dense(out, blk.attn.o, dt, n_in=2), blk.attn.tp)
    if hasattr(blk, "moe"):
        y, load = blk.moe.serve(rms_norm(x, blk.ln2.scale))
        return x + y, load
    m = blk.mlp
    h2 = rms_norm(x, blk.ln2.scale).to(dt)
    gate, up = dense(h2, m.gate, dt), dense(h2, m.up, dt)
    return x + cl.reduce_from(dense(F.silu(gate) * up, m.down, dt),
                              m.tp), None


def final_logits(cfg: TransformerConfig, model: Transformer,
                 x: torch.Tensor) -> torch.Tensor:
    """ln_f + tied-embedding logits, honouring ``logits_bf16``."""
    return tied_logits(cfg, rms_norm(x, model.ln_f.scale), model.embedding)


def _decode_loop(cfg: TransformerConfig, model: Transformer, caches: list,
                 buf: torch.Tensor, positions: range,
                 choose: Callable) -> None:
    """Token-at-a-time decode: a Python loop over positions, writing each
    layer's cache tensors in place (the JAX version carried functional
    buffers through a ``lax.scan``). The math mirrors the transformer's
    decode branch op for op."""
    dt, s = cfg.dtype, cfg.max_seq_len
    scale = 1.0 / (cfg.head_dim ** 0.5)
    slots = torch.arange(s, device=buf.device)
    for pos in positions:
        x = F.embedding(buf[:, pos:pos + 1], model.embedding).to(dt)
        pos1 = torch.full((1,), pos, device=buf.device)
        for blk, (ck, cv) in zip(model.layers, caches):
            h = rms_norm(x, blk.ln1.scale).to(dt)
            q, k, v = token_qkv(blk.attn, h, dt)
            q, k = rope(q, pos1), rope(k, pos1)
            ck[:, pos] = k[:, 0].to(dt)
            cv[:, pos] = v[:, 0].to(dt)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  ck.float()) * scale
            scores = torch.where(slots <= pos, scores,
                                 torch.full_like(scores, -1e30))
            x, _ = attn_out_mlp(blk, x, torch.softmax(scores, dim=-1), cv,
                                dt)
        choose(final_logits(cfg, model, x)[:, 0, :], pos)
