"""Fused (flash) attention: hand-written Hopper CUDA kernels with a custom
autograd rule, and the plain PyTorch versions they are held against.

Counterpart of ``kubeoperator_tpu/workloads/flash_attention.py``
(``flash_attention``, both layouts). The kernels live in
``csrc/flash_attention.cu``:

- K1 ``flash_fwd``: online-softmax forward, O and LSE = m + log l;
- K2 ``flash_bwd_dq``: dQ per q-tile over K/V tiles up to the diagonal;
- K3 ``flash_bwd_dkv``: dK, dV per k-tile over Q tiles from the diagonal;
- K4-K6 ``flash_fwd_packed``, ``flash_bwd_dq_packed``,
  ``flash_bwd_dkv_packed``: the same three kernels on the packed layout;
- ``bh_delta``, ``packed_delta``: Δ = rowsum(dO ∘ O), the backward
  kernels' f32 input, one kernel for both layouts (the JAX package leaves
  it to XLA: no TPU kernel stands behind it).

The K1-K3 wrappers take [BH, T, D] tensors ("bh" layout: heads flattened
into the batch around the kernels). The K4-K6 wrappers take [B, T, H·D]
("packed" layout: the attention projections' [B, T, H, D] output,
reshaped for free); the kernels address a head by its column offset and
the row stride H·D, so no transpose is made. For tensors on the CPU a
wrapper runs the plain version beside it (a dense formula that
materialises the scores: the spec of the kernel, and what the CPU tests
run). For CUDA tensors it launches the kernel or raises; there is no
other path. Each wrapper counts its kernel launches in ``LAUNCHES`` so a
run can show it went through them.

Each layout's op is registered as a ``torch.library`` custom op so that
selective activation checkpointing (``remat_policy="dots+attn"``) can
save its output and skip the kernel on recompute.
"""

from __future__ import annotations

import torch

from kubeoperator_tpu_torch import kernels

DEFAULT_BLOCK = 512     # the JAX package's tuned TPU block; here it only
                        # sets the padded length (the kernels tile by 64)
NEG_INF = -1e30
HEAD_DIMS = (64, 128)

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_packed": 0, "flash_bwd_dq_packed": 0,
            "flash_bwd_dkv_packed": 0, "flash_delta": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scores_plain(q, k, scale, causal, kv_len):
    """Masked f32 scores [BH, T, T] exactly as the kernels mask them."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    t = q.shape[1]
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    keep = cols < kv_len
    if causal:
        keep = keep & (rows >= cols)
    return torch.where(keep[None], s, torch.full_like(s, NEG_INF))


def flash_fwd_plain(q, k, v, scale: float, causal: bool, kv_len: int):
    """K1's spec: (o in q's dtype, lse f32 [BH, T])."""
    s = _scores_plain(q, k, scale, causal, kv_len)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_plain(q, k, lse, scale, causal, kv_len):
    return torch.exp(_scores_plain(q, k, scale, causal, kv_len) - lse[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool,
                       kv_len: int):
    """K2's spec: dQ = (P ∘ (dO·Vᵀ − Δ)) · K · scale, in q's dtype."""
    p = _probs_plain(q, k, lse, scale, causal, kv_len)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float, causal: bool,
                        kv_len: int):
    """K3's spec: dV = Pᵀ·dO, dK = dSᵀ·Q·scale, in k's and v's dtypes."""
    p = _probs_plain(q, k, lse, scale, causal, kv_len)
    dv = torch.matmul(p.transpose(1, 2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


TILE = 64               # rows per streamed tile of the CUDA kernels
                        # (F_KEYS in csrc/flash_attention.cu); T must be
                        # a multiple


def _check_tensors(name: str, first: torch.Tensor, t: int, d: int,
                   specs: list) -> None:
    """Raise unless the head dim and T are ones the kernels take, ``first``
    is on a card, and each (tensor, shape, dtype) of ``specs`` matches and
    is contiguous, 16-byte aligned and on ``first``'s device."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if t % TILE:
        raise ValueError(f"{name}: T={t} is not a multiple of the "
                         f"{TILE}-row tile (pad it)")
    if not first.is_cuda:
        raise ValueError(f"{name}: no kernel for device {first.device}")
    for x, shape, dtype in specs:
        if x.device != first.device:
            raise ValueError(f"{name}: tensors on different devices")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")


def _check_cuda(name: str, blocks: tuple, rows: tuple = ()) -> None:
    """Raise unless the [BH, T, D] ``blocks`` are bf16 and the [BH, T]
    ``rows`` f32, all contiguous, aligned, on one card, of one shape."""
    bh, t, d = blocks[0].shape
    _check_tensors(name, blocks[0], t, d,
                   [(x, (bh, t, d), torch.bfloat16) for x in blocks]
                   + [(x, (bh, t), torch.float32) for x in rows])


def _check_cuda_packed(name: str, heads: int, blocks: tuple,
                       rows: tuple = ()) -> None:
    """Raise unless the [B, T, H·D] ``blocks`` are bf16 and the [B, H, T]
    ``rows`` f32, all contiguous, aligned, on one card, of one shape. A
    head's slice starts at h·D and its rows are H·D apart, so the kernels'
    16-byte loads need H·D % 8 == 0 as well as an aligned pointer."""
    b, t, hd = blocks[0].shape
    if heads <= 0 or hd % heads:
        raise ValueError(f"{name}: width {hd} is not a multiple of "
                         f"{heads} heads")
    if hd % 8:
        raise ValueError(f"{name}: row width {hd} breaks 16-byte loads")
    _check_tensors(name, blocks[0], t, hd // heads,
                   [(x, (b, t, hd), torch.bfloat16) for x in blocks]
                   + [(x, (b, heads, t), torch.float32) for x in rows])


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_fwd(q, k, v, scale: float, causal: bool, kv_len: int):
    """K1. q, k, v: [BH, T, D]. Returns (o [BH, T, D], lse [BH, T] f32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, kv_len)
    _check_cuda("flash_fwd", (q, k, v))
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = kernels.load("flash_attention")
    err = lib.ko_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), bh, t, d,
                           float(scale), int(causal), int(kv_len), _stream())
    kernels.check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool,
                 kv_len: int):
    """K2. Returns dq [BH, T, D]."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal,
                                  kv_len)
    _check_cuda("flash_bwd_dq", (q, k, v, do), (lse, delta))
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    err = lib.ko_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              dq.data_ptr(), bh, t, d, float(scale),
                              int(causal), int(kv_len), _stream())
    kernels.check(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool,
                  kv_len: int):
    """K3. Returns (dk, dv) [BH, T, D]."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                                   kv_len)
    _check_cuda("flash_bwd_dkv", (q, k, v, do), (lse, delta))
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = kernels.load("flash_attention")
    err = lib.ko_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               bh, t, d, float(scale), int(causal),
                               int(kv_len), _stream())
    kernels.check(err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# the differentiable op: forward K1, backward Δ + K2 + K3
# ---------------------------------------------------------------------------

@torch.library.custom_op("kubeoperator_tpu_torch::flash_attention_bh",
                         mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool, kv_len: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, scale, causal, kv_len)


@_flash_op.register_fake
def _(q, k, v, scale, causal, kv_len):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, scale, causal, kv_len = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = (scale, causal, kv_len)


def bh_delta_plain(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Δ's spec for [BH, T, D] tensors: rowsum(dO ∘ O) in f32, laid out
    [BH, T] like lse, as the JAX _bwd computes it."""
    return (do.float() * o.float()).sum(-1).contiguous()


def packed_delta_plain(do: torch.Tensor, o: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """Δ's spec for [B, T, H·D] tensors: rowsum(dO ∘ O) per (b, t, h) in
    f32, laid out [B, H, T] like lse, as the JAX _bwd_packed computes it."""
    b, t, hd = o.shape
    return ((do.float() * o.float()).reshape(b, t, heads, hd // heads)
            .sum(-1).transpose(1, 2).contiguous())


def _delta_kernel(do: torch.Tensor, o: torch.Tensor, b: int, t: int,
                  heads: int) -> torch.Tensor:
    """Δ by ``flash_delta_kernel``: dO and O read as [b, t, heads·D] bf16
    (any t), Δ [b, heads, t] f32."""
    if heads <= 0 or o.shape[-1] % heads:
        raise ValueError(f"flash_delta: width {o.shape[-1]} is not a "
                         f"multiple of {heads} heads")
    d = o.shape[-1] // heads
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_delta: head dim {d} not in {HEAD_DIMS}")
    if not o.is_cuda:
        raise ValueError(f"flash_delta: no kernel for device {o.device}")
    for x in (do, o):
        if x.device != o.device or x.shape != o.shape:
            raise ValueError("flash_delta: dO and O differ in device or shape")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_delta: expected bf16, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash_delta: inputs must be contiguous and "
                             "16-byte aligned")
    delta = torch.empty((b, heads, t), dtype=torch.float32, device=o.device)
    lib = kernels.load("flash_attention")
    err = lib.ko_flash_delta(do.data_ptr(), o.data_ptr(), delta.data_ptr(), b,
                             t, heads, d, _stream())
    kernels.check(err, "flash_delta")
    LAUNCHES["flash_delta"] += 1
    return delta


def bh_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) in f32 for [BH, T, D] tensors, laid out [BH, T]
    like lse."""
    if o.device.type == "cpu":
        return bh_delta_plain(do, o)
    bh, t, _ = o.shape
    return _delta_kernel(do, o, bh, t, 1).view(bh, t)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    scale, causal, kv_len = ctx.args
    do = do.contiguous()
    delta = bh_delta(do, o)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, kv_len)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, kv_len)
    return dq, dk, dv, None, None, None


_flash_op.register_autograd(_backward, setup_context=_setup_context)

FLASH_OP = torch.ops.kubeoperator_tpu_torch.flash_attention_bh.default


# ---------------------------------------------------------------------------
# the packed layout: [B, T, H·D] in and out, LSE and Δ [B, H, T] f32
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, H·D] -> [B·H, T, D]"""
    b, t, hd = x.shape
    d = hd // heads
    return x.reshape(b, t, heads, d).transpose(1, 2).reshape(b * heads, t, d)


def _merge_heads(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B·H, T, D] -> [B, T, H·D]"""
    bh, t, d = x.shape
    return x.reshape(b, bh // b, t, d).transpose(1, 2).reshape(b, t, -1)


def flash_fwd_packed_plain(q, k, v, heads: int, scale: float, causal: bool,
                           kv_len: int):
    """K4's spec: K1's function per head of the packed inputs; (o [B, T,
    H·D] in q's dtype, lse [B, H, T] f32)."""
    b = q.shape[0]
    o, lse = flash_fwd_plain(*(_split_heads(x, heads) for x in (q, k, v)),
                             scale, causal, kv_len)
    return _merge_heads(o, b), lse.reshape(b, heads, -1)


def flash_bwd_dq_packed_plain(q, k, v, do, lse, delta, heads: int,
                              scale: float, causal: bool, kv_len: int):
    """K5's spec: K2's function per head; dq [B, T, H·D]."""
    b = q.shape[0]
    dq = flash_bwd_dq_plain(*(_split_heads(x, heads) for x in (q, k, v, do)),
                            lse.reshape(b * heads, -1),
                            delta.reshape(b * heads, -1), scale, causal,
                            kv_len)
    return _merge_heads(dq, b)


def flash_bwd_dkv_packed_plain(q, k, v, do, lse, delta, heads: int,
                               scale: float, causal: bool, kv_len: int):
    """K6's spec: K3's function per head; (dk, dv) [B, T, H·D]."""
    b = q.shape[0]
    dk, dv = flash_bwd_dkv_plain(
        *(_split_heads(x, heads) for x in (q, k, v, do)),
        lse.reshape(b * heads, -1), delta.reshape(b * heads, -1), scale,
        causal, kv_len)
    return _merge_heads(dk, b), _merge_heads(dv, b)


def flash_fwd_packed(q, k, v, heads: int, scale: float, causal: bool,
                     kv_len: int):
    """K4. q, k, v: [B, T, H·D]. Returns (o [B, T, H·D], lse [B, H, T]
    f32)."""
    if q.device.type == "cpu":
        return flash_fwd_packed_plain(q, k, v, heads, scale, causal, kv_len)
    _check_cuda_packed("flash_fwd_packed", heads, (q, k, v))
    b, t, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=q.device)
    lib = kernels.load("flash_attention")
    err = lib.ko_flash_fwd_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), lse.data_ptr(), b, t, heads,
                                  hd // heads, float(scale), int(causal),
                                  int(kv_len), _stream())
    kernels.check(err, "flash_fwd_packed")
    LAUNCHES["flash_fwd_packed"] += 1
    return o, lse


def flash_bwd_dq_packed(q, k, v, do, lse, delta, heads: int, scale: float,
                        causal: bool, kv_len: int):
    """K5. Returns dq [B, T, H·D]."""
    if q.device.type == "cpu":
        return flash_bwd_dq_packed_plain(q, k, v, do, lse, delta, heads,
                                         scale, causal, kv_len)
    _check_cuda_packed("flash_bwd_dq_packed", heads, (q, k, v, do),
                       (lse, delta))
    b, t, hd = q.shape
    dq = torch.empty_like(q)
    lib = kernels.load("flash_attention")
    err = lib.ko_flash_bwd_dq_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     do.data_ptr(), lse.data_ptr(),
                                     delta.data_ptr(), dq.data_ptr(), b, t,
                                     heads, hd // heads, float(scale),
                                     int(causal), int(kv_len), _stream())
    kernels.check(err, "flash_bwd_dq_packed")
    LAUNCHES["flash_bwd_dq_packed"] += 1
    return dq


def flash_bwd_dkv_packed(q, k, v, do, lse, delta, heads: int, scale: float,
                         causal: bool, kv_len: int):
    """K6. Returns (dk, dv) [B, T, H·D]."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_packed_plain(q, k, v, do, lse, delta, heads,
                                          scale, causal, kv_len)
    _check_cuda_packed("flash_bwd_dkv_packed", heads, (q, k, v, do),
                       (lse, delta))
    b, t, hd = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = kernels.load("flash_attention")
    err = lib.ko_flash_bwd_dkv_packed(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), do.data_ptr(),
                                      lse.data_ptr(), delta.data_ptr(),
                                      dk.data_ptr(), dv.data_ptr(), b, t,
                                      heads, hd // heads, float(scale),
                                      int(causal), int(kv_len), _stream())
    kernels.check(err, "flash_bwd_dkv_packed")
    LAUNCHES["flash_bwd_dkv_packed"] += 1
    return dk, dv


@torch.library.custom_op("kubeoperator_tpu_torch::flash_attention_packed",
                         mutates_args=())
def _flash_packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, scale: float, causal: bool, kv_len: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd_packed(q, k, v, heads, scale, causal, kv_len)


@_flash_packed_op.register_fake
def _(q, k, v, heads, scale, causal, kv_len):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0], heads, q.shape[1]), dtype=torch.float32))


def _setup_context_packed(ctx, inputs, output):
    q, k, v, heads, scale, causal, kv_len = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.args = (heads, scale, causal, kv_len)


def packed_delta(do: torch.Tensor, o: torch.Tensor,
                 heads: int) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) per (b, t, h) in f32 for [B, T, H·D] tensors,
    laid out [B, H, T] like lse."""
    if o.device.type == "cpu":
        return packed_delta_plain(do, o, heads)
    b, t, _ = o.shape
    return _delta_kernel(do, o, b, t, heads)


def _backward_packed(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    heads, scale, causal, kv_len = ctx.args
    do = do.contiguous()
    delta = packed_delta(do, o, heads)
    args = (heads, scale, causal, kv_len)
    dq = flash_bwd_dq_packed(q, k, v, do, lse, delta, *args)
    dk, dv = flash_bwd_dkv_packed(q, k, v, do, lse, delta, *args)
    return dq, dk, dv, None, None, None, None


_flash_packed_op.register_autograd(_backward_packed,
                                   setup_context=_setup_context_packed)

FLASH_PACKED_OP = (
    torch.ops.kubeoperator_tpu_torch.flash_attention_packed.default)


def padded_len(t: int, block: int, tile: int) -> int:
    """The JAX wrapper's padding (to 128, then to the block), rounded up to
    the CUDA kernels' tile as well."""
    tp = -(-t // 128) * 128
    bq = min(block, tp)
    tp = -(-tp // bq) * bq
    return -(-tp // tile) * tile


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block: int = DEFAULT_BLOCK,
                    layout: str = "bh") -> torch.Tensor:
    """Fused attention. q/k/v: [B, T, H, D]; differentiable through the
    backward kernels. Ragged T is zero-padded and the padded keys masked
    (``kv_len``), so the result equals the unpadded attention.

    ``layout`` picks the memory plumbing, never the math: ``"bh"``
    flattens to [B·H, T, D] around K1-K3 (a transpose each way);
    ``"packed"`` reshapes to [B, T, H·D] for free and runs K4-K6, which
    address the heads in place."""
    if layout not in ("bh", "packed"):
        raise ValueError(f"unknown layout {layout!r}")
    b, t, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    tp = padded_len(t, block, TILE)

    if layout == "packed":
        def pack(x):
            x = x.reshape(b, t, h * d)
            if tp != t:
                x = torch.nn.functional.pad(x, (0, 0, 0, tp - t))
            return x.contiguous()

        o, _ = FLASH_PACKED_OP(pack(q), pack(k), pack(v), h, scale, causal, t)
        return o[:, :t].reshape(b, t, h, d)

    def flat(x):
        x = x.transpose(1, 2).reshape(b * h, t, d)
        if tp != t:
            x = torch.nn.functional.pad(x, (0, 0, 0, tp - t))
        return x.contiguous()

    o, _ = FLASH_OP(flat(q), flat(k), flat(v), scale, causal, t)
    return o[:, :t].reshape(b, h, t, d).transpose(1, 2)
