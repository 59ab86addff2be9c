"""Fused (flash) attention: hand-written Hopper CUDA kernels with a custom
autograd rule, and the plain PyTorch versions they are held against.

Counterpart of ``kubeoperator_tpu/workloads/flash_attention.py``
(``flash_attention(layout="bh")``). The kernels live in
``csrc/flash_attention.cu``:

- K1 ``flash_fwd``: online-softmax forward, O and LSE = m + log l;
- K2 ``flash_bwd_dq``: dQ per q-tile over K/V tiles up to the diagonal;
- K3 ``flash_bwd_dkv``: dK, dV per k-tile over Q tiles from the diagonal.

Each wrapper takes [BH, T, D] tensors. For tensors on the CPU it runs the
plain version beside it (a dense formula that materialises the scores: the
spec of the kernel, and what the CPU tests run). For CUDA tensors it
launches the kernel or raises; there is no other path. Each wrapper counts
its kernel launches in ``LAUNCHES`` so a run can show it went through them.

The op is registered as ``torch.library`` custom op so that selective
activation checkpointing (``remat_policy="dots+attn"``) can save its
output and skip the kernel on recompute.
"""

from __future__ import annotations

import torch

from kubeoperator_tpu_torch import kernels

DEFAULT_BLOCK = 512     # the JAX package's tuned TPU block; here it only
                        # sets the padded length (the kernels tile by 64)
NEG_INF = -1e30
HEAD_DIMS = (64, 128)

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


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


TILE = 64               # rows per tile of the CUDA kernels (BQ = BK in
                        # csrc/flash_attention.cu); T must be a multiple


def _check_cuda(name: str, blocks: tuple, rows: tuple = ()) -> None:
    """Raise unless the [BH, T, D] ``blocks`` are bf16 and the [BH, T]
    ``rows`` f32, all contiguous, aligned, on one card, of one shape."""
    bh, t, d = blocks[0].shape
    if not blocks[0].is_cuda:
        raise ValueError(f"{name}: no kernel for device {blocks[0].device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if t % TILE:
        raise ValueError(f"{name}: T={t} is not a multiple of the "
                         f"{TILE}-row tile (pad it)")
    for x, shape, dtype in ([(x, (bh, t, d), torch.bfloat16) for x in blocks]
                            + [(x, (bh, t), torch.float32) for x in rows]):
        if x.device != blocks[0].device:
            raise ValueError(f"{name}: tensors on different devices")
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")


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


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    scale, causal, kv_len = ctx.args
    do = do.contiguous()
    # Δ = rowsum(dO ∘ O) in f32: outside the kernels, as in the JAX _bwd
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, kv_len)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, kv_len)
    return dq, dk, dv, None, None, None


_flash_op.register_autograd(_backward, setup_context=_setup_context)

FLASH_OP = torch.ops.kubeoperator_tpu_torch.flash_attention_bh.default


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
    (``kv_len``), so the result equals the unpadded attention."""
    if layout == "packed":
        raise NotImplementedError(
            "flash_attention(layout='packed') is not ported yet "
            "(ROADMAP queue 2, kernels K4-K6)")
    if layout != "bh":
        raise ValueError(f"unknown layout {layout!r}")
    b, t, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    tp = padded_len(t, block, TILE)

    def flat(x):
        x = x.transpose(1, 2).reshape(b * h, t, d)
        if tp != t:
            x = torch.nn.functional.pad(x, (0, 0, 0, tp - t))
        return x.contiguous()

    o, _ = FLASH_OP(flat(q), flat(k), flat(v), scale, causal, t)
    return o[:, :t].reshape(b, h, t, d).transpose(1, 2)
