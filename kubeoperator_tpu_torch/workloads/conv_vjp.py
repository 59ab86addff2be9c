"""Convolution with a custom backward: the counterpart of
``kubeoperator_tpu/workloads/conv_vjp.py``.

Activations are NHWC ``[B, H, W, C]`` tensors and kernels flax's HWIO, as
in the JAX package. A conv runs through cuDNN on the ``permute(0, 3, 1,
2)`` view of its input, which is NCHW to PyTorch and channels-last in
memory, so no layout copy is made; padding follows XLA's SAME rule (see
``same_pads``), asymmetric where XLA's is.

``make_conv(strides, padding, mode)`` is the differentiable conv:

- forward: the library conv, as the JAX package leaves it to XLA;
- backward, mode ``"pallas"``, 1×1 stride 1 and N = B·H·W a multiple of
  128 (``conv_vjp.py:164-165``): kernel K7 (``conv1x1_bwd``), dx = g·wᵀ
  and dW = xᵀ·g in f32 from the ``[N, C]`` views;
- backward, mode ``"dot2"``, 1×1 stride 1 (``conv_vjp.py:168-178``): both
  gradients as library products of the ``[N, C]`` views, dx = g·wᵀ and
  dW = xᵀ·g, in the operands' dtype as ``_dw_dot`` takes its products (no
  kernel: the JAX package computes them as XLA dots);
- backward otherwise (mode ``"dot"``, and every other shape): dInput as
  the transposed conv and dW as one product per kernel tap (``_dw_dot``).

In both, dW is rounded to the kernel's dtype (bf16 in the model, whose f32
masters are cast before the conv), as ``bwd`` does with
``dw.astype(w.dtype)``.

K7's wrapper runs its plain version (two products with f32 accumulation)
for CPU tensors, and for CUDA tensors launches the kernels of
``csrc/conv_bwd.cu`` or raises. ``LAUNCHES`` counts each kernel's launches.
K7 splits dW's rows by ``k7_dw_chunks``; ``k8_dw_chunks`` is K8's split
(``bn_fused``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.workloads.transformer import _lecun_normal_

LAUNCHES = {"conv1x1_bwd_dx": 0, "conv1x1_bwd_dw": 0}

CHANNEL_STEP = 64       # K7 and K8 take channels in multiples of one
                        # 64-wide TMA box (CH in conv_bwd.cu)
K7_TILE = 128           # K7's wgmma output tile (K7_TILE in conv_bwd.cu)
K7_ROW_STEP = 64        # the k-step over rows of K7's and K8's dW (K7_STEP):
                        # a chunk's multiple
K7_MIN_ROWS = 256       # N / this bounds K7's and K8's dW chunks
SMS = 132               # an H100 SXM's SMs: K7's and K8's dW aim at one
                        # wave


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# padding and the library conv
# ---------------------------------------------------------------------------

def same_pads(size: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> tuple:
    """XLA's SAME padding per spatial dim: out = ceil(in / s), total =
    max((out − 1)·s + k − in, 0), ``total // 2`` before and the rest
    after (``lax.padtype_to_pads``)."""
    pads = []
    for n, k, s in zip(size, kernel, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def resolve_pads(x: torch.Tensor, kernel: Sequence[int],
                 strides: Sequence[int], padding: str) -> tuple:
    """The pads of ``padding`` ("SAME" or "VALID") for an NHWC input."""
    if padding == "SAME":
        return same_pads(x.shape[1:3], kernel, strides)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    raise ValueError(f"unknown padding {padding!r}")


def pad_nhwc(x: torch.Tensor, pads: tuple, value: float = 0.0) -> torch.Tensor:
    """x [B, H, W, C] padded by ((top, bottom), (left, right))."""
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as the channels-last OIHW weight cuDNN takes."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                pads: tuple) -> torch.Tensor:
    """The library conv of NHWC ``x`` with HWIO ``w`` (no bias): symmetric
    pads go to the conv, asymmetric ones (XLA's SAME at a stride or an even
    kernel) are applied first with ``F.pad``. Returns [B, Ho, Wo, Co],
    contiguous."""
    if all(lo == hi for lo, hi in pads):
        conv_pad = tuple(lo for lo, _ in pads)
    else:
        x, conv_pad = pad_nhwc(x, pads), (0, 0)
    y = F.conv2d(_nchw(x), _oihw(w), stride=tuple(strides), padding=conv_pad)
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# K7: the 1x1 stride-1 conv backward
# ---------------------------------------------------------------------------

def conv1x1_bwd_dx_plain(g2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K7's dx: g·wᵀ accumulated in f32, in g's dtype."""
    return torch.matmul(g2.float(), w.float().t()).to(g2.dtype)


def conv1x1_bwd_dw_plain(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """K7's dW: xᵀ·g in f32."""
    return torch.matmul(x2.float().t(), g2.float())


def conv1x1_bwd_plain(x2: torch.Tensor, g2: torch.Tensor, w: torch.Tensor):
    """K7's spec: (dx, dW) of a 1×1 stride-1 conv; x2 [N, Ci], g2 [N, Co],
    w [Ci, Co]."""
    return conv1x1_bwd_dx_plain(g2, w), conv1x1_bwd_dw_plain(x2, g2)


def _row_chunks(n: int, tiles: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of a dW split over N with ``tiles`` output
    tiles a chunk: as many chunks as fill one wave of ``SMS`` blocks
    (never more blocks than that) and as N has ``K7_MIN_ROWS``-row pieces,
    of whole ``K7_ROW_STEP``-row k-steps. Depends on the shape only, so
    the fixed-order reduction gives the same bits every run."""
    want = max(1, min(SMS // tiles, -(-n // K7_MIN_ROWS)))
    rows = -(-n // want)
    rows = -(-rows // K7_ROW_STEP) * K7_ROW_STEP
    return rows, -(-n // rows)


def k7_dw_chunks(n: int, ci: int, co: int) -> tuple[int, int]:
    """K7's dW split over N (``_row_chunks``) on its 128 × 128 tiles."""
    return _row_chunks(n, -(-ci // K7_TILE) * -(-co // K7_TILE))


def k8_dw_tile(ci: int, co: int) -> tuple[int, int]:
    """K8's dW block tile (ci, co), as ``k8_dw`` in conv_bwd.cu picks it:
    128 ci by 128 or 64 co where ci is a multiple of 128, else 64 ci by
    256 co where co is a multiple of 256, else 64 by 64."""
    if ci % 128 == 0:
        return 128, 128 if co % 128 == 0 else 64
    return 64, 256 if co % 256 == 0 else 64


def k8_dw_chunks(n: int, ci: int, co: int) -> tuple[int, int]:
    """K8's dW split over N (``_row_chunks``) on its ``k8_dw_tile``
    tiles."""
    tm, tn = k8_dw_tile(ci, co)
    return _row_chunks(n, (ci // tm) * (co // tn))


def stream_of(x: torch.Tensor) -> int:
    """The handle of the current stream on x's card, as the C entry points
    take it (``torch.cuda.current_stream(x.device).cuda_stream``, without
    the Stream object and the device switch that cost the host ~10 µs a
    launch)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def check_cuda(name: str, *specs) -> None:
    """Raise unless every (tensor, shape, dtype) of ``specs`` is on one
    card, of that shape and dtype, contiguous and 16-byte aligned."""
    dev = specs[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for x, shape, dtype in specs:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")


def check_channels(name: str, *channels: int) -> None:
    for c in channels:
        if c <= 0 or c % CHANNEL_STEP:
            raise ValueError(f"{name}: {c} channels; the kernels take "
                             f"multiples of {CHANNEL_STEP}")


def conv1x1_bwd_dx(g2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K7's dx [N, Ci] = g2 [N, Co] · w [Ci, Co]ᵀ: ``ko_conv1x1_bwd_dx``
    for CUDA tensors (bf16, channels multiples of 64), the plain version
    for CPU ones."""
    if kernels.runs_plain(g2):
        return conv1x1_bwd_dx_plain(g2, w)
    n, co = g2.shape
    ci = w.shape[0]
    bf = torch.bfloat16
    check_cuda("conv1x1_bwd_dx", (g2, (n, co), bf), (w, (ci, co), bf))
    check_channels("conv1x1_bwd_dx", ci, co)
    dx = torch.empty((n, ci), dtype=bf, device=g2.device)
    lib = kernels.load("conv_bwd")
    kernels.check(lib.ko_conv1x1_bwd_dx(g2.data_ptr(), w.data_ptr(),
                                        dx.data_ptr(), n, ci, co,
                                        stream_of(g2)), "conv1x1_bwd_dx")
    LAUNCHES["conv1x1_bwd_dx"] += 1
    return dx


def conv1x1_bwd_dw(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """K7's dW [Ci, Co] f32 = x2 [N, Ci]ᵀ · g2 [N, Co]:
    ``ko_conv1x1_bwd_dw`` for CUDA tensors, the plain version for CPU
    ones."""
    if kernels.runs_plain(x2):
        return conv1x1_bwd_dw_plain(x2, g2)
    n, ci = x2.shape
    co = g2.shape[1]
    bf = torch.bfloat16
    check_cuda("conv1x1_bwd_dw", (x2, (n, ci), bf), (g2, (n, co), bf))
    check_channels("conv1x1_bwd_dw", ci, co)
    dw = torch.empty((ci, co), dtype=torch.float32, device=x2.device)
    rows, chunks = k7_dw_chunks(n, ci, co)
    ws = torch.empty((chunks, ci, co), dtype=torch.float32, device=x2.device)
    lib = kernels.load("conv_bwd")
    kernels.check(lib.ko_conv1x1_bwd_dw(x2.data_ptr(), g2.data_ptr(),
                                        dw.data_ptr(), ws.data_ptr(), n, ci,
                                        co, rows, chunks, stream_of(x2)),
                  "conv1x1_bwd_dw")
    LAUNCHES["conv1x1_bwd_dw"] += 1
    return dw


def conv1x1_bwd(x2: torch.Tensor, g2: torch.Tensor, w: torch.Tensor):
    """K7: (dx [N, Ci], dW [Ci, Co] f32) of a 1×1 stride-1 conv from its
    input x2 [N, Ci], upstream grad g2 [N, Co] and kernel w [Ci, Co]: two
    launches on the card (dx, then dW), the plain products on the CPU."""
    return conv1x1_bwd_dx(g2, w), conv1x1_bwd_dw(x2, g2)


# ---------------------------------------------------------------------------
# the dot path
# ---------------------------------------------------------------------------

def _dw_dot(x: torch.Tensor, g: torch.Tensor, kshape: Sequence[int],
            strides: Sequence[int], pads: tuple) -> torch.Tensor:
    """dW[kh, kw, ci, co] = Σ_{b,ho,wo} x_pad[b, ho·sh + kh, wo·sw + kw, ci]
    · g[b, ho, wo, co]: one product per kernel tap over a strided slice of
    the padded input, in the operands' dtype (cuBLAS accumulates in f32 and
    rounds once, as the JAX package's f32 dot rounded by ``astype``)."""
    kh, kw = kshape
    sh, sw = strides
    b, ho, wo, co = g.shape
    xp = pad_nhwc(x, pads)
    g2 = g.reshape(-1, co)
    taps = []
    for di in range(kh):
        for dj in range(kw):
            xs = xp[:, di:di + (ho - 1) * sh + 1:sh,
                    dj:dj + (wo - 1) * sw + 1:sw, :]
            taps.append(torch.matmul(xs.reshape(-1, x.shape[-1]).t(), g2))
    return torch.stack(taps, 0).reshape(kh, kw, x.shape[-1], co)


def _dx_transposed(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                   strides: Sequence[int], pads: tuple) -> torch.Tensor:
    """dInput: the transposed conv of g (the library's data gradient) onto
    the padded input, with the pads cut off."""
    xp = pad_nhwc(x, pads)
    dxp, _, _ = torch.ops.aten.convolution_backward(
        _nchw(g), _nchw(xp), _oihw(w), None, list(strides), [0, 0], [1, 1],
        False, [0, 0], 1, [True, False, False])
    (t, _), (l, _) = pads
    h, wd = x.shape[1:3]
    return dxp.permute(0, 2, 3, 1)[:, t:t + h, l:l + wd].contiguous()


@lru_cache(maxsize=None)
def make_conv(strides: tuple, padding, mode: str = "dot") -> Callable:
    """The differentiable conv ``fn(x NHWC, w HWIO)`` for one (strides,
    padding, mode); ``mode`` is ``"dot"``, ``"pallas"`` or ``"dot2"``."""
    if mode not in ("dot", "pallas", "dot2"):
        raise ValueError(f"unknown conv backward mode {mode!r}")

    class _Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            pads = resolve_pads(x, w.shape[:2], strides, padding)
            ctx.save_for_backward(x, w)
            ctx.pads = pads
            return conv2d_nhwc(x, w, strides, pads)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            kshape = tuple(w.shape[:2])
            n = x.shape[0] * x.shape[1] * x.shape[2]
            g = g.contiguous()
            # where mode "pallas" takes K7 (conv_vjp.py:164-165)
            if (mode == "pallas" and kshape == (1, 1)
                    and tuple(strides) == (1, 1) and n % 128 == 0):
                dx, dw = conv1x1_bwd(x.reshape(n, x.shape[-1]),
                                     g.reshape(n, g.shape[-1]), w[0, 0])
                return dx.view(x.shape), dw.to(w.dtype).view(w.shape)
            if (mode == "dot2" and kshape == (1, 1)
                    and tuple(strides) == (1, 1)):
                g2 = g.reshape(n, g.shape[-1])
                dx = torch.matmul(g2, w[0, 0].t())
                dw = torch.matmul(x.reshape(n, x.shape[-1]).t(), g2)
                return dx.view(x.shape), dw.to(w.dtype).view(w.shape)
            dx = _dx_transposed(x, w, g, strides, ctx.pads)
            dw = _dw_dot(x, g, kshape, strides, ctx.pads).to(w.dtype)
            return dx, dw

    return _Conv.apply


class Conv(nn.Module):
    """A bias-free NHWC conv with flax's HWIO ``kernel`` parameter (f32),
    cast with its input to ``dtype`` before the conv. ``bwd_impl`` set
    (``"dot"``, ``"pallas"`` or ``"dot2"``) takes ``make_conv``'s backward, the
    counterpart of ``conv_vjp.Conv``; ``None`` is flax's ``nn.Conv`` under
    plain autograd of the library conv."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding="SAME", dtype: torch.dtype = torch.float32,
                 bwd_impl: str | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*kernel_size, in_features,
                                               features))
        self.strides, self.padding = tuple(strides), padding
        self.dtype, self.bwd_impl = dtype, bwd_impl
        if bwd_impl is not None:
            make_conv(self.strides, padding, bwd_impl)   # raises early

    def reset_parameters(self, gen: torch.Generator) -> None:
        kh, kw, ci, _ = self.kernel.shape
        _lecun_normal_(self.kernel, kh * kw * ci, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.kernel.to(self.dtype)
        if self.bwd_impl is not None:
            return make_conv(self.strides, self.padding, self.bwd_impl)(x, w)
        pads = resolve_pads(x, w.shape[:2], self.strides, self.padding)
        return conv2d_nhwc(x, w, self.strides, pads)
