"""Fused (1×1 conv → BatchNorm → relu) unit with a hand-written backward:
the counterpart of ``kubeoperator_tpu/workloads/bn_fused.py``.

Forward: ``forward_math``, the one copy of conv → batch stats → normalize
→ relu, shared by the fused op's primal, the small-shape autograd fallback
and the running-average path. Backward (kernel K8, ``conv_bn_relu_bwd``),
from the saved x, w, y, γ, β, μ, inv = rsqrt(var + ε):

- phase 0: Σg′ and Σg′·x̂ per channel, g′ the relu-gated upstream grad;
  these are dβ and dγ;
- phase 1: dy = γ·inv·(g′ − Σg′/N − x̂·Σg′x̂/N) in the model dtype, then
  dx = dy·wᵀ and dW = xᵀ·dy (f32).

Each phase has its wrapper: for CUDA tensors ``bn_bwd_stats``,
``bn_bwd_dx`` and ``bn_bwd_dw`` launch ``ko_bn_bwd_stats``,
``ko_bn_bwd_dx`` and ``ko_bn_bwd_dw`` in stream order (phase 1 forms dy
on chip from the g and y it loads; ``csrc/conv_bwd.cu``) or raise; for CPU
tensors each runs its plain version. The relu gate is the TPU kernel's:
(γ·x̂ + β) rounded to the model dtype and compared in f32, which rounds
differently from the forward's (y − μ)·(γ·inv) + β; both the kernel and
its plain version keep the kernel's formula. The TPU kernel also reordered
rows to [H, W, B, C] so that its operands were bitcasts; channel sums and
1×1 products do not depend on row order, so here x, g and y are the free
``[N, C]`` views of the NHWC tensors and dx comes back in [B, H, W, C]
order.
"""

from __future__ import annotations

import torch
from torch import nn

from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.workloads.conv_vjp import (
    _lecun_normal_, check_channels, check_cuda, conv2d_nhwc, k8_dw_chunks,
    stream_of,
)

LAUNCHES = {"bn_bwd_stats": 0, "bn_bwd_dx": 0, "bn_bwd_dw": 0}

SUM_ROWS = 512          # rows per chunk of the column sums (phase 0, K9)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sum_chunks(n: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of a column sum over n rows: 512-row
    chunks, fewer than 65,536 of them."""
    rows = max(SUM_ROWS, -(-n // 65535))
    return rows, -(-n // rows)


def forward_math(x, kernel4, gamma, beta, eps: float, relu: bool,
                 mean=None, var=None):
    """conv (1×1, stride 1) → stats → normalize → relu, as
    ``bn_fused._forward_math``: statistics in f32 from the conv output y
    (var = E[y²] − E[y]², not clipped), the output (y − μ)·(γ·inv) + β
    rounded to x's dtype, then ``maximum(·, 0)``. mean and var default to
    the batch statistics. Returns (out, mean, var, y, inv)."""
    y = conv2d_nhwc(x, kernel4, (1, 1), ((0, 0), (0, 0)))
    yf = y.float()
    if mean is None:
        mean = yf.mean((0, 1, 2))
        var = (yf * yf).mean((0, 1, 2)) - mean * mean
    inv = torch.rsqrt(var + eps)
    pre = ((yf - mean) * (gamma * inv) + beta).to(x.dtype)
    out = torch.maximum(pre, pre.new_zeros(())) if relu else pre
    return out, mean, var, y, inv


def _gate_plain(g2, y2, gamma, beta, mu, inv, relu: bool):
    """(g′, x̂) in f32: x̂ = (y − μ)·inv, g′ = g where the kernel's gate
    bf16(γ·x̂ + β) > 0 (with ``relu``), in the TPU kernel's order of f32
    operations."""
    g, xhat = g2.float(), (y2.float() - mu) * inv
    if relu:
        pre = (gamma * xhat + beta).to(g2.dtype).float()
        g = torch.where(pre > 0, g, torch.zeros_like(g))
    return g, xhat


def bn_bwd_stats_plain(g2, y2, gamma, beta, mu, inv, relu: bool):
    """K8's phase 0: [2, Co] f32 = (Σg′, Σg′·x̂) over the rows, i.e.
    (dβ, dγ)."""
    g, xhat = _gate_plain(g2, y2, gamma, beta, mu, inv, relu)
    return torch.stack([g.sum(0), (g * xhat).sum(0)])


def _dy_plain(g2, y2, gamma, beta, mu, inv, sums, relu: bool, dtype):
    """K8's dy = γ·inv·(g′ − Σg′/N − x̂·Σg′x̂/N) rounded to ``dtype``."""
    g, xhat = _gate_plain(g2, y2, gamma, beta, mu, inv, relu)
    inv_n = 1.0 / g2.shape[0]
    return ((gamma * inv) * (g - sums[0] * inv_n - xhat * (sums[1] * inv_n))
            ).to(dtype)


def bn_bwd_dx_plain(g2, y2, w, gamma, beta, mu, inv, sums, relu: bool):
    """K8's phase-1 dx = dy·wᵀ, f32 accumulation, in w's dtype (the model
    dtype: x and the kernel are promoted together)."""
    dy = _dy_plain(g2, y2, gamma, beta, mu, inv, sums, relu, w.dtype)
    return torch.matmul(dy.float(), w.float().t()).to(w.dtype)


def bn_bwd_dw_plain(x2, g2, y2, gamma, beta, mu, inv, sums, relu: bool):
    """K8's phase-1 dW = xᵀ·dy in f32."""
    dy = _dy_plain(g2, y2, gamma, beta, mu, inv, sums, relu, x2.dtype)
    return torch.matmul(x2.float().t(), dy.float())


def conv_bn_relu_bwd_plain(x2, g2, y2, w, gamma, beta, mu, inv, relu: bool):
    """K8's spec: (dx [N, Ci], dW [Ci, Co] f32, dγ, dβ [Co] f32) from x2
    [N, Ci], g2 and y2 [N, Co], w [Ci, Co] and the [Co] f32 vectors."""
    sums = bn_bwd_stats_plain(g2, y2, gamma, beta, mu, inv, relu)
    return (bn_bwd_dx_plain(g2, y2, w, gamma, beta, mu, inv, sums, relu),
            bn_bwd_dw_plain(x2, g2, y2, gamma, beta, mu, inv, sums, relu),
            sums[1], sums[0])


def _check_bn(name, g2, y2, vecs, *more) -> None:
    n, co = g2.shape
    bf, f32 = torch.bfloat16, torch.float32
    check_cuda(name, (g2, (n, co), bf), (y2, (n, co), bf),
               *((v, (co,), f32) for v in vecs), *more)


def bn_bwd_stats(g2, y2, gamma, beta, mu, inv, relu: bool) -> torch.Tensor:
    """K8's phase 0, ``ko_bn_bwd_stats`` for CUDA tensors (bf16 g and y,
    f32 vectors, Co a multiple of 64), the plain version for CPU ones."""
    if g2.device.type == "cpu":
        return bn_bwd_stats_plain(g2, y2, gamma, beta, mu, inv, relu)
    vecs = (gamma, beta, mu, inv)
    _check_bn("bn_bwd_stats", g2, y2, vecs)
    n, co = g2.shape
    check_channels("bn_bwd_stats", co)
    sums = torch.empty((2, co), dtype=torch.float32, device=g2.device)
    rows, chunks = sum_chunks(n)
    ws = torch.empty((chunks, 2, co), dtype=torch.float32, device=g2.device)
    lib = kernels.load("conv_bwd")
    kernels.check(lib.ko_bn_bwd_stats(
        g2.data_ptr(), y2.data_ptr(), *(v.data_ptr() for v in vecs),
        sums.data_ptr(), ws.data_ptr(), n, co, int(relu), rows, chunks,
        stream_of(g2)), "bn_bwd_stats")
    LAUNCHES["bn_bwd_stats"] += 1
    return sums


def bn_bwd_dx(g2, y2, w, gamma, beta, mu, inv, sums, relu: bool):
    """K8's phase-1 dx, ``ko_bn_bwd_dx`` for CUDA tensors, the plain
    version for CPU ones."""
    if g2.device.type == "cpu":
        return bn_bwd_dx_plain(g2, y2, w, gamma, beta, mu, inv, sums, relu)
    n, co = g2.shape
    ci = w.shape[0]
    vecs = (gamma, beta, mu, inv)
    _check_bn("bn_bwd_dx", g2, y2, vecs, (w, (ci, co), torch.bfloat16),
              (sums, (2, co), torch.float32))
    check_channels("bn_bwd_dx", ci, co)
    dx = torch.empty((n, ci), dtype=torch.bfloat16, device=g2.device)
    lib = kernels.load("conv_bwd")
    kernels.check(lib.ko_bn_bwd_dx(
        g2.data_ptr(), y2.data_ptr(), w.data_ptr(),
        *(v.data_ptr() for v in vecs), sums.data_ptr(), dx.data_ptr(), n, ci,
        co, int(relu), stream_of(g2)), "bn_bwd_dx")
    LAUNCHES["bn_bwd_dx"] += 1
    return dx


def bn_bwd_dw(x2, g2, y2, gamma, beta, mu, inv, sums, relu: bool):
    """K8's phase-1 dW (f32), ``ko_bn_bwd_dw`` for CUDA tensors, the plain
    version for CPU ones."""
    if x2.device.type == "cpu":
        return bn_bwd_dw_plain(x2, g2, y2, gamma, beta, mu, inv, sums, relu)
    n, ci = x2.shape
    co = g2.shape[1]
    vecs = (gamma, beta, mu, inv)
    _check_bn("bn_bwd_dw", g2, y2, vecs, (x2, (n, ci), torch.bfloat16),
              (sums, (2, co), torch.float32))
    check_channels("bn_bwd_dw", ci, co)
    dw = torch.empty((ci, co), dtype=torch.float32, device=x2.device)
    rows, chunks = k8_dw_chunks(n, ci, co)
    ws = torch.empty((chunks, ci, co), dtype=torch.float32, device=x2.device)
    lib = kernels.load("conv_bwd")
    kernels.check(lib.ko_bn_bwd_dw(
        x2.data_ptr(), g2.data_ptr(), y2.data_ptr(),
        *(v.data_ptr() for v in vecs), sums.data_ptr(), dw.data_ptr(),
        ws.data_ptr(), n, ci, co, int(relu), rows, chunks, stream_of(x2)),
        "bn_bwd_dw")
    LAUNCHES["bn_bwd_dw"] += 1
    return dw


def conv_bn_relu_bwd(x2, g2, y2, w, gamma, beta, mu, inv, relu: bool):
    """K8: the fused backward (see the module docstring), phase 0 then the
    two phase-1 products; on the card three launches in stream order,
    on the CPU the plain versions. Returns (dx, dW f32, dγ, dβ)."""
    sums = bn_bwd_stats(g2, y2, gamma, beta, mu, inv, relu)
    dx = bn_bwd_dx(g2, y2, w, gamma, beta, mu, inv, sums, relu)
    dw = bn_bwd_dw(x2, g2, y2, gamma, beta, mu, inv, sums, relu)
    return dx, dw, sums[1], sums[0]


class _FusedTrain(torch.autograd.Function):
    """(out, μ, var) of the unit with batch statistics; the gradient of out
    flows to x, w, γ, β through K8 (μ and var feed only the running-stat
    update, as the JAX package's stop_gradient'd outputs do)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, relu: bool, eps: float):
        out, mu, var, y, inv = forward_math(x, w[None, None], gamma, beta,
                                            eps, relu)
        ctx.save_for_backward(x, w, y, gamma, beta, mu, inv)
        ctx.relu = relu
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, g, _dmu, _dvar):
        x, w, y, gamma, beta, mu, inv = ctx.saved_tensors
        n = x.shape[0] * x.shape[1] * x.shape[2]
        dx, dw, dgamma, dbeta = conv_bn_relu_bwd(
            x.reshape(n, -1), g.contiguous().reshape(n, -1),
            y.reshape(n, -1), w, gamma, beta, mu, inv, ctx.relu)
        return dx.view(x.shape), dw.to(w.dtype), dgamma, dbeta, None, None


class FusedConvBN(nn.Module):
    """(1×1 stride-1 conv, no bias) + BatchNorm + optional relu with the K8
    backward. Parameters and buffers as flax's module: ``kernel`` [1, 1,
    Ci, Co], ``scale``, ``bias``, and the running ``mean`` and ``var``.
    In training mode the batch statistics are used and the running ones
    updated (momentum 0.9); with N = B·H·W not a multiple of 128 the
    forward math runs under plain autograd instead (``bn_fused.py:258``).
    In eval mode the running statistics normalize."""

    def __init__(self, in_features: int, features: int, relu: bool = True,
                 momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(1, 1, in_features, features))
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.relu, self.momentum, self.eps = relu, momentum, eps
        self.dtype, self.zero_scale = dtype, zero_scale

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.kernel, self.kernel.shape[2], gen)
        nn.init.constant_(self.scale, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, kernel = x.to(self.dtype), self.kernel.to(self.dtype)
        if not self.training:
            return forward_math(x, kernel, self.scale, self.bias, self.eps,
                                self.relu, mean=self.mean, var=self.var)[0]
        if (x.shape[0] * x.shape[1] * x.shape[2]) % 128:
            out, mu, var, _, _ = forward_math(x, kernel, self.scale,
                                              self.bias, self.eps, self.relu)
        else:
            out, mu, var = _FusedTrain.apply(x, kernel[0, 0], self.scale,
                                             self.bias, self.relu, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mu)
            self.var.copy_(m * self.var + (1 - m) * var)
        return out
