"""Training-mode BatchNorm on hand-written kernels: the batch statistics,
the normalize (+ relu) and the closed-form backward of an NHWC activation
(``csrc/batch_norm.cu``).

``BatchNormTrain`` is one autograd Function over x [..., C]:

- forward: ``bn_fwd_sums`` (Σx and Σx² per channel in f32, then μ, var =
  E[x²] − μ² (clipped at 0 with ``clip``), inv = rsqrt(var + ε) and the
  running statistics updated in place), then ``bn_fwd_apply``: out =
  (x − μ)·(γ·inv) + β in f32, rounded to x's dtype, then ``max(·, 0)``
  with ``relu``;
- backward: ``bn_bwd_sums`` (Σg′ and Σg′·x̂, x̂ = (x − μ)·inv, g′ the
  upstream gradient where out > 0 with ``relu``: these are dβ and dγ),
  then ``bn_bwd_dx``: dx = γ·inv·(g′ − Σg′/N − x̂·Σg′x̂/N) in x's dtype.

It saves x, out (with ``relu``: the gate reads the forward's own output)
and the [C] f32 vectors, nothing of [N, C] in f32. Under a mesh the data
groups (``stat_groups``) split the batch: the forward's [2, C] sums are
summed over them before the statistics and the backward's before dx, whose
N is the global row count; dγ and dβ stay the rank's own sums (the trainer
sums parameter gradients over the data axes), as K8 leaves them
(``bn_fused``).

Each wrapper launches its kernels for CUDA tensors (bf16, C a multiple of
8, contiguous) or raises, and runs its plain version for CPU tensors.
``takes_kernels`` decides for the model's modules (``resnet.BatchNorm``,
``bn_fused.FusedConvBN``) from what the input shows: a CUDA bf16 input
with C a multiple of 8 takes the kernels; any other CUDA input the plain
ops, counted in ``LAUNCHES["bn_plain"]``; a CPU input the plain ops
uncounted. ``LAUNCHES`` counts each wrapper's calls on the card, one a
site.
"""

from __future__ import annotations

import math

import torch

from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads.conv_vjp import (
    SMS, check_cuda, stream_of,
)

LAUNCHES = {"bn_fwd_sums": 0, "bn_fwd_apply": 0, "bn_bwd_sums": 0,
            "bn_bwd_dx": 0, "bn_plain": 0}

BLOCKS = 4 * SMS        # the kernels' grid: one wave of four 256-thread
                        # blocks an SM (THREADS in batch_norm.cu)
MIN_ROWS = 64           # rows a chunk at least


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def data_size(groups) -> int:
    """Ranks the global batch is split over: the product of the data
    groups' sizes."""
    return math.prod(cl.group_size(g) for g in groups)


def update_running(running, momentum: float, mean, var) -> None:
    """The running (mean, var) moved to the batch's at ``momentum``, in
    place: the plain ops' update, as flax's."""
    with torch.no_grad():
        running[0].copy_(momentum * running[0] + (1 - momentum) * mean)
        running[1].copy_(momentum * running[1] + (1 - momentum) * var)


def plan(n: int, c: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of the kernels' grid over n rows of c
    channels: a block covers up to 256 channels, and the chunks make
    about ``BLOCKS`` blocks, of ``MIN_ROWS`` rows or more."""
    col_blocks = -(-c // (min(c // 8, 32) * 8))
    chunks = max(1, min(-(-BLOCKS // col_blocks), n // MIN_ROWS))
    rows = -(-n // chunks)
    return rows, -(-n // rows)


def takes_kernels(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether a BatchNorm of ``x`` with output ``dtype`` runs the kernels:
    x on the card, x and the output bf16, its channels a multiple of 8.
    Another input on the card takes the plain ops and counts under
    ``bn_plain``."""
    if kernels.runs_plain(x):
        return False
    if x.dtype == dtype == torch.bfloat16 and x.shape[-1] % 8 == 0:
        return True
    LAUNCHES["bn_plain"] += 1
    return False


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bn_fwd_sums_plain(x2, running_mean, running_var, momentum: float,
                      eps: float, clip: bool, groups=()) -> tuple:
    """(μ, var, inv) [C] f32 of x2's rows, over the global batch of the
    data ``groups``; the running statistics updated in place."""
    xf = x2.float()
    sums = cl.psum_over(torch.stack([xf.sum(0), (xf * xf).sum(0)]), groups)
    count = x2.shape[0] * data_size(groups)
    mean = sums[0] / count
    var = sums[1] / count - mean * mean
    if clip:
        var = torch.clamp_min(var, 0.0)
    update_running((running_mean, running_var), momentum, mean, var)
    return mean, var, torch.rsqrt(var + eps)


def bn_fwd_apply_plain(x2, mean, gamma, inv, beta, relu: bool):
    """(x − μ)·(γ·inv) + β in f32, in x2's dtype, then relu."""
    y = ((x2.float() - mean) * (gamma * inv) + beta).to(x2.dtype)
    return torch.relu(y) if relu else y


def _gated(x2, g2, out2, mean, inv, relu: bool) -> tuple:
    """(g′, x̂) in f32: g′ = g where out > 0 (with ``relu``)."""
    g = g2.float()
    if relu:
        g = torch.where(out2 > 0, g, torch.zeros_like(g))
    return g, (x2.float() - mean) * inv


def bn_bwd_sums_plain(x2, g2, out2, mean, inv, relu: bool) -> torch.Tensor:
    """[2, C] f32 = (Σg′, Σg′·x̂) over the rows: (dβ, dγ)."""
    g, xhat = _gated(x2, g2, out2, mean, inv, relu)
    return torch.stack([g.sum(0), (g * xhat).sum(0)])


def bn_bwd_dx_plain(x2, g2, out2, mean, inv, gamma, sums, relu: bool,
                    n_total: int | None = None):
    """dx = γ·inv·(g′ − Σg′/N − x̂·Σg′x̂/N) in x2's dtype; ``sums`` and
    N = ``n_total`` are the global batch's (default: these rows')."""
    g, xhat = _gated(x2, g2, out2, mean, inv, relu)
    inv_n = 1.0 / (n_total or x2.shape[0])
    return ((gamma * inv) * (g - sums[0] * inv_n - xhat * (sums[1] * inv_n))
            ).to(x2.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check(name: str, x2, *more) -> tuple[int, int]:
    n, c = x2.shape
    check_cuda(name, (x2, (n, c), torch.bfloat16),
               *((v, (c,), torch.float32) for v in more))
    if c % 8:
        raise ValueError(f"{name}: {c} channels; the kernels take "
                         f"multiples of 8")
    return n, c


def bn_fwd_sums(x2, running_mean, running_var, momentum: float, eps: float,
                clip: bool, groups=()) -> tuple:
    """(μ, var, inv) of x2 [N, C] and the running statistics updated:
    ``ko_bn_fwd_sums`` for CUDA tensors (then, under data ``groups``, the
    sums all-reduced and ``ko_bn_finish``), the plain version for CPU
    ones."""
    if kernels.runs_plain(x2):
        return bn_fwd_sums_plain(x2, running_mean, running_var, momentum,
                                 eps, clip, groups)
    n, c = _check("bn_fwd_sums", x2, running_mean, running_var)
    rows, chunks = plan(n, c)
    stats = torch.empty(3 * c, dtype=torch.float32, device=x2.device)
    # scratch: the chunks' partials, then the sums [2, C]
    part = torch.empty((2 * chunks + 2) * c, dtype=torch.float32,
                       device=x2.device)
    at = stats.data_ptr()
    ptrs = (at, at + 4 * c, at + 8 * c, running_mean.data_ptr(),
            running_var.data_ptr())
    fixed = (float(n * data_size(groups)), eps, momentum, 1 - momentum,
             int(clip))
    stream = stream_of(x2)
    lib = kernels.load("batch_norm")
    kernels.check(lib.ko_bn_fwd_sums(
        x2.data_ptr(), part.data_ptr(),
        part.data_ptr() + 8 * chunks * c if groups else None, *ptrs, n, c,
        *fixed, int(not groups), rows, chunks, stream), "bn_fwd_sums")
    if groups:
        sums = cl.psum_over(part[-2 * c:].view(2, c), groups)
        kernels.check(lib.ko_bn_finish(sums.data_ptr(), *ptrs, c, *fixed,
                                       stream), "bn_fwd_sums")
    LAUNCHES["bn_fwd_sums"] += 1
    return stats[:c], stats[c:2 * c], stats[2 * c:]


def bn_fwd_apply(x2, mean, gamma, inv, beta, relu: bool) -> torch.Tensor:
    """out [N, C] = (x − μ)·(γ·inv) + β (then relu): ``ko_bn_fwd_apply``
    for CUDA tensors, the plain version for CPU ones."""
    if kernels.runs_plain(x2):
        return bn_fwd_apply_plain(x2, mean, gamma, inv, beta, relu)
    n, c = _check("bn_fwd_apply", x2, mean, gamma, inv, beta)
    rows, chunks = plan(n, c)
    out = torch.empty_like(x2)
    kernels.check(kernels.load("batch_norm").ko_bn_fwd_apply(
        x2.data_ptr(), mean.data_ptr(), gamma.data_ptr(), inv.data_ptr(),
        beta.data_ptr(), out.data_ptr(), n, c, int(relu), rows, chunks,
        stream_of(x2)), "bn_fwd_apply")
    LAUNCHES["bn_fwd_apply"] += 1
    return out


def _check_bwd(name: str, x2, g2, out2, relu: bool, *vecs) -> tuple:
    n, c = _check(name, x2, *vecs)
    check_cuda(name, (g2, (n, c), torch.bfloat16),
               *(((out2, (n, c), torch.bfloat16),) if relu else ()))
    return n, c


def bn_bwd_sums(x2, g2, out2, mean, inv, relu: bool) -> torch.Tensor:
    """[2, C] f32 = (Σg′, Σg′·x̂) over x2's rows: ``ko_bn_bwd_sums`` for
    CUDA tensors (``out2`` read only with ``relu``), the plain version for
    CPU ones."""
    if kernels.runs_plain(x2):
        return bn_bwd_sums_plain(x2, g2, out2, mean, inv, relu)
    n, c = _check_bwd("bn_bwd_sums", x2, g2, out2, relu, mean, inv)
    rows, chunks = plan(n, c)
    sums = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    part = torch.empty(2 * chunks * c, dtype=torch.float32, device=x2.device)
    kernels.check(kernels.load("batch_norm").ko_bn_bwd_sums(
        x2.data_ptr(), g2.data_ptr(), out2.data_ptr() if relu else None,
        mean.data_ptr(), inv.data_ptr(), part.data_ptr(), sums.data_ptr(), n,
        c, int(relu), rows, chunks, stream_of(x2)), "bn_bwd_sums")
    LAUNCHES["bn_bwd_sums"] += 1
    return sums


def bn_bwd_dx(x2, g2, out2, mean, inv, gamma, sums, relu: bool,
              n_total: int | None = None) -> torch.Tensor:
    """dx [N, C]: ``ko_bn_bwd_dx`` for CUDA tensors, the plain version for
    CPU ones; ``sums`` and ``n_total`` (default: x2's rows) are the global
    batch's."""
    if kernels.runs_plain(x2):
        return bn_bwd_dx_plain(x2, g2, out2, mean, inv, gamma, sums, relu,
                               n_total)
    n, c = _check_bwd("bn_bwd_dx", x2, g2, out2, relu, mean, inv, gamma)
    check_cuda("bn_bwd_dx", (sums, (2, c), torch.float32))
    n_total = n if n_total is None else n_total
    if n_total < n:
        raise ValueError(f"bn_bwd_dx: n_total {n_total} below the {n} rows "
                         f"given")
    rows, chunks = plan(n, c)
    dx = torch.empty_like(x2)
    kernels.check(kernels.load("batch_norm").ko_bn_bwd_dx(
        x2.data_ptr(), g2.data_ptr(), out2.data_ptr() if relu else None,
        mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), sums.data_ptr(),
        dx.data_ptr(), n, n_total, c, int(relu), rows, chunks,
        stream_of(x2)), "bn_bwd_dx")
    LAUNCHES["bn_bwd_dx"] += 1
    return dx


class BatchNormTrain(torch.autograd.Function):
    """out = BatchNorm(x) with batch statistics (then relu), the running
    statistics ``running`` = (mean, var) updated in place at ``momentum``;
    the gradient of out flows to x, γ and β by the closed form (see the
    module docstring). ``clip`` clips var at 0 (``resnet.BatchNorm``; the
    K8 unit's primal does not)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running, momentum: float, eps: float,
                relu: bool, clip: bool, groups):
        x = x.contiguous()
        x2 = x.view(-1, x.shape[-1])
        mean, _, inv = bn_fwd_sums(x2, *running, momentum, eps, clip, groups)
        out = bn_fwd_apply(x2, mean, gamma, inv, beta, relu).view(x.shape)
        ctx.save_for_backward(x, out if relu else None, gamma, mean, inv)
        ctx.relu, ctx.groups = relu, groups
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, gamma, mean, inv = ctx.saved_tensors
        c = x.shape[-1]
        x2, g2 = x.view(-1, c), g.contiguous().view(-1, c)
        out2 = None if out is None else out.view(-1, c)
        sums = bn_bwd_sums(x2, g2, out2, mean, inv, ctx.relu)
        dx = bn_bwd_dx(x2, g2, out2, mean, inv, gamma,
                       cl.psum_over(sums, ctx.groups), ctx.relu,
                       x2.shape[0] * data_size(ctx.groups))
        return (dx.view(x.shape), sums[1], sums[0], None, None, None, None,
                None, None)
