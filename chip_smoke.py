#!/usr/bin/env python3
"""Drive the PyTorch port (kubeoperator_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device: a CUDA card must be present; prints its name and power limit
   (``nvidia-smi``) on a line of its own.
2. build: compiles the CUDA kernels from ``kubeoperator_tpu_torch/csrc``
   into ``build/torch_kernels/``; records each kernel's registers, spills
   and ptxas warnings (``kernels.ptxas_report``), and fails if a kernel of
   ``NO_SPILLS`` spills or had its ``setmaxnreg`` ignored (C7508).
3. kernels: each flash-attention kernel (K1 forward, K2 dQ, K3 dK/dV)
   against its plain PyTorch version within ``TOL``, at the LM's path
   shape (BH=128, T=2048, D=128, bf16, causal) and at a ragged non-causal
   shape (B=2, H=4, T=196 padded to 256, D=64), the backward kernels run
   twice and their outputs the same bits; so too the backward's Δ =
   rowsum(dO ∘ O) kernel (``flash_delta``) within ``DELTA_TOL``; kernel,
   plain and library (``scaled_dot_product_attention``) times by CUDA
   events, the backward pair with and without Δ beside SDPA's backward,
   and the bound at the card's own peak and HBM rate.
4. train: the main path, ``LMTrainer(cfg).measure`` at the full width of
   the bench LM (d2048, 16 heads, 4 layers, d_ff 8192, seq 2048, batch 8,
   bf16, remat dots+attn, bf16 logits), launch counts reset before and
   read after; every kernel must have launched, Δ once per dQ launch.
   kernels_packed: K4-K6 (K1-K3's kernels on the packed [B, T, H·D]
   layout) and Δ the same way, at ViT-B/16's path shape (B=128, H=12,
   T=196 padded to 256, D=64, non-causal) and at a causal one (B=2, H=4,
   T=512, D=128), both timed; the library call is
   ``scaled_dot_product_attention`` on the [B, H, T, D] transpose views
   with the key mask.
5. jobs + generate: the ``llm`` entry point with ``--sample``, then greedy
   ``generate()`` on four right-padded prompts of mixed lengths from
   trained params, checked for repeatability and against a full forward.
   serve: the serving path at the bench LM's width with those weights.
   (a) ``SlotPoolEngine(slots=16, segment=8)`` (page 16, 2,049 pages)
   behind a ``ContinuousBatcher`` fed by 8 client threads with 32
   requests from seed 0 (prompts 16-512, ``SERVE_POW2`` among them;
   ``max_tokens`` 32-128; four sampled at 0.8): every segment runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside it)
   and launches no port kernel; each sampled row equals its repeat run,
   and each of the first 8 greedy rows equals a solo ``generate()`` of
   its request or differs first at a near-tie (gap <= ``NEAR_TIE`` in the
   full forward's logits). Tokens/s, segment and admission times (CUDA
   events), TTFT from ``BatcherStats``, pool bytes and peak memory, beside
   a micro-step's bound. (b) the ``serve`` entry point
   (``jobs.build_server``) with each engine answers ``/generate`` (4
   requests on the continuous engine, 2 on the dynamic one), ``/healthz``,
   ``/stats`` and ``/metrics`` on a free local port, then shuts down.
6. vit_train: the ViT main path, ``ViTTrainer(ViTConfig()).measure`` at
   ViT-B/16's full width and depth (batch 128, 8 steps per call), launch
   counts reset before and read after: K4-K6 each at least once per layer
   and step, Δ once per K5 launch, K1-K3 never (the packed route was
   taken).
7. vit_job: the ``vit`` entry point at its default width, 2 steps of 64
   images; it builds its encoder as the JAX job does (auto attention,
   dense at 196 patches), so it must launch no flash kernel.
8. kernels_conv: K7 (``conv1x1_bwd_dx``, ``conv1x1_bwd_dw``) at all
   eight of its ResNet-50 sites (``K7_SITES``) with their launches a step
   and the launch-weighted sum, K8 (``bn_bwd_stats``, ``bn_bwd_dx``,
   ``bn_bwd_dw``) at its path record (``K8_PATH``) and at all five of its
   sites (``K8_SITES``) with their launches a step and the launch-weighted
   sum, dW twice to the same bits, and K9
   (``channel_sum``) at its probe shape, each against its plain version
   within ``CONV_TOL``/``F32_TOL``, with the rejection of outputs 10%
   wrong on the late half of the rows; kernel, plain and library times
   (for K7 one cuBLAS call per product) and the bounds.
9. resnet_train: the ResNet main path, ``Trainer(RESNET_K7_K8).measure``
   at ResNet-50's full width and depth (224², batch 128, 8 steps per
   call), launch counts reset before and read after: each K7 kernel at
   least 24 and each K8 kernel at least 9 launches per step, no flash
   kernel; then one more step records K7's shapes, which must be
   ``K7_SITES``.
10. resnet_job: the ``resnet50`` entry point at its defaults (no K7/K8, as
    the JAX job), 2 steps of 64 images: finite losses, no K7/K8 launch.
11. bitcast_probe: K9's probe, the per-channel sum of a conv output by the
    library, by K9 on the channels-last output, and by K9 after a layout
    copy.

Then the ``kernels`` line (each kernel also with the CUDA kernels behind
it and where they are defined), and last the device line the harness
reads.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import queue
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from kubeoperator_tpu_torch.workloads.train import cuda_ms  # noqa: E402
# A kernel output must meet both limits. The kernels round P and dS to bf16
# before their products and write bf16, so on an H100 a right kernel is off
# by about 0.25% in norm, and elementwise by a few bf16 steps where many
# rounded terms add up (an atol of up to 0.007 at the path shape). The norm
# limit is four times that; outputs 10% wrong on the late half of the rows
# are off by 1.7% or more, and the kernels phase shows the limits reject
# them.
TOL = {"atol": 1e-2, "rtol": 2e-2, "rel_norm": 1e-2}
LSE_TOL = {"atol": 1e-4, "rtol": 1e-5, "rel_norm": 1e-2}
# Δ (f32): each product of two bf16 values is exact in f32, so a right
# kernel differs from its plain version only in the order of the f32 sum
# over D = 64 or 128 terms, a few f32 steps of values up to about 40 (on
# an H100: at most 1.9e-6, 6e-8 in norm, at the path shapes). The limits
# are fifty and a hundred times that; a Δ 10% wrong on the late half of
# the rows is about 7% off in norm.
DELTA_TOL = {"atol": 1e-4, "rtol": 1e-5, "rel_norm": 1e-5}
# the card's f32 rate outside the tensor cores (H100 SXM data sheet), for
# Δ's operations bound
F32_FLOPS = 67e12
KERNELS = (
    ("flash_fwd", "kubeoperator_tpu/workloads/flash_attention.py:86"),
    ("flash_bwd_dq", "kubeoperator_tpu/workloads/flash_attention.py:158"),
    ("flash_bwd_dkv", "kubeoperator_tpu/workloads/flash_attention.py:186"),
)
PACKED_KERNELS = (
    ("flash_fwd_packed", "kubeoperator_tpu/workloads/flash_attention.py:295"),
    ("flash_bwd_dq_packed",
     "kubeoperator_tpu/workloads/flash_attention.py:333"),
    ("flash_bwd_dkv_packed",
     "kubeoperator_tpu/workloads/flash_attention.py:366"),
)
SOURCE = "kubeoperator_tpu_torch/csrc/flash_attention.cu"
CONV_SOURCE = "kubeoperator_tpu_torch/csrc/conv_bwd.cu"
K7_AT = "kubeoperator_tpu/workloads/conv_vjp.py:103"
K8_AT = "kubeoperator_tpu/workloads/bn_fused.py:47"
CONV_KERNELS = (("conv1x1_bwd_dx", K7_AT), ("conv1x1_bwd_dw", K7_AT),
                ("bn_bwd_stats", K8_AT), ("bn_bwd_dx", K8_AT),
                ("bn_bwd_dw", K8_AT))
K9 = ("channel_sum", "scripts/perf_bitcast_probe.py:36")
# the CUDA kernels behind each wrapper at its path shape (the kernels line
# gives where each is defined)
CUDA_KERNELS = {
    "flash_fwd": ["flash_fwd_wgmma_kernel"],
    "flash_bwd_dq": ["flash_bwd_dq_wgmma_kernel"],
    "flash_bwd_dkv": ["flash_bwd_dkv_wgmma_kernel"],
    "flash_fwd_packed": ["flash_fwd_wgmma_kernel"],
    "flash_bwd_dq_packed": ["flash_bwd_dq_wgmma_kernel"],
    "flash_bwd_dkv_packed": ["flash_bwd_dkv_wgmma_kernel"],
    "flash_delta": ["flash_delta_kernel"],
    "conv1x1_bwd_dx": ["k7_wgmma_kernel"],
    "conv1x1_bwd_dw": ["k7_wgmma_kernel", "reduce_chunks_kernel"],
    "bn_bwd_stats": ["colsum_kernel", "reduce_chunks_kernel"],
    "bn_bwd_dx": ["k8_dx_wgmma_kernel"],
    "bn_bwd_dw": ["k8_dw_wgmma_kernel", "reduce_chunks_kernel"],
    "channel_sum": ["colsum_kernel", "reduce_chunks_kernel"],
}
# the flash kernels (K1-K6) and K8's products: the build must show no
# spills and no ignored setmaxnreg (C7508) for them
NO_SPILLS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
             "flash_bwd_dkv_wgmma_kernel", "k8_dx_wgmma_kernel",
             "k8_dw_wgmma_kernel")
# Δ stands behind no TPU kernel: the JAX package leaves it to XLA
DELTA_AT = ("none: XLA-fused in _bwd and _bwd_packed "
            "(kubeoperator_tpu/workloads/flash_attention.py:231, :432)")
# K7's sites in a ResNet-50 step at batch 128, 224² (n = B·H·W, ci → co,
# launches a step): stage 1 blocks 1-3 conv1 and conv3, stage 2 block 0
# conv1, blocks 1-5 conv1, conv3, stage 3 block 0 conv1, blocks 1-2 conv1,
# conv3. The kernels line reports the site that runs 6 times.
K7_SITES = ((100352, 512, 128, 3), (100352, 128, 512, 3),
            (100352, 512, 256, 1), (25088, 1024, 256, 5),
            (25088, 256, 1024, 6), (25088, 1024, 512, 1),
            (6272, 2048, 512, 2), (6272, 512, 2048, 3))
K7_PATH = (25088, 256, 1024)
# K8's sites in the same step (n, ci → co, relu, launches a step), as
# ResNet(fused_bn=True) builds its FusedConvBN units where a block's input
# has H·W ≥ 3136: stage 0 block 0 fused1, blocks 1-2 fused1, fused3 ×3 and
# block 0's projection, stage 1 block 0 fused1 and fused3. The kernels
# line keeps K8's earlier record, 401,408 rows 64→256 with relu
# (K8_PATH), so that its times stay comparable.
K8_SITES = ((401408, 64, 64, True, 1), (401408, 256, 64, True, 2),
            (401408, 64, 256, False, 4), (401408, 256, 128, True, 1),
            (100352, 128, 512, False, 1))
K8_PATH = (401408, 64, 256, True)
# dx (bf16): a right K7/K8 rounds the same f32 sums, taken in another
# order, to bf16, so it is off by a bf16 step here and there (on an H100:
# at most 7.2e-5 in norm and an atol of 4.6e-4 at rtol 2e-2 at the path
# shapes). dW, dγ, dβ and K9's sums are f32 sums over up to 401,408 rows:
# at most 6.5e-6 in norm and an atol of 0.0093 at rtol 1e-3, with values
# up to 2,300. Each norm limit is more than ten times the measured error;
# outputs 10% wrong on the late half of the rows are about 0.07 off in norm.
CONV_TOL = {"atol": 1e-2, "rtol": 2e-2, "rel_norm": 1e-3}
F32_TOL = {"atol": 5e-2, "rtol": 1e-3, "rel_norm": 1e-4}
# serve: the request mix of phase (a), and the limit on a greedy pool row
# that differs from its solo generate(): the first differing token must be
# a near-tie in the full forward's logits, the rule phase 5 uses
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_SLOTS, SERVE_SEGMENT = 32, 8, 16, 8
SERVE_POW2 = (16, 32, 64, 128, 256, 512, 64, 256)
SERVE_SAMPLED = (5, 13, 21, 29)
NEAR_TIE = 0.05


def defined_at(source: str, kernel: str) -> str:
    """``source:line`` of the line that defines ``kernel`` (its name at the
    start of the line, or after ``__global__ void``)."""
    pat = re.compile(rf"^(?:__global__ void )?{kernel}\(")
    lines = (ROOT / source).read_text().splitlines()
    return next(f"{source}:{i}" for i, line in enumerate(lines, 1)
                if pat.match(line))


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def errors(got: torch.Tensor, want: torch.Tensor, tol: dict) -> dict:
    """How far ``got`` is from ``want``, and whether it is within ``tol``:
    |got − want| ≤ atol + rtol·|want| everywhere, and
    ‖got − want‖ / ‖want‖ ≤ rel_norm."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = {"max_abs_err": float(diff.max()),
           "max_rel_err": float(diff.max() / want.abs().max().clamp_min(1e-30)),
           "rel_norm_err": float(diff.norm() / want.norm().clamp_min(1e-30)),
           "median_abs_want": float(want.abs().median())}
    # the least atol that would pass at this rtol
    err["atol_needed"] = float((diff - tol["rtol"] * want.abs()).max())
    err["within"] = (math.isfinite(err["max_abs_err"])
                     and err["atol_needed"] <= tol["atol"]
                     and err["rel_norm_err"] <= tol["rel_norm"])
    return err


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            tol: dict = TOL) -> dict:
    err = errors(got, want, tol)
    if not err["within"]:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version beyond {tol}: {err}")
    return err


def bounds(bh: int, t: int, d: int, causal: bool,
           peak_flops: float, hbm_bytes_per_s: float,
           suffix: str = "") -> dict:
    """Least time per kernel: the larger of bytes over the card's HBM rate
    and FLOPs over the card's peak for their type, for the work these
    inputs need at their ``t`` real rows (rows past ``t``, the tile
    padding, need be neither read nor written). FLOPs count the real
    (query, key) pairs, the lower triangle when causal, at the tensor
    cores' bf16 peak; bytes count each real row of every input once and of
    every output once. The packed layout moves the same bytes (``bh`` =
    B·H heads); its kernels are named with ``suffix="_packed"``. Δ
    (``flash_delta``, one name for both layouts) reads dO and O and
    writes one f32 a row: a multiply-add per element at the f32 rate."""
    pairs = t * (t + 1) // 2 if causal else t * t
    blk, row = bh * t * d * 2, bh * t * 4       # a [BH,t,D] bf16 / [BH,t] f32
    work = {"flash_fwd" + suffix: (4 * pairs * d * bh, peak_flops,
                                   4 * blk + row),
            "flash_bwd_dq" + suffix: (6 * pairs * d * bh, peak_flops,
                                      5 * blk + 2 * row),
            "flash_bwd_dkv" + suffix: (8 * pairs * d * bh, peak_flops,
                                       6 * blk + 2 * row),
            "flash_delta": (2 * bh * t * d, F32_FLOPS, 2 * blk + row)}
    out = {}
    for name, (flops, rate, nbytes) in work.items():
        t_ops = flops / rate * 1e3
        t_bytes = nbytes / hbm_bytes_per_s * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
    return out


class Layout:
    """How ``kernel_phase`` drives one layout's three kernels: their names,
    wrappers and plain versions, the [.., T, ..] inputs, Δ (kernel and
    plain), and the [B, H, T, D] views the library call takes."""

    def __init__(self, fa, layout: str, b: int, h: int, d: int):
        self.b, self.h, self.d = b, h, d
        self.packed = layout == "packed"
        suffix = "_packed" if self.packed else ""
        self.names = [n + suffix for n in ("flash_fwd", "flash_bwd_dq",
                                           "flash_bwd_dkv")]
        self.kernels = [getattr(fa, n) for n in self.names]
        self.plains = [getattr(fa, n + "_plain") for n in self.names]
        self.heads = (h,) if self.packed else ()

    def shape(self, t: int) -> tuple:
        b, h, d = self.b, self.h, self.d
        return (b, t, h * d) if self.packed else (b * h, t, d)

    def delta(self, fa, do, o):
        """Δ as the layout's backward computes it for its kernels."""
        if self.packed:
            return fa.packed_delta(do, o, self.h)
        return fa.bh_delta(do, o)

    def delta_plain(self, fa, do, o):
        """Δ's plain version on the same layout."""
        if self.packed:
            return fa.packed_delta_plain(do, o, self.h)
        return fa.bh_delta_plain(do, o)

    def heads4(self, x):
        """[B, H, T, D] view of a kernel input (no copy)."""
        tp = x.shape[1]
        if self.packed:
            return x.view(self.b, tp, self.h, self.d).transpose(1, 2)
        return x.view(1, self.b * self.h, tp, self.d)


def kernel_phase(fa, peaks, label, b, h, t, d, causal, timed,
                 layout="bh"):
    """One layout's three kernels (K1-K3 on [B·H, T, D], or K4-K6 on the
    packed [B, T, H·D]) and its Δ against their plain versions, on inputs
    zero-padded to the tile grid when T is ragged, keys past T masked; the
    backward kernels and Δ twice, to the same bits. Also shows that the
    limits reject the plain outputs made 10% wrong on the late half of the
    rows."""
    import torch.nn.functional as F

    lay = Layout(fa, layout, b, h, d)
    fwd_k, dq_k, dkv_k = lay.kernels
    fwd_p, dq_p_fn, dkv_p_fn = lay.plains
    n_fwd, n_dq, n_dkv = lay.names
    gen = torch.Generator(device="cuda").manual_seed(1234)
    tp = fa.padded_len(t, 128, fa.TILE)
    scale, kv_len = d ** -0.5, t

    def make():
        x = torch.randn(lay.shape(t), device="cuda",
                        generator=gen).to(torch.bfloat16)
        return F.pad(x, (0, 0, 0, tp - t)).contiguous()

    q, k, v, do = make(), make(), make(), make()
    args = (*lay.heads, scale, causal, kv_len)
    o, lse = fwd_k(q, k, v, *args)
    delta = lay.delta(fa, do, o)
    dq = dq_k(q, k, v, do, lse, delta, *args)
    dk, dv = dkv_k(q, k, v, do, lse, delta, *args)
    # no kernel reduces across blocks, so a second run gives the same bits
    dq2 = dq_k(q, k, v, do, lse, delta, *args)
    dk2, dv2 = dkv_k(q, k, v, do, lse, delta, *args)
    same_bits = {"dq": torch.equal(dq, dq2), "dk": torch.equal(dk, dk2),
                 "dv": torch.equal(dv, dv2),
                 "delta": torch.equal(delta, lay.delta(fa, do, o))}
    if not all(same_bits.values()):
        raise AssertionError(f"{label}: two runs of the backward kernels "
                             f"differ: {same_bits}")
    torch.cuda.synchronize()
    o_p, lse_p = fwd_p(q, k, v, *args)
    delta_p = lay.delta_plain(fa, do, o)
    dq_p = dq_p_fn(q, k, v, do, lse, delta, *args)
    dk_p, dv_p = dkv_p_fn(q, k, v, do, lse, delta, *args)
    errs = {n_fwd: {"o": compare(f"{n_fwd} o", o, o_p),
                    "lse": compare(f"{n_fwd} lse", lse, lse_p, LSE_TOL)},
            n_dq: {"dq": compare(n_dq, dq, dq_p)},
            n_dkv: {"dk": compare(f"{n_dkv} dk", dk, dk_p),
                    "dv": compare(f"{n_dkv} dv", dv, dv_p)},
            "flash_delta": {"delta": compare("flash_delta", delta, delta_p,
                                             DELTA_TOL)}}
    late = torch.ones(tp, 1, device="cuda")
    late[tp // 2:] = 1.1
    wrong = {}
    # Δ's rows (T) are its last dim
    for what, want, tol, late_rows in (
            ("o", o_p, TOL, late), ("dq", dq_p, TOL, late),
            ("dk", dk_p, TOL, late), ("dv", dv_p, TOL, late),
            ("delta", delta_p, DELTA_TOL, late[:, 0])):
        err = errors(want * late_rows, want, tol)
        if err["within"]:
            raise AssertionError(f"the limits {tol} pass a {what} that is "
                                 f"10% wrong on the late half of the rows")
        wrong[what] = {f: err[f] for f in ("rel_norm_err", "atol_needed")}
    bnd = bounds(b * h, kv_len, d, causal, *peaks,
                 suffix="_packed" if lay.packed else "")
    result = {}
    for name in [*lay.names, "flash_delta"]:
        result[name] = {
            "max_abs_err": max(e["max_abs_err"] for e in errs[name].values()),
            "max_rel_err": max(e["max_rel_err"] for e in errs[name].values()),
            "outputs": {k: {f: e[f] for f in ("max_abs_err", "rel_norm_err",
                                              "atol_needed",
                                              "median_abs_want")}
                        for k, e in errs[name].items()},
            **bnd[name]}
    if timed:
        result[n_fwd]["ms"] = cuda_ms(lambda: fwd_k(q, k, v, *args))
        result[n_fwd]["plain_ms"] = cuda_ms(lambda: fwd_p(q, k, v, *args),
                                            n=2)
        result[n_dq]["ms"] = cuda_ms(
            lambda: dq_k(q, k, v, do, lse, delta, *args))
        result[n_dq]["plain_ms"] = cuda_ms(
            lambda: dq_p_fn(q, k, v, do, lse, delta, *args), n=2)
        result[n_dkv]["ms"] = cuda_ms(
            lambda: dkv_k(q, k, v, do, lse, delta, *args))
        result[n_dkv]["plain_ms"] = cuda_ms(
            lambda: dkv_p_fn(q, k, v, do, lse, delta, *args), n=2)
        # the library yardstick: one SDPA call on free [B, H, T, D] views
        # of the same tensors; it computes the forward kernel's function.
        # No single library call computes the dQ or dK/dV kernel alone, so
        # theirs stay null; SDPA's whole backward is timed beside the sum
        # of ours instead.
        q4, k4, v4, do4 = (lay.heads4(x) for x in (q, k, v, do))
        mask = None
        if kv_len != tp or not causal:
            keep = torch.arange(tp, device="cuda")[None, :] < kv_len
            if causal:
                keep = keep & torch.ones(tp, tp, dtype=torch.bool,
                                         device="cuda").tril()
            mask = keep.expand(tp, tp)
        sdpa_causal = causal and mask is None

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, is_causal=sdpa_causal, scale=scale)

        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, is_causal=sdpa_causal, scale=scale)
            out.backward(do4)

        fwd_ms = cuda_ms(sdpa)
        result[n_fwd]["library_ms"] = fwd_ms
        result[n_dq]["library_ms"] = None
        result[n_dkv]["library_ms"] = None
        result["sdpa_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd)
        result["sdpa_bwd_ms"] = result["sdpa_fwd_bwd_ms"] - fwd_ms
        result["ours_bwd_ms"] = result[n_dq]["ms"] + result[n_dkv]["ms"]
        # SDPA's backward includes its Δ pre-pass; ours runs Δ as its own
        # kernel, so the like-for-like sum adds it. No one PyTorch call
        # computes Δ in f32 from bf16 inputs.
        rec = result["flash_delta"]
        rec["ms"] = cuda_ms(lambda: lay.delta(fa, do, o))
        rec["plain_ms"] = cuda_ms(lambda: lay.delta_plain(fa, do, o), n=2)
        rec["library_ms"] = None
        result["delta_ms"], result["delta_plain_ms"] = (rec["ms"],
                                                        rec["plain_ms"])
        result["ours_bwd_with_delta_ms"] = (result["ours_bwd_ms"]
                                            + result["delta_ms"])
    emit({"phase": "kernels_packed" if lay.packed else "kernels",
          "shape": label, "b": b, "h": h, "t": t, "t_padded": tp, "d": d,
          "causal": causal, "tolerance": TOL, "lse_tolerance": LSE_TOL,
          "delta_tolerance": DELTA_TOL,
          "same_bits_twice": all(same_bits.values()),
          "rejected_late_10pct_wrong": wrong, **result})
    return result


def late_wrong(want: torch.Tensor) -> torch.Tensor:
    """``want`` made 10% wrong on the late half of its rows."""
    scale = torch.ones(want.shape[0], *([1] * (want.dim() - 1)),
                       device=want.device)
    scale[want.shape[0] // 2:] = 1.1
    return want * scale


def conv_bounds(n: int, ci: int, co: int, peak_flops: float,
                hbm_bytes_per_s: float) -> dict:
    """Least time for each K7/K8 kernel and for K7 and K8 whole: bytes
    (each input read once, each output written once) over the HBM rate
    against tensor-core FLOPs over the bf16 peak. x [n, ci], g and y
    [n, co], dx bf16, w bf16, dW f32, vectors f32."""
    x, g, w = 2 * n * ci, 2 * n * co, 2 * ci * co
    dw, vec, prod = 4 * ci * co, 4 * co, 2 * n * ci * co
    work = {"conv1x1_bwd_dx": (prod, g + w + x),
            "conv1x1_bwd_dw": (prod, x + g + dw),
            "K7": (2 * prod, x + g + w + x + dw),
            "bn_bwd_stats": (0, 2 * g + 4 * vec + 2 * vec),
            "bn_bwd_dx": (prod, 2 * g + w + 6 * vec + x),
            "bn_bwd_dw": (prod, x + 2 * g + 6 * vec + dw),
            "K8": (2 * prod, x + 2 * g + w + 4 * vec + x + dw + 2 * vec)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / peak_flops * 1e3
        t_bytes = nbytes / hbm_bytes_per_s * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
    return out


def conv_kernel_phase(peaks) -> dict:
    """K7 at its eight ResNet-50 sites, K8 at its five and at its path
    record, K9 at its probe shape, each CUDA kernel against its plain
    version; returns each kernel's record at its path shape (K7: 25,088
    rows 256→1024, the site that runs 6 times a step; K8: 401,408 rows
    64→256 with relu; K9: the probe's)."""
    from kubeoperator_tpu_torch import bitcast_probe as bp
    from kubeoperator_tpu_torch.workloads import bn_fused as bn
    from kubeoperator_tpu_torch.workloads import conv_vjp as cv

    gen = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(torch.bfloat16)

    def check(name, got, want, tol):
        err = compare(name, got, want, tol)
        bad = errors(late_wrong(want), want, tol)
        if bad["within"]:
            raise AssertionError(f"the limits {tol} pass a {name} that is "
                                 f"10% wrong on the late half of the rows")
        return {**{f: err[f] for f in ("max_abs_err", "rel_norm_err",
                                       "atol_needed", "median_abs_want")},
                "late_10pct_wrong_rel_norm": bad["rel_norm_err"]}

    k7, path = [], {}
    for n, ci, co, per_step in K7_SITES:
        x, g, w = rnd(n, ci), rnd(n, co), rnd(ci, co, scale=ci ** -0.5)
        dx, dw = cv.conv1x1_bwd_dx(g, w), cv.conv1x1_bwd_dw(x, g)
        torch.cuda.synchronize()
        bnd = conv_bounds(n, ci, co, *peaks)
        rec = {"kernel": "K7", "n": n, "ci": ci, "co": co,
               "launches_per_step": per_step,
               "conv1x1_bwd_dx": {**check("conv1x1_bwd_dx", dx,
                                          cv.conv1x1_bwd_dx_plain(g, w),
                                          CONV_TOL),
                                  **bnd["conv1x1_bwd_dx"]},
               "conv1x1_bwd_dw": {**check("conv1x1_bwd_dw", dw,
                                          cv.conv1x1_bwd_dw_plain(x, g),
                                          F32_TOL),
                                  **bnd["conv1x1_bwd_dw"]},
               "K7": bnd["K7"],
               "same_bits_twice": bool(torch.equal(
                   dw, cv.conv1x1_bwd_dw(x, g)))}
        if not rec["same_bits_twice"]:
            raise AssertionError("conv1x1_bwd_dw: two runs differ")
        rec["conv1x1_bwd_dx"]["ms"] = cuda_ms(lambda: cv.conv1x1_bwd_dx(g, w))
        rec["conv1x1_bwd_dx"]["plain_ms"] = cuda_ms(
            lambda: cv.conv1x1_bwd_dx_plain(g, w), n=2)
        rec["conv1x1_bwd_dw"]["ms"] = cuda_ms(lambda: cv.conv1x1_bwd_dw(x, g))
        rec["conv1x1_bwd_dw"]["plain_ms"] = cuda_ms(
            lambda: cv.conv1x1_bwd_dw_plain(x, g), n=2)
        rec["K7"]["ms"] = cuda_ms(lambda: cv.conv1x1_bwd(x, g, w))
        # one cuBLAS call each: dx's g·wᵀ is the same function; dW's xᵀ·g
        # returns bf16 where the kernel returns f32. No one call computes
        # K7 whole; the pair is its yardstick, as SDPA's whole backward is
        # for K2 + K3
        rec["conv1x1_bwd_dx"]["library_ms"] = cuda_ms(lambda: g @ w.t())
        rec["conv1x1_bwd_dw"]["library_ms"] = cuda_ms(lambda: x.t() @ g)
        rec["conv1x1_bwd_dw"]["library_returns"] = "bf16"
        rec["K7"]["cublas_pair_ms"] = cuda_ms(lambda: (g @ w.t(), x.t() @ g))
        emit({"phase": "kernels_conv", **rec})
        k7.append(rec)
        if (n, ci, co) == K7_PATH:
            path.update({k: rec[k] for k in ("conv1x1_bwd_dx",
                                             "conv1x1_bwd_dw")})
    # K7's device time a ResNet-50 step, from the eight sites and their
    # launches a step, beside the bound and cuBLAS's pair at the same sites
    weighted = {key: sum(r["launches_per_step"] * f(r) for r in k7)
                for key, f in (
                    ("ms", lambda r: r["conv1x1_bwd_dx"]["ms"]
                     + r["conv1x1_bwd_dw"]["ms"]),
                    ("bound_ms", lambda r: r["K7"]["bound_ms"]),
                    ("cublas_pair_ms", lambda r: r["K7"]["cublas_pair_ms"]))}
    emit({"phase": "kernels_conv", "kernel": "K7", "per_step": weighted,
          "launches_per_step": sum(r["launches_per_step"] for r in k7)})

    # K8: its path record (K8_PATH), then the five sites of a ResNet-50
    # step with their launches
    k8 = []
    for n, ci, co, relu, per_step in ((*K8_PATH, 0), *K8_SITES):
        x, g, w = rnd(n, ci), rnd(n, co), rnd(ci, co, scale=ci ** -0.5)
        y = (x.float() @ w.float()).to(torch.bfloat16)
        yf = y.float()
        mu = yf.mean(0)
        inv = torch.rsqrt((yf * yf).mean(0) - mu * mu + 1e-5)
        gamma = torch.linspace(0.5, 1.5, co, device="cuda")
        beta = torch.linspace(-0.3, 0.3, co, device="cuda")
        vecs = (gamma, beta, mu, inv)
        sums = bn.bn_bwd_stats(g, y, *vecs, relu)
        sums_p = bn.bn_bwd_stats_plain(g, y, *vecs, relu)
        dx = bn.bn_bwd_dx(g, y, w, *vecs, sums_p, relu)
        dw = bn.bn_bwd_dw(x, g, y, *vecs, sums_p, relu)
        torch.cuda.synchronize()
        bnd = conv_bounds(n, ci, co, *peaks)
        # phase 1 is held against its plain version on the same sums, so
        # that the check sees the products and not the sums' order
        rec = {"kernel": "K8", "n": n, "ci": ci, "co": co, "relu": relu,
               "launches_per_step": per_step,
               "bn_bwd_stats": {**check("bn_bwd_stats", sums.t(),
                                        sums_p.t(), F32_TOL),
                                **bnd["bn_bwd_stats"]},
               "bn_bwd_dx": {**check("bn_bwd_dx", dx, bn.bn_bwd_dx_plain(
                   g, y, w, *vecs, sums_p, relu), CONV_TOL),
                   **bnd["bn_bwd_dx"]},
               "bn_bwd_dw": {**check("bn_bwd_dw", dw, bn.bn_bwd_dw_plain(
                   x, g, y, *vecs, sums_p, relu), F32_TOL),
                   **bnd["bn_bwd_dw"]},
               "K8": bnd["K8"],
               "same_bits_twice": bool(torch.equal(
                   dw, bn.bn_bwd_dw(x, g, y, *vecs, sums_p, relu)))}
        if not rec["same_bits_twice"]:
            raise AssertionError("bn_bwd_dw: two runs differ")
        rec["bn_bwd_stats"]["ms"] = cuda_ms(
            lambda: bn.bn_bwd_stats(g, y, *vecs, relu))
        rec["bn_bwd_dx"]["ms"] = cuda_ms(
            lambda: bn.bn_bwd_dx(g, y, w, *vecs, sums, relu))
        rec["bn_bwd_dw"]["ms"] = cuda_ms(
            lambda: bn.bn_bwd_dw(x, g, y, *vecs, sums, relu))
        rec["K8"]["ms"] = cuda_ms(
            lambda: bn.conv_bn_relu_bwd(x, g, y, w, *vecs, relu))
        # two phases read g and y twice: the least a two-phase design needs
        rec["K8"]["two_phase_bound_ms"] = (
            rec["K8"]["bytes"] + 2 * 2 * n * co) / peaks[1] * 1e3
        if not per_step:
            rec["bn_bwd_stats"]["plain_ms"] = cuda_ms(
                lambda: bn.bn_bwd_stats_plain(g, y, *vecs, relu), n=2)
            rec["bn_bwd_dx"]["plain_ms"] = cuda_ms(
                lambda: bn.bn_bwd_dx_plain(g, y, w, *vecs, sums, relu), n=2)
            rec["bn_bwd_dw"]["plain_ms"] = cuda_ms(
                lambda: bn.bn_bwd_dw_plain(x, g, y, *vecs, sums, relu), n=2)
            # the unfused composition is K8's plain version; no library
            # call computes it
            rec["K8"]["plain_ms"] = cuda_ms(
                lambda: bn.conv_bn_relu_bwd_plain(x, g, y, w, *vecs, relu),
                n=2)
            for k in ("bn_bwd_stats", "bn_bwd_dx", "bn_bwd_dw"):
                rec[k]["library_ms"] = None
            path.update({k: rec[k] for k in ("bn_bwd_stats", "bn_bwd_dx",
                                             "bn_bwd_dw")})
        else:
            k8.append(rec)
        emit({"phase": "kernels_conv", **rec})
    # K8's device time a ResNet-50 step, from its five sites and their
    # launches a step, beside the bound
    weighted = {key: sum(r["launches_per_step"] * f(r) for r in k8)
                for key, f in (
                    ("ms", lambda r: r["bn_bwd_dx"]["ms"]
                     + r["bn_bwd_dw"]["ms"]),
                    ("bound_ms", lambda r: r["bn_bwd_dx"]["bound_ms"]
                     + r["bn_bwd_dw"]["bound_ms"]),
                    ("unit_ms", lambda r: r["K8"]["ms"]),
                    ("unit_bound_ms", lambda r: r["K8"]["bound_ms"]))}
    emit({"phase": "kernels_conv", "kernel": "K8", "per_step": weighted,
          "launches_per_step": sum(r["launches_per_step"] for r in k8)})

    b, h, wd, _, co = bp.SHAPE
    n = b * h * wd
    y = rnd(n, co)
    got = bp.channel_sum(y)
    torch.cuda.synchronize()
    t_bytes = (2 * n * co + 4 * co) / peaks[1] * 1e3
    rec = {**check("channel_sum", got[:, None],
                   bp.channel_sum_plain(y)[:, None], F32_TOL),
           "bound_ms": t_bytes, "bound_by": "bytes",
           "ms": cuda_ms(lambda: bp.channel_sum(y)),
           "plain_ms": cuda_ms(lambda: bp.channel_sum_plain(y), n=2),
           "library_ms": cuda_ms(
               lambda: y.view(b, h, wd, co).sum((0, 1, 2),
                                                dtype=torch.float32))}
    emit({"phase": "kernels_conv", "kernel": "K9", "n": n, "c": co,
          "channel_sum": rec, "tolerance": CONV_TOL, "f32_tolerance": F32_TOL})
    path["channel_sum"] = rec
    return path


def port_launches() -> dict:
    """Every port kernel's launch count."""
    from kubeoperator_tpu_torch import bitcast_probe as bp
    from kubeoperator_tpu_torch.workloads import bn_fused, conv_vjp
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    return {**fa.LAUNCHES, **conv_vjp.LAUNCHES, **bn_fused.LAUNCHES,
            **bp.LAUNCHES}


def reset_port_launches() -> None:
    from kubeoperator_tpu_torch import bitcast_probe as bp
    from kubeoperator_tpu_torch.workloads import bn_fused, conv_vjp
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    for mod in (fa, conv_vjp, bn_fused, bp):
        mod.reset_launches()


def serve_requests(vocab: int) -> list[tuple[list[int], int, float, int]]:
    """(prompt, max_tokens, temperature, seed) of phase (a)'s requests,
    from seed 0: prompts of 16-512 tokens, every fourth a power of two,
    32-128 new tokens, ``SERVE_SAMPLED`` at temperature 0.8."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 513, SERVE_REQUESTS)
    lens[::4] = SERVE_POW2
    mts = rng.integers(32, 129, SERVE_REQUESTS)
    return [(rng.integers(0, vocab, int(n)).tolist(), int(mt),
             0.8 if i in SERVE_SAMPLED else 0.0, i)
            for i, (n, mt) in enumerate(zip(lens, mts))]


def run_clients(submit, reqs: list, clients: int) -> dict:
    """Each request through ``submit`` from ``clients`` threads that take
    the next request as they finish one; {index: tokens}. Raises the
    first error a client met."""
    todo: queue.Queue = queue.Queue()
    for i in range(len(reqs)):
        todo.put(i)
    results, failures = {}, []

    def client():
        while True:
            try:
                i = todo.get_nowait()
            except queue.Empty:
                return
            prompt, mt, temp, seed = reqs[i]
            try:
                results[i] = submit(prompt, mt, temperature=temp, seed=seed,
                                    timeout=600.0)
            except Exception as e:  # noqa: BLE001 — re-raised below
                failures.append(e)
                return

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900.0)
        if t.is_alive():
            raise AssertionError("serve: a client thread did not finish")
    if failures:
        raise failures[0]
    if len(results) != len(reqs):
        raise AssertionError(f"serve: {len(results)} of {len(reqs)} "
                             f"requests answered")
    return results


def serve_engine_phase(cfg, model, smi: str, hbm: float) -> dict:
    """Phase (a): the slot pool behind the continuous batcher."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.serving import (
        BatcherStats, ContinuousBatcher,
    )

    reqs = serve_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                            segment=SERVE_SEGMENT)
    seg_events, admit_events = [], []
    run_segment, admit = engine.run_segment, engine.admit

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def checked_segment():
        # a segment only enqueues work: any host sync inside it raises
        start, end = events()
        start.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_segment()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.record()
        seg_events.append((start, end))

    def timed_admit(entries):
        start, end = events()
        start.record()
        out = admit(entries)
        end.record()
        admit_events.append((start, end, len(entries)))
        return out

    engine.run_segment, engine.admit = checked_segment, timed_admit
    stats = BatcherStats()
    batcher = ContinuousBatcher(engine, stats=stats)
    reset_port_launches()
    t0 = time.perf_counter()
    results = run_clients(batcher.submit, reqs, SERVE_CLIENTS)
    wall = time.perf_counter() - t0
    launches = port_launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    seg_ms = [a.elapsed_time(b) for a, b in seg_events]
    admit_ms = [a.elapsed_time(b) for a, b, _ in admit_events]
    if any(launches.values()):
        raise AssertionError(f"serve: the segments launched port kernels: "
                             f"{launches}")
    for i, (prompt, mt, _, _) in enumerate(reqs):
        row = results[i]
        if len(row) != len(prompt) + mt or row[:len(prompt)] != prompt:
            raise AssertionError(f"serve: request {i} came back malformed")
        if not all(0 <= t < cfg.vocab_size for t in row):
            raise AssertionError(f"serve: request {i} left the vocabulary")

    snapshot = stats.snapshot()
    ttft = (stats.ttft_quantile(0.5), stats.ttft_quantile(0.95),
            stats.ttft_mean())
    # sampled rows: a repeat run, with other neighbours, draws the same
    sampled = [reqs[i] for i in SERVE_SAMPLED]
    again = run_clients(batcher.submit, sampled, len(sampled))
    for j, i in enumerate(SERVE_SAMPLED):
        if again[j] != results[i]:
            raise AssertionError(f"serve: sampled request {i} differs from "
                                 f"its repeat run")

    # the first 8 greedy rows against a solo generate() of each request
    greedy = [i for i in range(SERVE_REQUESTS) if reqs[i][2] == 0.0][:8]
    near_ties, checks = 0, []
    with torch.no_grad():
        for i in greedy:
            prompt, mt, _, _ = reqs[i]
            want = generate(cfg, model, [prompt], mt)[0].tolist()
            got = results[i]
            j = next((k for k, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
            rec = {"request": i, "prompt_len": len(prompt), "max_tokens": mt,
                   "equal": j is None}
            if j is not None:
                logits = model(torch.as_tensor([want[:j]],
                                               device=model.embedding.device)
                               )[0, -1].float()
                gap = abs(float(logits[got[j]] - logits[want[j]]))
                rec.update(first_diff=j, logit_gap=gap)
                if gap > NEAR_TIE:
                    raise AssertionError(f"serve: greedy request {i} differs "
                                         f"from solo generate() at {j} with "
                                         f"a logit gap of {gap}")
                near_ties += 1
            checks.append(rec)

    weight_bytes = 2 * sum(p.numel() for p in model.parameters())
    tokens = sum(mt for _, mt, _, _ in reqs)
    step_ms = statistics.median(seg_ms) / SERVE_SEGMENT
    rec = {"phase": "serve_engine", "nvidia_smi": smi,
           "config": {**dataclasses.asdict(cfg), "dtype": str(cfg.dtype)},
           "slots": SERVE_SLOTS, "segment": SERVE_SEGMENT,
           "page": engine.page, "pages": engine.pages,
           "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
           "prompt_lens": [len(r[0]) for r in reqs],
           "max_tokens": [r[1] for r in reqs],
           "sampled": list(SERVE_SAMPLED), "launches": launches,
           "sync_debug_mode": "error", "segments": len(seg_ms),
           "generated_tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "segment_ms_median": statistics.median(seg_ms),
           "segment_ms_p10_p90": [float(np.percentile(seg_ms, 10)),
                                  float(np.percentile(seg_ms, 90))],
           "micro_step_ms": step_ms,
           "admission_waves": len(admit_ms),
           "admission_ms_median": statistics.median(admit_ms),
           "admission_ms_per_wave": [[round(ms, 3), k] for ms, (_, _, k)
                                     in zip(admit_ms, admit_events)],
           "ttft_p50_s": ttft[0], "ttft_p95_s": ttft[1],
           "ttft_mean_s": ttft[2], "stats": snapshot,
           "pool_bytes": engine.pool_bytes,
           "max_memory_allocated": peak,
           "weight_bytes_bf16": weight_bytes,
           "micro_step_bound_ms_weights": weight_bytes / hbm * 1e3,
           "micro_step_bound_ms_weights_full_kv":
               (weight_bytes + engine.pool_bytes) / hbm * 1e3,
           "greedy_vs_solo": checks, "near_tie_rows": near_ties}
    emit(rec)
    return rec


def http_call(url: str, body: dict | None = None) -> tuple[int, str]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read().decode()


def serve_http_phase(cfg, jobs) -> dict:
    """Phase (b): the serve entry point with each engine, on a free local
    port, at the bench LM's widths (fresh weights)."""
    widths = ["--vocab", str(cfg.vocab_size), "--d-model", str(cfg.d_model),
              "--heads", str(cfg.n_heads), "--layers", str(cfg.n_layers),
              "--d-ff", str(cfg.d_ff), "--max-seq-len", str(cfg.max_seq_len),
              "--host", "127.0.0.1", "--port", "0"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 33, 64, 100)]
    out = {}
    for engine, n in (("continuous", 4), ("dynamic", 2)):
        args = jobs.build_parser().parse_args(["serve", "--engine", engine,
                                               *widths])
        t0 = time.perf_counter()
        server, batcher = jobs.build_server(args)
        up_s = time.perf_counter() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            t0 = time.perf_counter()
            replies = run_clients(
                lambda p, mt, **kw: http_call(url + "/generate", {
                    "prompt_ids": p, "max_tokens": mt,
                    "temperature": kw["temperature"], "seed": kw["seed"]}),
                [(p, 12, 0.0, 0) for p in prompts[:n]], n)
            answer_s = time.perf_counter() - t0
            for i, (status, body) in replies.items():
                reply = json.loads(body)
                if (status != 200 or reply["tokens"][:len(prompts[i])]
                        != prompts[i] or len(reply["new_tokens"]) != 12):
                    raise AssertionError(f"serve {engine}: bad reply {i}: "
                                         f"{status} {body[:200]}")
            health = http_call(url + "/healthz")
            stats = json.loads(http_call(url + "/stats")[1])
            metrics = http_call(url + "/metrics")[1]
            if health[0] != 200 or stats["requests_total"] != n:
                raise AssertionError(f"serve {engine}: healthz {health}, "
                                     f"stats {stats}")
            if f"ko_serve_requests_total {n}" not in metrics:
                raise AssertionError(f"serve {engine}: /metrics lacks "
                                     f"ko_serve_requests_total {n}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        out[engine] = {"requests": n, "build_s": up_s, "answer_s": answer_s,
                       "new_tokens": [json.loads(b)["new_tokens"]
                                      for _, b in replies.values()],
                       "stats": stats}
    emit({"phase": "serve_http", **out})
    return out


def main() -> int:
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on the card and has no CPU mode")
    from kubeoperator_tpu_torch import kernels
    from kubeoperator_tpu_torch.profile_lm import BENCH_LM as cfg
    from kubeoperator_tpu_torch.train import jobs
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer
    from kubeoperator_tpu_torch.workloads.train import (
        peak_flops_per_chip, peak_hbm_bytes_per_chip)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    log = kernels.build_all()
    ptxas = {n: kernels.ptxas_report(v["ptxas"]) for n, v in log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: {"seconds": v["seconds"], "cached": v["cached"]}
                        for n, v in log.items()},
          "ptxas": ptxas})
    for kname, rep in ((k, r) for lib in ptxas.values()
                       for k, r in lib.items()):
        if kname.split("<")[0] in NO_SPILLS and (
                rep.get("spill_stores") or rep.get("spill_loads")
                or any("C7508" in w for w in rep["warnings"])):
            raise AssertionError(f"build: {kname} spills or ignores "
                                 f"setmaxnreg: {rep}")

    # -- 3. kernels against their plain versions -----------------------------
    peaks = (peak_flops_per_chip(), peak_hbm_bytes_per_chip())
    path = kernel_phase(fa, peaks, "path", 8, 16, 2048, 128, True, timed=True)
    kernel_phase(fa, peaks, "ragged", 2, 4, 196, 64, False, timed=False)
    # K4-K6 at ViT-B/16's path shape, then causal at D=128 (the hi/lo loop
    # bounds on the packed addressing)
    vit_path = kernel_phase(fa, peaks, "vit_path", 128, 12, 196, 64, False,
                            timed=True, layout="packed")
    kernel_phase(fa, peaks, "causal_d128", 2, 4, 512, 128, True,
                 timed=True, layout="packed")

    # -- 4. main path: train -------------------------------------------------
    steps, warmup, repeats = 3, 2, 3
    fa.reset_launches()
    m = LMTrainer(cfg).measure(batch=8, seq_len=2048, steps=steps,
                               warmup=warmup, repeats=repeats)
    train_launches = dict(fa.LAUNCHES)
    total_steps = warmup + steps * repeats
    emit({"phase": "train",
          "config": {**dataclasses.asdict(cfg), "dtype": str(cfg.dtype)},
          "peak_flops": peaks[0], "hbm_bytes_per_s": peaks[1],
          "batch": 8, "seq_len": 2048, "steps_run": total_steps,
          "launches": train_launches, "nvidia_smi": smi,
          **{k: v for k, v in m.items() if k != "step_stats"},
          "step_stats": m["step_stats"]})
    if not math.isfinite(m["final_loss"]):
        raise AssertionError(f"train: loss not finite ({m['final_loss']})")
    for kname, _ in KERNELS:
        if train_launches[kname] < cfg.n_layers * total_steps:
            raise AssertionError(f"train: {kname} launched "
                                 f"{train_launches[kname]} times, expected "
                                 f">= {cfg.n_layers * total_steps}")
    if train_launches["flash_delta"] != train_launches["flash_bwd_dq"]:
        raise AssertionError(f"train: flash_delta launched "
                             f"{train_launches['flash_delta']} times, not "
                             f"once per dQ launch")

    # -- 5. main path: the llm entry point, then greedy generate -------------
    fa.reset_launches()
    rc = jobs.main(["llm", "--steps", "2", "--d-model", str(cfg.d_model),
                    "--heads", str(cfg.n_heads), "--layers",
                    str(cfg.n_layers), "--d-ff", str(cfg.d_ff), "--seq-len",
                    str(cfg.max_seq_len), "--batch", "8", "--sample", "16"])
    if rc != 0:
        raise AssertionError(f"jobs llm returned {rc}")
    jobs_launches = dict(fa.LAUNCHES)
    if min(jobs_launches[kname] for kname, _ in KERNELS) == 0:
        raise AssertionError(f"jobs llm: a kernel never launched: "
                             f"{jobs_launches}")

    lt = LMTrainer(cfg)
    state = lt.init_state(seed=1)
    toks = lt.synthetic_batch(8, 2048, seed=1)
    for _ in range(2):
        state, metrics = lt.train_step(state, toks)
    model = state["model"]
    lens = [7, 3, 5, 2]
    prompt = np.zeros((4, max(lens)), dtype=np.int64)
    src = toks[:4].cpu().numpy()
    for r, n in enumerate(lens):
        prompt[r, :n] = src[r, :n]
    t0 = time.perf_counter()
    out = generate(cfg, model, prompt, max_new_tokens=8, prompt_lens=lens,
                   prefill_len=2)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    again = generate(cfg, model, prompt, max_new_tokens=8, prompt_lens=lens,
                     prefill_len=2)
    if not torch.equal(out, again):
        raise AssertionError("generate: a repeat run gave other tokens")
    # the first new token of each row against a full (non-decode) forward
    # over that row's prompt. bf16 decode and full forward round in other
    # places, so a differing token must be a near-tie there (gap <= 0.05)
    first = []
    with torch.no_grad():
        for r, n in enumerate(lens):
            logits = model(out[r:r + 1, :n])[0, -1].float()
            want, got = int(logits.argmax()), int(out[r, n])
            gap = float(logits[want] - logits[got])
            first.append({"row": r, "prompt_len": n, "token": got,
                          "full_forward_argmax": want, "logit_gap": gap})
            if got != want and gap > 0.05:
                raise AssertionError(f"generate row {r}: token {got} but the "
                                     f"full forward's argmax is {want} "
                                     f"(gap {gap})")
    if not all(0 <= x < cfg.vocab_size for x in out.flatten().tolist()):
        raise AssertionError("generate: token outside the vocabulary")
    main_launches = dict(fa.LAUNCHES)
    emit({"phase": "jobs_generate", "jobs_launches": jobs_launches,
          "launches": main_launches, "train_loss": float(metrics["loss"]),
          "generate_seconds": gen_s, "tokens": out.tolist(),
          "first_token_check": first,
          "exact_first_tokens": sum(f["token"] == f["full_forward_argmax"]
                                    for f in first)})

    # -- 5b. serve: the slot pool with phase 5's weights, then the entry point
    serve_engine_phase(cfg, model, smi, peaks[1])
    serve_http_phase(cfg, jobs)

    # -- 6. main path: ViT-B/16 training on the packed kernels ---------------
    vcfg = ViTConfig()
    v_steps, v_warmup, v_repeats, per_call, v_batch = 4, 2, 3, 8, 128
    fa.reset_launches()
    vm = ViTTrainer(vcfg).measure(batch=v_batch, steps=v_steps,
                                  warmup=v_warmup, steps_per_call=per_call,
                                  repeats=v_repeats)
    vit_launches = dict(fa.LAUNCHES)
    v_total = (v_warmup + v_steps * v_repeats) * per_call
    enc = vcfg.encoder
    emit({"phase": "vit_train",
          "config": {"num_classes": vcfg.num_classes,
                     "image_size": vcfg.image_size, "patch": vcfg.patch,
                     "encoder": {**dataclasses.asdict(enc),
                                 "dtype": str(enc.dtype)}},
          "batch": v_batch, "steps_per_call": per_call, "steps_run": v_total,
          "launches": vit_launches, "nvidia_smi": smi,
          **{k: v for k, v in vm.items() if k != "step_stats"},
          "step_stats": vm["step_stats"]})
    if not math.isfinite(vm["final_loss"]):
        raise AssertionError(f"vit_train: loss not finite "
                             f"({vm['final_loss']})")
    for kname, _ in PACKED_KERNELS:
        if vit_launches[kname] < enc.n_layers * v_total:
            raise AssertionError(f"vit_train: {kname} launched "
                                 f"{vit_launches[kname]} times, expected "
                                 f">= {enc.n_layers * v_total}")
    for kname, _ in KERNELS:
        if vit_launches[kname]:
            raise AssertionError(f"vit_train: {kname} launched "
                                 f"{vit_launches[kname]} times; the packed "
                                 f"route launches none of K1-K3")
    if vit_launches["flash_delta"] != vit_launches["flash_bwd_dq_packed"]:
        raise AssertionError(f"vit_train: flash_delta launched "
                             f"{vit_launches['flash_delta']} times, not "
                             f"once per K5 launch")

    # -- 7. the vit entry point at its default width --------------------------
    fa.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jobs.main(["vit", "--steps", "2", "--batch-per-chip", "64"])
    print(out.getvalue(), end="", flush=True)
    if rc != 0:
        raise AssertionError(f"jobs vit returned {rc}")
    records = [json.loads(line) for line in out.getvalue().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"jobs vit: losses {losses}")
    if not records[-1].get("done"):
        raise AssertionError("jobs vit: no done record")
    vit_job_launches = dict(fa.LAUNCHES)
    if any(vit_job_launches.values()):
        raise AssertionError(f"jobs vit: auto attention at 196 patches is "
                             f"dense, yet flash kernels launched: "
                             f"{vit_job_launches}")
    emit({"phase": "vit_job", "losses": losses,
          "img_per_sec": records[-1]["img_per_sec"],
          "launches": vit_job_launches})

    # -- 8. K7, K8 and K9 against their plain versions ---------------------
    from kubeoperator_tpu_torch import bitcast_probe as bp
    from kubeoperator_tpu_torch.profile_lm import RESNET_K7_K8 as rcfg
    from kubeoperator_tpu_torch.workloads import bn_fused, conv_vjp
    from kubeoperator_tpu_torch.workloads.train import Trainer

    conv_path = conv_kernel_phase(peaks)

    def conv_launches():
        return {**conv_vjp.LAUNCHES, **bn_fused.LAUNCHES}

    def reset_conv():
        conv_vjp.reset_launches()
        bn_fused.reset_launches()

    # -- 9. main path: ResNet-50 training on K7 and K8 ----------------------
    r_steps, r_warmup, r_repeats, r_per_call = 4, 2, 3, 8
    fa.reset_launches()
    reset_conv()
    trainer = Trainer(rcfg)
    rm = trainer.measure(batch=rcfg.batch_size, steps=r_steps,
                         warmup=r_warmup, steps_per_call=r_per_call,
                         repeats=r_repeats)
    resnet_launches = conv_launches()
    r_total = (r_warmup + r_steps * r_repeats) * r_per_call
    emit({"phase": "resnet_train",
          "config": {**dataclasses.asdict(rcfg), "dtype": str(rcfg.dtype)},
          "flops_per_step": trainer.flops_per_step(),
          "steps_per_call": r_per_call,
          "steps_run": r_total, "launches": resnet_launches,
          "flash_launches": dict(fa.LAUNCHES), "nvidia_smi": smi,
          **{k: v for k, v in rm.items() if k != "step_stats"},
          "step_stats": rm["step_stats"]})
    if not math.isfinite(rm["final_loss"]):
        raise AssertionError(f"resnet_train: loss not finite "
                             f"({rm['final_loss']})")
    per_step = {"conv1x1_bwd_dx": 24, "conv1x1_bwd_dw": 24,
                "bn_bwd_stats": 9, "bn_bwd_dx": 9, "bn_bwd_dw": 9}
    for kname, want in per_step.items():
        if resnet_launches[kname] < want * r_total:
            raise AssertionError(f"resnet_train: {kname} launched "
                                 f"{resnet_launches[kname]} times, expected "
                                 f">= {want * r_total}")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"resnet_train: flash kernels launched: "
                             f"{fa.LAUNCHES}")
    # K7's shapes in one more step, against the sites kernels_conv times
    sites = collections.Counter()
    k7_call = conv_vjp.conv1x1_bwd

    def recording(x2, g2, w):
        sites[(x2.shape[0], x2.shape[1], g2.shape[1])] += 1
        return k7_call(x2, g2, w)

    conv_vjp.conv1x1_bwd = recording
    try:
        trainer.train_step(trainer.init_state(),
                           *trainer.synthetic_batch(rcfg.batch_size))
        torch.cuda.synchronize()
    finally:
        conv_vjp.conv1x1_bwd = k7_call
    want_sites = {(n, ci, co): k for n, ci, co, k in K7_SITES}
    emit({"phase": "resnet_k7_sites",
          "sites": [[*key, k] for key, k in sorted(sites.items())]})
    if dict(sites) != want_sites:
        raise AssertionError(f"resnet_train: K7 ran at {dict(sites)}, not "
                             f"at the sites kernels_conv times")

    # -- 10. the resnet50 entry point at its defaults -----------------------
    reset_conv()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jobs.main(["resnet50", "--steps", "2", "--batch-per-chip", "64"])
    print(out.getvalue(), end="", flush=True)
    if rc != 0:
        raise AssertionError(f"jobs resnet50 returned {rc}")
    records = [json.loads(line) for line in out.getvalue().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"jobs resnet50: losses {losses}")
    if not records[-1].get("done"):
        raise AssertionError("jobs resnet50: no done record")
    job_launches = conv_launches()
    if any(job_launches.values()):
        raise AssertionError(f"jobs resnet50: the JAX job's config runs no "
                             f"K7/K8, yet they launched: {job_launches}")
    emit({"phase": "resnet_job", "losses": losses,
          "img_per_sec": records[-1]["img_per_sec"],
          "launches": job_launches})

    # -- 11. K9's probe -----------------------------------------------------
    bp.reset_launches()
    probe = bp.probe()
    probe_launches = dict(bp.LAUNCHES)
    emit({"phase": "bitcast_probe", **probe, "launches": probe_launches})
    for variant in ("kernel_nhwc", "kernel_after_copy", "library"):
        err = probe[variant]
        if not err["max_abs_err"] <= 1e-5 * err["max_abs_want"] + 1e-2:
            raise AssertionError(f"bitcast_probe {variant}: {err}")

    # -- the kernels line and the device line --------------------------------
    # each kernel with its own main path's launches and its own path shape;
    # Δ with ViT's (the LM path launches it as often as K2)
    main_runs = ([(k, w, SOURCE, train_launches, path[k]) for k, w in KERNELS]
                 + [(k, w, SOURCE, vit_launches, vit_path[k])
                    for k, w in PACKED_KERNELS]
                 + [("flash_delta", DELTA_AT, SOURCE, vit_launches,
                     vit_path["flash_delta"])]
                 + [(k, w, CONV_SOURCE, resnet_launches, conv_path[k])
                    for k, w in CONV_KERNELS]
                 + [(K9[0], K9[1], CONV_SOURCE, probe_launches,
                     conv_path[K9[0]])])
    emit({"kernels": [
        {"name": kname, "route": "cuda", "source": source, "replaces": where,
         "launches": launches[kname], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "cuda_kernels": {k: defined_at(source, k)
                          for k in CUDA_KERNELS[kname]}}
        for kname, where, source, launches, r in main_runs]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
