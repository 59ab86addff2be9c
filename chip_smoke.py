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
   shape (BH=128, T=2048, D=128, bf16, causal), at a ragged non-causal
   shape (B=2, H=4, T=196 padded to 256, D=64) and at the bench's LM 4k
   and 8k points (B=4, H=16, T=4096 and B=2, H=16, T=8192; D=128,
   causal), the backward kernels run
   twice and their outputs the same bits; so too the backward's Δ =
   rowsum(dO ∘ O) kernel (``flash_delta``) within ``DELTA_TOL``; kernel,
   plain and library (``scaled_dot_product_attention``) times by CUDA
   events, the backward pair with and without Δ beside SDPA's backward,
   and the bound at the card's own peak and HBM rate.
4. train: the main path, ``LMTrainer(cfg).measure`` at the full width of
   the bench LM (d2048, 16 heads, 4 layers, d_ff 8192, seq 2048, batch 8,
   bf16, remat dots+attn, bf16 logits) with the bench's settings for that
   point (3 repeats of 6 steps after 2), launch counts reset before and
   read after; every kernel must have launched, Δ once per dQ launch.
   kernels_packed: K4-K6 (K1-K3's kernels on the packed [B, T, H·D]
   layout) and Δ the same way, at ViT-B/16's path shape (B=128, H=12,
   T=196 padded to 256, D=64, non-causal) and at a causal one (B=2, H=4,
   T=512, D=128), both timed; the library call is
   ``scaled_dot_product_attention`` on the [B, H, T, D] transpose views
   with the key mask.
   moe_train: the MoE LM's main path, ``LMTrainer(BENCH_MOE).measure``:
   the bench LM with 8 experts, top-2, capacity factor 1.25 in every
   layer (``profile_lm.BENCH_MOE``, 1.74 B params), 2 repeats of 3 steps
   after 2 warm-up steps; K1-K3 each at least once a layer and step, Δ
   once per dQ launch, the loss (aux included) finite; step ms, tokens/s,
   MFU by the MoE ``flops_per_token``, peak memory and the aux share of
   the loss.
5. jobs + generate: the ``llm`` entry point with ``--sample``, then greedy
   ``generate()`` on four right-padded prompts of mixed lengths from
   trained params, checked for repeatability and against a full forward.
   jobs_llm_moe: the ``llm`` entry point with ``--experts 8 --steps 2
   --sample 16`` at those widths; every flash kernel and Δ launched.
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
   a micro-step's bound. (c) serve_prefix: 32 requests from seed 1 whose
   prompts all open with one 512-token system prompt that a first request
   cached (4 full hits with copy-on-write, 14 cover hits, 14 partial
   hits), then the same requests with that prefix replaced by random
   tokens of their own (no hit): hit kinds, hit and copy-on-write
   counters, peak pages in use, admission ms a wave, TTFT, tokens/s,
   segment ms, the cached pages unchanged after their sharers wrote, and
   greedy hit rows of each kind against the same requests admitted cold
   (near-tie rule). (d) serve_kv_quant: int8 pages at the bf16 pool's
   byte budget (3,973 pages) under phase (a)'s traffic, then 16 greedy
   requests in bf16, int8 and fp8 engines: int8's ``debug_logits``
   within ``LOGIT_TOLERANCE`` of bf16's, fp8's distance reported. (e)
   serve_spill, bf16 and int8: 4 slots, 101 pages (four live requests
   and one 16-page prefix), ``SPILL_PAGES`` of host tier, 8 prefixes of
   256 tokens cycled twice: demotions and promoted hits, each promotion's
   pages equal to the demoted bits, promotion ms against a 256-token
   prefill, pinned host bytes, rows against a cold one-wave run (near-tie
   rule, plus the declared tolerance for int8). (f) serve_spec: phase
   (a)'s traffic on ``SlotPoolEngine(slots=16, segment=8, spec_k=4,
   draft_layers=1)``: every dispatch under sync-debug "error" and
   launching no port kernel, the batcher's spec counters equal to the
   engine's, each sampled row equal to its repeat run, each greedy row
   equal to phase (a)'s row or first different at a near-tie; acceptance
   ratio, tokens/s beside phase (a)'s, dispatch ms. (g) serve_moe: the MoE
   LM trained 2 steps from seed 1 behind phase (a)'s engine shape and
   traffic: no sync, no port kernel, ``expert_load().sum()`` equal to
   slots × top_k × layers × micro-steps and its gauges on /metrics, the
   sampled rows equal to their repeats, the power-of-two greedy rows equal
   to solo ``generate()`` or first different at a near-tie of the solo
   decode's logits; tokens/s and micro-step ms. (b) the ``serve`` entry
   point (``jobs.build_server``) with each engine, and the continuous one
   again with ``--kv-dtype int8 --spill-pages 64``, with ``--spec-k 4
   --draft-layers 1`` and with ``--moe 8``, answers ``/generate`` (4
   requests on a continuous engine, 2 on the dynamic one), ``/healthz``,
   ``/stats`` and ``/metrics`` (the spec and MoE families included) on a
   free local port, then shuts down. (h) serve_cluster: the cluster tier
   with phase 5's weights: phase (a)'s traffic behind one batcher with the
   serve tracer off, on, on, off (tokens/s); then two
   ``SlotPoolEngine(slots=16, segment=8)`` replicas and a third engine
   behind a ``PrefillWorker``, all behind one traced ``ServeGateway``
   (sticky prefix): phase (a)'s traffic (tokens/s, TTFT beside phase
   (a)'s), its first half again with ``drain_replica(0)`` once replica 0
   holds ``CLUSTER_DRAIN_AT`` rows mid-decode and ``readmit_replica(0)``
   (requeued, the drain's seconds), and ``CLUSTER_HANDOFFS`` of
   serve_prefix's longer requests handed off (pages, seconds a handoff):
   no port kernel, no sync in a segment of the drain and handoff runs,
   every greedy reply equal to solo ``generate()`` or first different at
   a near-tie, every request's trace complete with its critical path
   tiling its duration. ``serve_total`` times the serve phases together.
   jobs (``jobs_total``): ``smoke`` sums a bf16 matmul of ones to 256³;
   ``mnist`` at its defaults improves its loss (seconds a step);
   ``llm --metrics-port`` at a tiny depth serves ``/metrics`` (200, the
   ko_train_* families) and 404 elsewhere; checkpoints: the resnet50 job
   (batch 64, ``--ckpt-every 1``) 2 steps then resumed to 3, the llm job
   at the bench LM's widths 2 steps, then ``serve --ckpt-dir`` announces
   ``checkpoint step 2`` and a greedy ``/generate`` equals ``generate()``
   on the restored model token for token (bytes, save and restore
   seconds).
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
   (for K7 one cuBLAS call per product) and the bounds. At each K8 site
   also ``split_rows``: the rows in two halves as two data ranks hold
   them, the halves' phase-0 sums added, phase 1 on each half with
   ``n_total`` = N, against the plain version on all N rows within
   ``CONV_TOL``, the same bits twice.
   kernels_bn: BatchNorm's kernels (``batch_norm``: ``bn_fwd_sums``,
   ``bn_fwd_apply``, ``bn_bwd_sums``, ``bn_bwd_dx``) at each distinct shape
   of ResNet-50's 53 BatchNorms at batch 256 (``bn_sites``): the apply
   and dx the same bits as their plain versions on the same statistics,
   the sums within ``F32_TOL`` and the same bits twice; kernel, plain and
   bound times, and a whole site forward and backward through
   ``BatchNormTrain`` beside the f32 op chain it replaces and
   ``F.batch_norm`` (a yardstick only); then each kernel's time a step on
   the two one-card paths (``bn_kernel_phase``). Alone, with a step's
   launches on both paths at batch 256: ``python3 -c "import chip_smoke
   as c; c.bn_alone()"``.
9. resnet_train: the ResNet main path, ``Trainer(RESNET_K7_K8).measure``
   at ResNet-50's full width and depth (224², batch 128, 8 steps per
   call), launch counts reset before and read after: each K7 kernel at
   least 24 and each K8 kernel at least 9 launches per step, no flash
   kernel; then one more step records K7's shapes, which must be
   ``K7_SITES``, and BatchNorm's launches, which must be 53 of each
   forward kernel and 44 of each backward kernel (``bn_step_launches``).
10. resnet_job: the ``resnet50`` entry point at its defaults (no K7/K8, as
    the JAX job), 2 steps of 64 images: finite losses, no K7/K8 launch,
    each BatchNorm kernel 53 times a step and nothing on the plain ops.
    resnet_dot2: the K7/K8 configuration with ``conv_bwd="dot2"`` and
    ``fused_bn=False``: finite loss, no K7/K8 launch, step ms beside
    resnet_train's.
    aot_bringup: the compile cache (``aot.CompileCache``) in a fresh
    directory under ``build/``: a fresh process builds
    ``Trainer(RESNET_K7_K8, compile_cache=...)`` under
    ``compile_count_guard`` and takes one step (cold: two nvcc builds,
    ``conv_bwd`` and ``batch_norm``), then another fresh process does the same against the
    populated directory (warm: none); both launch K7 24 times and each K8
    kernel 9 times from the cache's library and give the same loss bits;
    each arm's bring-up seconds (construction to the first kernel launch),
    the speedup and the library's bytes. Then the slot pool with
    ``compile_cache=``: ``source`` "none", nothing written, greedy rows
    equal to the same engine's without a cache.
    dist (phases ``dist_smoke``, ``dist_llm``, ``dist_vit``,
    ``dist_resnet``, ``dist_multi``): the smoke job joins an NCCL group
    from ``torchrun``'s environment (one rank, this process): its psum
    must equal the world; in that group the llm job at the bench LM's
    widths through ``--mesh dp:auto`` for as many steps as phase ``train``,
    from the same weights and batch: K1-K3 each at least once a layer and
    step, finite losses, the last within ``TOL`` of ``train``'s, step ms
    and MFU beside ``train``'s; ``ViTTrainer(ViTConfig())`` measured as
    ``vit_train`` was: K4-K6 12 launches a step, its loss within ``TOL``
    of ``vit_train``'s; ``Trainer(RESNET_K7_K8, MeshSpec(dp=1))`` measured
    as ``resnet_train`` was: K7 24 and each K8 kernel 9 launches a step,
    its loss within ``TOL`` of ``resnet_train``'s, then the resnet50 job
    under ``--mesh dp:auto --ckpt-dir`` resumed at step 2; ``dist_moe``:
    the MoE LM at ``moe_train``'s width through ``llm --experts 8 --mesh
    ep:auto`` for as many steps as ``moe_train``: K1-K3 each at least once
    a layer and step, the last loss within ``TOL`` of ``moe_train``'s,
    step ms, tokens/s and peak memory; ``dist_serve``: the serve job at
    the bench LM's widths through ``--mesh dp:auto``, greedy replies
    equal to a one-device pool's on the served weights (or first
    different at a near-tie). With two or more cards, ``dist_multi``
    spawns two NCCL ranks (``launch.spawn``) running ``MULTI_CASES`` —
    smoke, the LM at dp 2, sp 2 (ring and Ulysses) and tp 2, the MoE LM
    (8 experts, 2 layers) at ep 2 and dp 2, the fsdp job with and
    without overlap, the pipeline job, the llm job saved at dp 2
    (resumed here on one rank) — ``MULTI_TRAINERS`` — ResNet-50 (K7/K8)
    at dp 2 and fsdp 2, ViT-B/16 at dp 2 and tp 2 — and ``MULTI_POOLS``
    — the slot pool of the 2-layer bench LM at tp 2 and dp 2 — and
    ``MULTI_HANDOFF`` — that pool's prefill→decode handoff over tp 2, the
    mesh's export landed in one rank's pool and one rank's export landed
    in the mesh — each against its one-rank run: losses within ``TOL``,
    the BatchNorm
    running statistics equal on both ranks, greedy rows equal or first
    different at a near-tie (bf16 GEMMs of other shapes round
    otherwise); then its ``multislice`` case: four NCCL ranks in two
    virtual slices (``with_virtual_slices``) at dp 2 × tp 2 where four
    cards are visible, else two at dp 2 (a slice a rank), the 2-layer
    bench LM for 3 steps: each dp row's ranks in one slice, tp across the
    slices refused before any collective, the losses within ``TOL`` of
    one rank's, K1-K3 on every rank. With one card it says so and runs
    nothing.
    benches: the port's benches and dry run on the card. The cost-model
    mode of ``bench_multichip`` priced for this card (fsdp overlap win
    growing with the device count, the GPipe bubble within 10% of the
    analytic); its measured matrix over the visible cards (one NCCL spawn
    a world of 1, 2 or 4), ring attention at the priced width (B 1, H 32,
    D 128, bf16) at T 8192 beside ``ring_attention_model``'s
    ``compute_s``, every record ok; from two cards the fsdp A/B (its
    losses within ``TOL``) and the GPipe bubble, with one card a record
    that says they did not run; the serving arms (``bench_serving``) at the bench LM's width: the
    speculative engine against its plain twin (greedy rows equal or
    first different at a near-tie), the pool per (dp, tp) shape that
    fits, cold and warm bring-up through a fresh compile cache (no
    build); ``dryrun_multichip`` over the visible cards (an OK line a
    config) and ``entry()``'s forward.
11. bitcast_probe: K9's probe, the per-channel sum of a conv output by the
    library, by K9 on the channels-last output, and by K9 after a layout
    copy.
12. bench: ``kubeoperator_tpu_torch.bench.main()`` once (ResNet-50 on the
    dot path, the bench LM at T 2048, 4096 and 8192, ViT-B/16), its line
    echoed, each point's launches read: K1-K3 and Δ at least once a layer
    and step in the LM points, K4-K6 in the ViT point, no K7/K8 in the
    headline; its headline step beside resnet_train's. The 2k LM and
    ViT-B/16 points take phases ``train``'s and ``vit_train``'s numbers
    and launches (measured with the bench's settings), so each
    configuration is measured once.

Then ``script_total`` (the whole script's seconds beside the new phases'),
the ``kernels`` line (each kernel also with the CUDA kernels behind it
and where they are defined), and last the device line the harness
reads.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import queue
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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
# the launches of one such step: K7 at its 24 sites, each K8 kernel at 9
RESNET_STEP_LAUNCHES = {"conv1x1_bwd_dx": 24, "conv1x1_bwd_dw": 24,
                        "bn_bwd_stats": 9, "bn_bwd_dx": 9, "bn_bwd_dw": 9}
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
# serve_prefix: the shared system prompt's length, how many requests of
# each hit kind, and how many greedy rows of each kind are held against a
# cold admission of the same request
PREFIX_LEN = 512
PREFIX_KINDS = (("full", 4), ("cover", 14), ("partial", 14))
PREFIX_CHECKED = (("full", 2), ("cover", 3), ("partial", 3))
# serve_spill: distinct prefixes (cycled twice), new tokens a request, and
# the host tier's bound in pages. A demoted prefix of 16 pages takes 136
# there (the cache holds one entry per page-aligned prefix, 1 to 16
# pages, and each demotes on its own), so eight take 1,088
SPILL_PREFIXES, SPILL_NEW, SPILL_PAGES = 8, 64, 1088
# serve_spec: bench_serving.py:321's bench_spec_real defaults, on phase
# (a)'s engine shape and traffic
SPEC_K, DRAFT_LAYERS = 4, 1
# serve_cluster: the drain run's requests (phase (a)'s first), the rows
# replica 0 holds mid-decode when it is drained, and how many of
# serve_prefix's requests hand their pages off
CLUSTER_DRAIN_REQUESTS, CLUSTER_DRAIN_AT, CLUSTER_HANDOFFS = 16, 4, 4


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
        if per_step:
            rec["split_rows"] = k8_split_rows(bn, check, x, g, y, w, vecs,
                                              relu, sums_p)
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


def k8_split_rows(bn, check, x, g, y, w, vecs, relu: bool, sums_p) -> dict:
    """K8 as a world of two data ranks runs it, on one card: the rows in
    two halves, phase 0 on each and the sums added (the all-reduce), phase
    1 on each half with ``n_total`` = N, dx concatenated and the two dW
    added; against the plain version on all N rows (its own sums) within
    ``CONV_TOL``, the sums within ``F32_TOL``, and the same bits twice."""
    n = x.shape[0]
    halves = (slice(0, n // 2), slice(n // 2, n))

    def split():
        sums = sum(bn.bn_bwd_stats(g[h], y[h], *vecs, relu) for h in halves)
        dx = torch.cat([bn.bn_bwd_dx(g[h], y[h], w, *vecs, sums, relu, n)
                        for h in halves])
        dw = sum(bn.bn_bwd_dw(x[h], g[h], y[h], *vecs, sums, relu, n)
                 for h in halves)
        return sums, dx, dw

    sums, dx, dw = split()
    again = split()
    torch.cuda.synchronize()
    rec = {"halves": [n // 2, n - n // 2], "n_total": n,
           "sums": check("bn_bwd_stats", sums.t(), sums_p.t(), F32_TOL),
           "dx": check("bn_bwd_dx", dx, bn.bn_bwd_dx_plain(
               g, y, w, *vecs, sums_p, relu), CONV_TOL),
           "dw": check("bn_bwd_dw", dw, bn.bn_bwd_dw_plain(
               x, g, y, *vecs, sums_p, relu), CONV_TOL),
           "same_bits_twice": all(torch.equal(a, b)
                                  for a, b in zip((sums, dx, dw), again))}
    if not rec["same_bits_twice"]:
        raise AssertionError("K8 split rows: two runs differ")
    return rec


# BatchNorm's kernels (batch_norm.cu) replace no TPU kernel: the JAX
# package leaves flax's nn.BatchNorm to XLA
BN_SOURCE = "kubeoperator_tpu_torch/csrc/batch_norm.cu"
BN_KERNELS = {"bn_fwd_sums": ["bn_sums_kernel", "bn_finish_kernel"],
              "bn_fwd_apply": ["bn_apply_kernel"],
              "bn_bwd_sums": ["bn_sums_kernel", "bn_finish_kernel"],
              "bn_bwd_dx": ["bn_dx_kernel"]}


def host_us(fn, n: int = 200) -> float:
    """The host's µs a call of ``fn``, over ``n`` calls back to back
    (launches not waited for), after a warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def bn_sites(batch: int) -> list[tuple]:
    """(n, c, relu, fused) of each of ResNet-50's 53 BatchNorms in a step
    at 224² (s2d stem) and this batch, in model order: the stem, each
    block's bn1 (at its input's size), bn2 and bn3 (at its output's), and
    the four projections; ``fused`` marks those that are K8 units in the
    K7/K8 configuration (their forward on these kernels, their backward
    K8's)."""
    sites = [(batch * 112 * 112, 64, True, False)]
    hw = 56
    for stage, blocks in enumerate((3, 4, 6, 3)):
        c = 64 * 2 ** stage
        for i in range(blocks):
            stride = 2 if stage and i == 0 else 1
            fused, out = hw * hw >= 3136, hw // stride
            sites += [(batch * hw * hw, c, True, fused),
                      (batch * out * out, c, True, False),
                      (batch * out * out, 4 * c, False, fused)]
            if i == 0:
                sites.append((batch * out * out, 4 * c, False,
                              fused and stride == 1))
            hw = out
    return sites


def bn_step_launches(batch_sites: list, k7k8: bool) -> dict:
    """The BatchNorm kernels' launches in one step: every site's forward,
    the backward where no K8 unit takes it."""
    bwd = sum(1 for *_, fused in batch_sites if not (k7k8 and fused))
    return {"bn_fwd_sums": len(batch_sites), "bn_fwd_apply": len(batch_sites),
            "bn_bwd_sums": bwd, "bn_bwd_dx": bwd, "bn_plain": 0}


def bn_kernel_phase(peaks, batch: int = 256) -> dict:
    """The four BatchNorm kernels at each distinct shape of ResNet-50's
    BatchNorms at this batch, each against its plain version: the apply
    and dx the same bits as their plain versions on the same statistics
    (one f32 operation at a time, in one order), the sums within
    ``F32_TOL`` (f32 sums in another order) and the same bits twice;
    kernel, plain and bound times, and two yardsticks a site: the
    formulation the kernels replace (``resnet.BatchNorm``'s f32 op chain,
    forward and autograd backward) and ``F.batch_norm`` in training mode
    (forward and backward; the port never calls it). Returns the per-step
    sums for the two one-card ResNet paths."""
    import torch.nn.functional as F

    from kubeoperator_tpu_torch.workloads import batch_norm as bnk

    gen = torch.Generator(device="cuda").manual_seed(4322)
    sites = bn_sites(batch)
    shapes = collections.Counter((n, c, relu) for n, c, relu, _ in sites)
    fused_bwd = collections.Counter((n, c, relu) for n, c, relu, f in sites
                                    if f)
    recs = {}
    for (n, c, relu), count in shapes.items():
        x = (torch.randn(n, c, device="cuda", generator=gen) * 2
             + 0.5).to(torch.bfloat16)
        g = torch.randn(n, c, device="cuda", generator=gen).to(torch.bfloat16)
        gamma = torch.linspace(0.5, 1.5, c, device="cuda")
        beta = torch.linspace(-0.3, 0.3, c, device="cuda")

        def running():
            return (torch.zeros(c, device="cuda"),
                    torch.ones(c, device="cuda"))

        stats = bnk.bn_fwd_sums(x, *running(), 0.9, 1e-5, True)
        again = bnk.bn_fwd_sums(x, *running(), 0.9, 1e-5, True)
        mean, var, inv = bnk.bn_fwd_sums_plain(x, *running(), 0.9, 1e-5,
                                               True)
        out = bnk.bn_fwd_apply(x, mean, gamma, inv, beta, relu)
        out_p = bnk.bn_fwd_apply_plain(x, mean, gamma, inv, beta, relu)
        sums = bnk.bn_bwd_sums(x, g, out_p, mean, inv, relu)
        sums_p = bnk.bn_bwd_sums_plain(x, g, out_p, mean, inv, relu)
        dx = bnk.bn_bwd_dx(x, g, out_p, mean, inv, gamma, sums_p, relu)
        dx_p = bnk.bn_bwd_dx_plain(x, g, out_p, mean, inv, gamma, sums_p,
                                   relu)
        torch.cuda.synchronize()
        elems = n * c
        nbytes = {"bn_fwd_sums": 2 * elems, "bn_fwd_apply": 4 * elems,
                  "bn_bwd_sums": (6 if relu else 4) * elems,
                  "bn_bwd_dx": (8 if relu else 6) * elems}
        rec = {"n": n, "c": c, "relu": relu, "sites_per_step": count,
               "fused_sites": fused_bwd[(n, c, relu)],
               "stats_err": errors(torch.stack(stats), torch.stack(
                   (mean, var, inv)), F32_TOL),
               "bn_bwd_sums_err": errors(sums, sums_p, F32_TOL),
               "apply_same_bits": bool(torch.equal(out, out_p)),
               "dx_same_bits": bool(torch.equal(dx, dx_p)),
               "same_bits_twice": bool(
                   all(torch.equal(a, b) for a, b in zip(stats, again))
                   and torch.equal(sums, bnk.bn_bwd_sums(
                       x, g, out_p, mean, inv, relu)))}
        bad = [k for k in ("apply_same_bits", "dx_same_bits",
                           "same_bits_twice") if not rec[k]]
        bad += [k for k in ("stats_err", "bn_bwd_sums_err")
                if not rec[k]["within"]]
        if bad:
            raise AssertionError(f"kernels_bn at {n} x {c}: {bad}: {rec}")
        rm, rv = running()          # the timed calls update these
        calls = {
            "bn_fwd_sums": (lambda: bnk.bn_fwd_sums(
                x, rm, rv, 0.9, 1e-5, True), lambda: bnk.
                bn_fwd_sums_plain(x, rm, rv, 0.9, 1e-5, True)),
            "bn_fwd_apply": (lambda: bnk.bn_fwd_apply(
                x, mean, gamma, inv, beta, relu), lambda: bnk.
                bn_fwd_apply_plain(x, mean, gamma, inv, beta, relu)),
            "bn_bwd_sums": (lambda: bnk.bn_bwd_sums(
                x, g, out_p, mean, inv, relu), lambda: bnk.
                bn_bwd_sums_plain(x, g, out_p, mean, inv, relu)),
            "bn_bwd_dx": (lambda: bnk.bn_bwd_dx(
                x, g, out_p, mean, inv, gamma, sums, relu), lambda: bnk.
                bn_bwd_dx_plain(x, g, out_p, mean, inv, gamma, sums, relu))}
        for k, (kern, plain) in calls.items():
            ms = cuda_ms(kern)
            bound = nbytes[k] / peaks[1] * 1e3
            rec[k] = {"ms": ms, "plain_ms": cuda_ms(plain, n=2),
                      "bound_ms": bound, "bound_by": "bytes",
                      "bytes": nbytes[k], "roofline_pct": 100 * bound / ms}
        # a whole site forward and backward: the kernels through the
        # Function, the f32 op chain they replace, and F.batch_norm
        x4 = x.view(n, 1, 1, c)
        g4 = g.view(n, 1, 1, c)
        xr = x4.clone().requires_grad_()
        ps = (xr, gamma.clone().requires_grad_(),
              beta.clone().requires_grad_())

        def function():
            return torch.autograd.grad(bnk.BatchNormTrain.apply(
                *ps, (rm, rv), 0.9, 1e-5, relu, True, ()), ps, g4)

        def replaced():
            # resnet.BatchNorm's plain ops, as the parent ran them
            xf = xr.float()
            mu, msq = xf.mean((0, 1, 2)), (xf * xf).mean((0, 1, 2))
            v = torch.maximum(msq - mu * mu, xf.new_zeros(()))
            y = ((xf - mu) * (torch.rsqrt(v + 1e-5) * ps[1])
                 + ps[2]).to(torch.bfloat16)
            return torch.autograd.grad(torch.relu(y) if relu else y, ps, g4)

        x2r = x.clone().requires_grad_()

        def library():
            y = F.batch_norm(x2r, rm, rv, ps[1], ps[2], training=True,
                             momentum=0.1, eps=1e-5)
            return torch.autograd.grad(torch.relu(y) if relu else y,
                                       (x2r, ps[1], ps[2]), g)

        rec["site"] = {"ms": cuda_ms(function),
                       "replaced_ms": cuda_ms(replaced, n=2),
                       "library_ms": cuda_ms(library),
                       "bound_ms": sum(rec[k]["bound_ms"] for k in calls)}
        rec["site_fwd"] = {"ms": rec["bn_fwd_sums"]["ms"]
                           + rec["bn_fwd_apply"]["ms"],
                           "bound_ms": rec["bn_fwd_sums"]["bound_ms"]
                           + rec["bn_fwd_apply"]["bound_ms"]}
        if (n, c, relu) == min(shapes):
            # at the smallest shape the card keeps up with the host: what
            # each call costs the host (µs), which a step pays 53 times
            rec["host_us"] = {k: host_us(kern)
                              for k, (kern, _) in calls.items()}
            rec["host_us"].update(site=host_us(function),
                                  replaced=host_us(replaced),
                                  library=host_us(library))
        emit({"phase": "kernels_bn", **rec})
        recs[(n, c, relu)] = rec
        del x, g, out, out_p, dx, dx_p, xr, x2r, x4, g4
    # a step's device time in the four kernels, by path: every site's
    # forward; the backward at every site (job) or where no K8 unit takes
    # it (k7k8); beside the bound and the replaced chain's time
    per_step = {}
    for path in ("job", "k7k8"):
        tot = collections.Counter()
        for key, r in recs.items():
            bwd = r["sites_per_step"] - (r["fused_sites"] if path == "k7k8"
                                         else 0)
            for k in ("bn_fwd_sums", "bn_fwd_apply"):
                tot["ms"] += r["sites_per_step"] * r[k]["ms"]
                tot["bound_ms"] += r["sites_per_step"] * r[k]["bound_ms"]
            for k in ("bn_bwd_sums", "bn_bwd_dx"):
                tot["ms"] += bwd * r[k]["ms"]
                tot["bound_ms"] += bwd * r[k]["bound_ms"]
            tot["site_ms_plain_bn"] += bwd * r["site"]["ms"]
            tot["replaced_ms_plain_bn"] += bwd * r["site"]["replaced_ms"]
            tot["library_ms_plain_bn"] += bwd * r["site"]["library_ms"]
        per_step[path] = dict(tot)
    rec = {"phase": "kernels_bn", "batch": batch, "sites": len(sites),
           "elements_per_step": sum(n * c for n, c, _, _ in sites),
           "per_step": per_step, "launches_per_step": {
               "k7k8": bn_step_launches(sites, True),
               "job": bn_step_launches(sites, False)},
           "cuda_kernels": {k: {name: defined_at(BN_SOURCE, name)
                                for name in v}
                            for k, v in BN_KERNELS.items()},
           "f32_tolerance": F32_TOL}
    emit(rec)
    return rec


def bn_step_counts(rcfg, batch: int, smi: str) -> dict:
    """One training step of ResNet-50 at this batch on each one-card path
    (``RESNET_K7_K8``'s and the job's defaults), the BatchNorm kernels'
    launches counted: ``bn_step_launches`` exactly, nothing on the plain
    ops."""
    from kubeoperator_tpu_torch.workloads import batch_norm as bnk
    from kubeoperator_tpu_torch.workloads.train import Trainer

    paths = {"k7k8": rcfg, "job": dataclasses.replace(
        rcfg, dw_dot_max_k=0, conv_bwd="dot", fused_bn=False)}
    got = {}
    for path, cfg in paths.items():
        cfg = dataclasses.replace(cfg, batch_size=batch)
        tr = Trainer(cfg)
        state = tr.init_state()
        batch_x = tr.synthetic_batch(batch)
        tr.train_step(state, *batch_x)
        torch.cuda.synchronize()
        bnk.reset_launches()
        tr.train_step(state, *batch_x)
        torch.cuda.synchronize()
        got[path] = dict(bnk.LAUNCHES)
        del tr, state, batch_x
        gc.collect()
        torch.cuda.empty_cache()
    want = {path: bn_step_launches(bn_sites(batch), path == "k7k8")
            for path in paths}
    emit({"phase": "bn_step_launches", "batch": batch, "launches": got,
          "want": want, "nvidia_smi": smi})
    if got != want:
        raise AssertionError(f"bn_step_launches at batch {batch}: {got}, "
                             f"not {want}")
    return got


def bn_alone() -> dict:
    """BatchNorm's kernels alone: the build, ``kernels_bn`` at batch 256
    and a step's launches on both one-card paths at batch 256."""
    from kubeoperator_tpu_torch import kernels
    from kubeoperator_tpu_torch.profile_lm import RESNET_K7_K8
    from kubeoperator_tpu_torch.workloads.train import (
        peak_flops_per_chip, peak_hbm_bytes_per_chip)

    smi = nvidia_smi()
    t0 = time.perf_counter()
    log = kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: {"seconds": v["seconds"], "cached": v["cached"]}
                        for n, v in log.items()},
          "ptxas": {n: kernels.ptxas_report(v["ptxas"])
                    for n, v in log.items() if n == "batch_norm"},
          "nvidia_smi": smi})
    peaks = (peak_flops_per_chip(), peak_hbm_bytes_per_chip())
    rec = bn_kernel_phase(peaks)
    rec["step_launches"] = bn_step_counts(RESNET_K7_K8, 256, smi)
    return rec


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


def instrument(engine) -> dict:
    """Wrap ``engine.run_segment`` and ``engine.admit`` in place: every
    segment runs between CUDA events under
    ``torch.cuda.set_sync_debug_mode("error")`` (a segment only enqueues
    work, so any host sync inside it raises), every admission between
    CUDA events, and after each admission the wave's hit kinds are
    counted and the peak of ``pages_in_use()`` kept. Returns the lists and
    counters the wrappers fill."""
    rec = {"seg": [], "admit": [], "peak_pages": engine.pages_in_use(),
           "hit_kinds": collections.Counter()}
    run_segment, admit = engine.run_segment, engine.admit

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def checked_segment():
        start, end = events()
        start.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_segment()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.record()
        rec["seg"].append((start, end))

    def timed_admit(entries):
        start, end = events()
        start.record()
        out = admit(entries)
        end.record()
        rec["admit"].append((start, end, len(entries)))
        rec["hit_kinds"].update(p["hit_kind"]
                                for p in engine.last_plans.values())
        rec["peak_pages"] = max(rec["peak_pages"], engine.pages_in_use())
        return out

    engine.run_segment, engine.admit = checked_segment, timed_admit
    return rec


def drive(engine, reqs: list, clients: int) -> tuple:
    """``reqs`` through a ``ContinuousBatcher`` over the instrumented
    ``engine`` from ``clients`` threads, port launch counts reset before
    and read after: no port kernel may launch, and every reply must be
    its prompt followed by the asked number of tokens of the vocabulary.
    Returns (batcher, stats, results, measurements)."""
    from kubeoperator_tpu_torch.workloads.serving import (
        BatcherStats, ContinuousBatcher,
    )

    rec = instrument(engine)
    stats = BatcherStats()
    batcher = ContinuousBatcher(engine, stats=stats)
    reset_port_launches()
    t0 = time.perf_counter()
    results = run_clients(batcher.submit, reqs, clients)
    wall = time.perf_counter() - t0
    launches = port_launches()
    torch.cuda.synchronize()
    if any(launches.values()):
        raise AssertionError(f"serve: the segments launched port kernels: "
                             f"{launches}")
    vocab = engine.cfg.vocab_size
    for i, (prompt, mt, _, _) in enumerate(reqs):
        row = results[i]
        if len(row) != len(prompt) + mt or row[:len(prompt)] != prompt:
            raise AssertionError(f"serve: request {i} came back malformed")
        if not all(0 <= t < vocab for t in row):
            raise AssertionError(f"serve: request {i} left the vocabulary")
    seg_ms = [a.elapsed_time(b) for a, b in rec["seg"]]
    admit_ms = [a.elapsed_time(b) for a, b, _ in rec["admit"]]
    tokens = sum(mt for _, mt, _, _ in reqs)
    m = {"launches": launches, "sync_debug_mode": "error",
         "segments": len(seg_ms), "generated_tokens": tokens, "wall_s": wall,
         "tokens_per_s": tokens / wall,
         "segment_ms_median": statistics.median(seg_ms),
         "segment_ms_p10_p90": [float(np.percentile(seg_ms, 10)),
                                float(np.percentile(seg_ms, 90))],
         "micro_step_ms": statistics.median(seg_ms) / engine.segment,
         "admission_waves": len(admit_ms),
         "admission_ms_median": statistics.median(admit_ms),
         "admission_ms_per_wave": [[round(ms, 3), k] for ms, (_, _, k)
                                   in zip(admit_ms, rec["admit"])],
         "ttft_p50_s": stats.ttft_quantile(0.5),
         "ttft_p95_s": stats.ttft_quantile(0.95),
         "ttft_mean_s": stats.ttft_mean(), "stats": stats.snapshot(),
         "hit_kinds": dict(rec["hit_kinds"]),
         "peak_pages_in_use": rec["peak_pages"],
         "page": engine.page, "pages": engine.pages,
         "pool_bytes": engine.pool_bytes, "kv_dtype": engine.kv_dtype}
    m.update({k: getattr(engine, k) for k in (
        "prefix_hits", "prefix_pages_reused", "cow_copies", "demotions",
        "promoted_hits")})
    return batcher, stats, results, m


def check_repeats(batcher, reqs: list, idx, results: dict) -> None:
    """Each sampled request ``idx`` run again, beside other neighbours,
    must draw the same tokens."""
    again = run_clients(batcher.submit, [reqs[i] for i in idx], len(idx))
    for j, i in enumerate(idx):
        if again[j] != results[i]:
            raise AssertionError(f"serve: sampled request {i} differs from "
                                 f"its repeat run")


def near_tie(model, i: int, got: list, want: list, limit: float,
             logits_at=None) -> dict:
    """Request ``i``'s greedy row ``got`` against ``want``: equal, or the
    first differing token a near-tie (gap <= ``limit``) in the logits over
    ``want``'s tokens before it: the full forward's, or ``logits_at(
    prefix)``'s."""
    j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    rec = {"request": i, "equal": j is None}
    if j is not None:
        with torch.no_grad():
            logits = (model(torch.as_tensor(
                [want[:j]], device=model.embedding.device))[0, -1].float()
                if logits_at is None else logits_at(want[:j]))
        gap = abs(float(logits[got[j]] - logits[want[j]]))
        rec.update(first_diff=j, logit_gap=gap)
        if gap > limit:
            raise AssertionError(f"serve: greedy request {i} differs at {j} "
                                 f"with a logit gap of {gap} > {limit}")
    return rec


def serve_engine_phase(cfg, model, smi: str, hbm: float) -> dict:
    """Phase (a): the slot pool behind the continuous batcher."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.generate import generate

    reqs = serve_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                            segment=SERVE_SEGMENT,
                            device=model.embedding.device)
    batcher, _, results, m = drive(engine, reqs, SERVE_CLIENTS)
    peak = torch.cuda.max_memory_allocated()
    # sampled rows: a repeat run, with other neighbours, draws the same
    check_repeats(batcher, reqs, SERVE_SAMPLED, results)
    # the first 8 greedy rows against a solo generate() of each request
    greedy = [i for i in range(SERVE_REQUESTS) if reqs[i][2] == 0.0][:8]
    checks = []
    for i in greedy:
        prompt, mt, _, _ = reqs[i]
        with torch.no_grad():
            want = generate(cfg, model, [prompt], mt,
                            device=model.embedding.device)[0].tolist()
        checks.append({**near_tie(model, i, results[i], want, NEAR_TIE),
                       "prompt_len": len(prompt), "max_tokens": mt})

    weight_bytes = 2 * sum(p.numel() for p in model.parameters())
    rec = {"phase": "serve_engine", "nvidia_smi": smi,
           "config": {**dataclasses.asdict(cfg), "dtype": str(cfg.dtype)},
           "slots": SERVE_SLOTS, "segment": SERVE_SEGMENT,
           "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
           "prompt_lens": [len(r[0]) for r in reqs],
           "max_tokens": [r[1] for r in reqs],
           "sampled": list(SERVE_SAMPLED), **m,
           "max_memory_allocated": peak,
           "weight_bytes_bf16": weight_bytes,
           "micro_step_bound_ms_weights": weight_bytes / hbm * 1e3,
           "micro_step_bound_ms_weights_full_kv":
               (weight_bytes + engine.pool_bytes) / hbm * 1e3,
           "greedy_vs_solo": checks,
           "near_tie_rows": sum(not c["equal"] for c in checks)}
    emit(rec)
    return rec, results


def run_wave(cfg, model, reqs: list, **kw) -> list[list[int]]:
    """Every request of ``reqs`` admitted in ONE wave into a fresh engine
    with a slot each (so none hits another's prefix: prefixes publish
    after the wave), decoded to the end; the rows."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine

    engine = SlotPoolEngine(cfg, model, slots=len(reqs), segment=SERVE_SEGMENT,
                            device=model.embedding.device, **kw)
    pos = engine.admit([(i, p, mt, t, sd)
                        for i, (p, mt, t, sd) in enumerate(reqs)])
    track = {i: [pos[i], len(p) + mt - 1] for i, (p, mt, _, _) in
             enumerate(reqs)}
    while any(p < last for p, last in track.values()):
        engine.run_segment()
        for t in track.values():
            t[0] = min(t[0] + engine.segment, t[1])
    buf, _ = engine.poll()
    return [buf[i][:len(p) + mt].tolist() for i, (p, mt, _, _) in
            enumerate(reqs)]


def prefix_traffic(vocab: int) -> tuple[list, list, list]:
    """serve_prefix's requests from seed 1: the shared system prompt
    (``PREFIX_LEN`` tokens), each request's hit kind, and (suffix,
    max_tokens, temperature, seed) per request — a full hit has no
    suffix, a cover hit 1-511 tokens, a partial hit 512-1,024."""
    rng = np.random.default_rng(1)
    system = rng.integers(0, vocab, PREFIX_LEN).tolist()
    kinds = [k for k, n in PREFIX_KINDS for _ in range(n)]
    rng.shuffle(kinds)
    span = {"full": (0, 1), "cover": (1, PREFIX_LEN),
            "partial": (PREFIX_LEN, 2 * PREFIX_LEN + 1)}
    tails = [(rng.integers(0, vocab, int(rng.integers(*span[k]))).tolist(),
              int(rng.integers(32, 129)),
              0.8 if i in SERVE_SAMPLED else 0.0, i)
             for i, k in enumerate(kinds)]
    return system, kinds, tails


def serve_prefix_phase(cfg, model, smi: str) -> dict:
    """Phase (c): every prompt opens with one shared system prompt, which
    a first request has already cached; then the same requests with that
    prefix replaced by random tokens of their own, so nothing hits."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine

    system, kinds, tails = prefix_traffic(cfg.vocab_size)
    rng = np.random.default_rng(2)
    out = {}
    for run in ("hit", "cold"):
        if run == "hit":
            prefixes = [system] * len(tails)
            prime = system
        else:
            prefixes = [rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
                        for _ in tails]
            prime = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
        reqs = [(pre + tail, mt, t, sd)
                for pre, (tail, mt, t, sd) in zip(prefixes, tails)]
        engine = SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                                segment=SERVE_SEGMENT,
                                device=model.embedding.device)
        # a first request caches its prompt's pages (the system prompt in
        # the hit run): one prefill, nothing to decode
        engine.admit([(0, prime, 1, 0.0, 0)])
        engine.release([0])
        cached = engine._shards[0].prefix[hash(tuple(prime))][1]
        # ko: lint-ok[KO101] the check's page ids, once a run of the phase and outside its timed traffic
        idx = torch.as_tensor(cached, device=model.embedding.device)
        before = [b[idx].clone() for entry in engine._pools for b in entry]
        batcher, _, results, m = drive(engine, reqs, SERVE_CLIENTS)
        check_repeats(batcher, reqs, SERVE_SAMPLED, results)
        want = {"hit": collections.Counter(kinds),
                "cold": {"miss": len(reqs)}}[run]
        if m["hit_kinds"] != dict(want):
            raise AssertionError(f"serve_prefix {run}: hit kinds "
                                 f"{m['hit_kinds']}, expected {dict(want)}")
        out[run] = m
        if run == "cold":
            continue
        # the sharers wrote only their own pages
        after = [b[idx] for entry in engine._pools for b in entry]
        if engine._shards[0].prefix[hash(tuple(prime))][1] != cached or \
                not all(map(torch.equal, after, before)):
            raise AssertionError("serve_prefix: the cached system prompt's "
                                 "pages changed under their sharers")
        m["cached_pages_unchanged"] = len(cached)
        # greedy hit rows of each kind against the same requests admitted
        # cold, in one wave into a fresh engine
        picked = [i for k, n in PREFIX_CHECKED for i in
                  [j for j, kk in enumerate(kinds)
                   if kk == k and tails[j][2] == 0.0][:n]]
        cold = run_wave(cfg, model, [reqs[i] for i in picked])
        m["greedy_vs_cold"] = [
            {**near_tie(model, i, results[i], row, NEAR_TIE),
             "kind": kinds[i], "prompt_len": len(reqs[i][0])}
            for i, row in zip(picked, cold)]
    rec = {"phase": "serve_prefix", "nvidia_smi": smi,
           "slots": SERVE_SLOTS, "segment": SERVE_SEGMENT,
           "requests": len(tails), "clients": SERVE_CLIENTS,
           "prefix_len": PREFIX_LEN, "kinds": kinds,
           "prompt_lens": [PREFIX_LEN + len(t[0]) for t in tails],
           "max_tokens": [t[1] for t in tails],
           "sampled": list(SERVE_SAMPLED), **out}
    emit(rec)
    return rec


def kv_quant_pages(cfg, page: int, budget: int) -> tuple[int, int]:
    """(pages, bytes a page) of an int8 pool within ``budget`` bytes: a
    page holds 1-byte K and V codes and a float32 scale per (offset,
    head), in every layer."""
    per_page = cfg.n_layers * 2 * page * cfg.n_heads * (cfg.head_dim + 4)
    return budget // per_page, per_page


def serve_kv_quant_phase(cfg, model, smi: str, bf16: dict) -> dict:
    """Phase (d): int8 pages at the bf16 pool's byte budget under phase
    (a)'s traffic, then the same 16 greedy requests admitted into bf16,
    int8 and fp8 engines: the int8 engine's logits within
    ``LOGIT_TOLERANCE`` of bf16's, and the fp8 engine's distance
    reported against the same bound."""
    from kubeoperator_tpu_torch.workloads.decode_loop import (
        LOGIT_TOLERANCE, SlotPoolEngine,
    )

    dev = model.embedding.device
    pages, per_page = kv_quant_pages(cfg, bf16["page"], bf16["pool_bytes"])
    reqs = serve_requests(cfg.vocab_size)
    engine = SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                            segment=SERVE_SEGMENT, pages=pages,
                            kv_dtype="int8", device=dev)
    if engine.pool_bytes != pages * per_page or \
            engine.pool_bytes > bf16["pool_bytes"]:
        raise AssertionError(f"serve_kv_quant: pool of {engine.pool_bytes} "
                             f"bytes, budget {bf16['pool_bytes']}")
    batcher, _, results, m = drive(engine, reqs, SERVE_CLIENTS)
    check_repeats(batcher, reqs, SERVE_SAMPLED, results)

    greedy = [r for r in reqs if r[2] == 0.0][:SERVE_SLOTS]
    engines = {kv: SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                                  segment=SERVE_SEGMENT, kv_dtype=kv,
                                  device=dev)
               for kv in ("bf16", "int8", "fp8")}
    for e in engines.values():
        e.admit([(i, p, mt, 0.0, sd) for i, (p, mt, _, sd) in
                 enumerate(greedy)])
    ref = engines["bf16"].debug_logits()
    rows = {kv: np.abs(engines[kv].debug_logits() - ref).max(axis=1)
            for kv in ("int8", "fp8")}
    deltas = {kv: float(r.max()) for kv, r in rows.items()}
    rec = {"phase": "serve_kv_quant", "nvidia_smi": smi,
           "requests": len(reqs), "clients": SERVE_CLIENTS,
           "bytes_per_page": {"bf16": bf16["pool_bytes"] // bf16["pages"],
                              "int8": per_page},
           "int8": m,
           "bf16": {k: bf16[k] for k in (
               "pages", "pool_bytes", "tokens_per_s", "segment_ms_median",
               "micro_step_ms")},
           "logit_max_abs_delta": deltas,
           "logit_max_abs_delta_per_row": {kv: r.tolist()
                                           for kv, r in rows.items()},
           "bf16_logit_abs_max": float(np.abs(ref).max()),
           "bf16_logit_std": float(ref.std()),
           "logit_tolerance": {kv: LOGIT_TOLERANCE[kv] for kv in deltas},
           "within_tolerance": {kv: d <= LOGIT_TOLERANCE[kv]
                                for kv, d in deltas.items()}}
    emit(rec)
    # int8, the serve job's quantized layout, is held to its declared
    # tolerance. fp8 is measured and reported beside it, not held: with
    # these weights the reference design's fp8 pages (e4m3 codes, one
    # scale per head) come out at 0.15-0.26 on an H100, over the 0.25
    # it declares, while its codes equal the reference's bit for bit on
    # the CPU (tests/test_torch_kv_quant.py)
    if not rec["within_tolerance"]["int8"]:
        raise AssertionError(f"serve_kv_quant: int8 logits differ from "
                             f"bf16's by {deltas['int8']}, over "
                             f"{LOGIT_TOLERANCE['int8']}")
    return rec


def spill_traffic(vocab: int) -> list:
    """serve_spill's requests from seed 3: ``SPILL_PREFIXES`` distinct
    256-token prefixes, each followed by a unique 16-token suffix, cycled
    twice, 64 greedy tokens each."""
    rng = np.random.default_rng(3)
    prefixes = [rng.integers(0, vocab, 256).tolist()
                for _ in range(SPILL_PREFIXES)]
    return [(prefixes[i % SPILL_PREFIXES] + rng.integers(0, vocab, 16).tolist(),
             SPILL_NEW, 0.0, i) for i in range(2 * SPILL_PREFIXES)]


def serve_spill_phase(cfg, model, smi: str, kv: str) -> dict:
    """Phase (e): a pool just large enough for four live requests and one
    prefix entry, with a host spill tier: the first cycle of prefixes
    demotes, the second promotes. Each promotion's pages must be the
    demoted bits; each row equals its cold run or first differs at a
    near-tie (the quantized tolerance added for a quantized pool)."""
    from kubeoperator_tpu_torch.workloads.decode_loop import (
        LOGIT_TOLERANCE, SlotPoolEngine,
    )

    dev = model.embedding.device
    reqs = spill_traffic(cfg.vocab_size)
    page = 16
    need = -(-(len(reqs[0][0]) + SPILL_NEW) // page)
    engine = SlotPoolEngine(cfg, model, slots=4, segment=SERVE_SEGMENT,
                            pages=4 * need + 256 // page + 1, kv_dtype=kv,
                            spill_pages=SPILL_PAGES, device=dev)
    sh = engine._shards[0]
    land, prefill, pinned = [], [], [0, True]
    land_pages, admit_group, admit = (engine._land_pages,
                                      engine._admit_group, engine.admit)

    def timed_land(pages, payload):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        land_pages(pages, payload)
        end.record()
        idx = torch.as_tensor(pages, device=dev)
        parts = [engine._split(e) for e in engine._pools]
        # ko: lint-ok[KO101] the bit-exactness check of a promotion, after its timed window closed
        same = all(torch.equal(torch.stack([p[kind][idx] for p in parts]),
                               payload[kind].to(dev))
                   for kind in range(len(payload)))
        land.append((start, end, len(pages), same))

    def timed_group(c, h, group):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = admit_group(c, h, group)
        end.record()
        prefill.append((start, end, c, h, len(group)))
        return out

    def counted_admit(entries):
        out = admit(entries)
        held = [t for _, p, _ in sh.spill.values() for t in p]
        pinned[0] = max(pinned[0], sum(t.numel() * t.element_size()
                                       for t in held))
        pinned[1] = pinned[1] and (dev.type != "cuda"
                                   or all(t.is_pinned() for t in held))
        return out

    engine._land_pages, engine._admit_group = timed_land, timed_group
    engine.admit = counted_admit
    _, _, results, m = drive(engine, reqs, 4)
    if not (m["demotions"] and m["promoted_hits"]):
        raise AssertionError(f"serve_spill {kv}: {m['demotions']} demotions "
                             f"and {m['promoted_hits']} promoted hits")
    if not all(same for *_, same in land):
        raise AssertionError(f"serve_spill {kv}: a promoted page differs "
                             f"from what was demoted")
    if not pinned[1]:
        raise AssertionError(f"serve_spill {kv}: spilled pages not pinned")
    limit = NEAR_TIE + LOGIT_TOLERANCE[kv]
    cold = run_wave(cfg, model, reqs, kv_dtype=kv)
    checks = [near_tie(model, i, results[i], row, limit)
              for i, row in enumerate(cold)]
    land_ms = [a.elapsed_time(b) for a, b, _, _ in land]
    prefill_ms = [a.elapsed_time(b) for a, b, c, h, k in prefill
                  if (c, h, k) == (256, 0, 1)]
    rec = {"phase": "serve_spill", "nvidia_smi": smi, "kv_dtype": kv,
           "slots": 4, "spill_pages": SPILL_PAGES,
           "requests": len(reqs), "prefixes": SPILL_PREFIXES, **m,
           "spill_pages_used": engine.spill_pages_used(),
           "promotions": len(land), "promoted_pages": [n for *_, n, _ in land],
           "promotion_ms_median": (statistics.median(land_ms)
                                   if land_ms else None),
           "promotion_ms": land_ms,
           "prefill_256_ms_median": (statistics.median(prefill_ms)
                                     if prefill_ms else None),
           "pinned_host_bytes_peak": pinned[0],
           "promoted_pages_bit_exact": True, "near_tie_limit": limit,
           "greedy_vs_cold": checks,
           "near_tie_rows": sum(not c["equal"] for c in checks)}
    emit(rec)
    return rec


def moe_train_phase(moe_cfg, smi: str, peaks: tuple) -> dict:
    """Phase 4b: the MoE LM's main path, ``LMTrainer(moe_cfg).measure`` at
    the bench LM's width with 8 experts, top-2, capacity factor 1.25, flash
    launch counts reset before and read after: K1-K3 each at least once a
    layer and step, Δ once per dQ launch, the loss (aux included) finite.
    Returns the launches and the measurement."""
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.transformer import (
        Transformer, flops_per_token,
    )

    steps, warmup, repeats = 3, 2, 2
    with torch.device("meta"):
        n_params = sum(p.numel() for p in Transformer(moe_cfg).parameters())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    m = LMTrainer(moe_cfg).measure(batch=8, seq_len=2048, steps=steps,
                                   warmup=warmup, repeats=repeats)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    total = warmup + steps * repeats
    e, d, layers = moe_cfg.moe_experts, moe_cfg.d_model, moe_cfg.n_layers
    cap = max(1, int(moe_cfg.moe_capacity_factor * moe_cfg.moe_top_k
                     * 2048 / e))
    emit({"phase": "moe_train", "nvidia_smi": smi,
          "config": {**dataclasses.asdict(moe_cfg),
                     "dtype": str(moe_cfg.dtype)},
          "params": n_params, "batch": 8, "seq_len": 2048,
          "steps_run": total, "repeats": repeats, "launches": launches,
          "max_memory_allocated": peak, "peak_flops": peaks[0],
          "flops_per_token": flops_per_token(moe_cfg, 2048),
          "capacity": cap,
          # the dense dispatch and combine einsums, which flops_per_token
          # leaves out as the reference does: 2·2·E·C·D a token a layer
          "dispatch_combine_flops_per_token": 2 * 2 * e * cap * d * layers,
          "aux_share": m["final_aux"] / m["final_loss"],
          **{k: v for k, v in m.items() if k != "step_stats"},
          "step_stats": m["step_stats"]})
    if not math.isfinite(m["final_loss"]):
        raise AssertionError(f"moe_train: loss not finite "
                             f"({m['final_loss']})")
    for kname, _ in KERNELS:
        if launches[kname] < layers * total:
            raise AssertionError(f"moe_train: {kname} launched "
                                 f"{launches[kname]} times, expected "
                                 f">= {layers * total}")
    if launches["flash_delta"] != launches["flash_bwd_dq"]:
        raise AssertionError(f"moe_train: flash_delta launched "
                             f"{launches['flash_delta']} times, not once "
                             f"per dQ launch")
    return launches, {**m, "steps_run": total}


def jobs_llm_moe_phase(moe_cfg, jobs, smi: str) -> dict:
    """Phase 5a: the ``llm`` entry point with ``--experts 8`` at the bench
    LM's widths, 2 steps and 16 sampled tokens: finite losses, the sample
    in the vocabulary, and every flash kernel launched."""
    from kubeoperator_tpu_torch.workloads import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jobs.main(["llm", "--experts", str(moe_cfg.moe_experts),
                        "--steps", "2", "--vocab", str(moe_cfg.vocab_size),
                        "--d-model", str(moe_cfg.d_model),
                        "--heads", str(moe_cfg.n_heads), "--layers",
                        str(moe_cfg.n_layers), "--d-ff", str(moe_cfg.d_ff),
                        "--seq-len", str(moe_cfg.max_seq_len), "--batch",
                        "8", "--sample", "16"])
    print(out.getvalue(), end="", flush=True)
    if rc != 0:
        raise AssertionError(f"jobs llm --experts returned {rc}")
    records = [json.loads(line) for line in out.getvalue().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    sampled = next(r["sampled_tokens"] for r in records
                   if "sampled_tokens" in r)
    launches = dict(fa.LAUNCHES)
    rec = {"phase": "jobs_llm_moe", "nvidia_smi": smi, "losses": losses,
           "sampled_tokens": sampled, "launches": launches}
    emit(rec)
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"jobs llm --experts: losses {losses}")
    if len(sampled) != 4 + 16 or not all(
            0 <= t < moe_cfg.vocab_size for t in sampled):
        raise AssertionError(f"jobs llm --experts: sample {sampled}")
    if min(launches[k] for k in (*(k for k, _ in KERNELS),
                                 "flash_delta")) == 0:
        raise AssertionError(f"jobs llm --experts: a flash kernel never "
                             f"launched: {launches}")
    return rec


def serve_spec_phase(cfg, model, smi: str, base: dict,
                     base_rows: dict) -> dict:
    """Phase (f): phase (a)'s 32 requests through a ``ContinuousBatcher``
    on a speculative engine (``spec_k`` 4, the first layer as the draft),
    every dispatch under sync-debug "error" and launching no port kernel;
    each sampled row equals its repeat run; each greedy row equals the
    plain pool's row of phase (a) or differs first at a near-tie."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine

    reqs = serve_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                            segment=SERVE_SEGMENT, spec_k=SPEC_K,
                            draft_layers=DRAFT_LAYERS,
                            device=model.embedding.device)
    batcher, stats, results, m = drive(engine, reqs, SERVE_CLIENTS)
    peak = torch.cuda.max_memory_allocated()
    drafted, accepted = engine.spec_draft_tokens, engine.spec_accepted_tokens
    snap = stats.snapshot()
    if (snap["spec_draft_tokens_total"], snap["spec_accepted_tokens_total"]) \
            != (drafted, accepted) or not 0 < accepted <= drafted:
        raise AssertionError(f"serve_spec: counters {drafted}/{accepted}, "
                             f"stats {snap}")
    check_repeats(batcher, reqs, SERVE_SAMPLED, results)
    checks = [{**near_tie(model, i, results[i], base_rows[i], NEAR_TIE),
               "prompt_len": len(reqs[i][0])}
              for i in range(SERVE_REQUESTS) if reqs[i][2] == 0.0]
    rec = {"phase": "serve_spec", "nvidia_smi": smi, "spec_k": SPEC_K,
           "draft_layers": DRAFT_LAYERS, "slots": SERVE_SLOTS,
           "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS, **m,
           "dispatch_ms_median": m["segment_ms_median"],
           "dispatches": m["segments"],
           "spec_draft_tokens": drafted, "spec_accepted_tokens": accepted,
           "acceptance_ratio": accepted / drafted,
           "plain_tokens_per_s": base["tokens_per_s"],
           "tokens_per_s_vs_plain": m["tokens_per_s"] / base["tokens_per_s"],
           "plain_segment_ms_median": base["segment_ms_median"],
           "max_memory_allocated": peak,
           "greedy_vs_plain_pool": checks,
           "near_tie_rows": sum(not c["equal"] for c in checks)}
    emit(rec)
    return rec


def decode_logits(cfg, model, tokens: list, plen: int) -> torch.Tensor:
    """f32 logits after the last of ``tokens`` by solo ``generate()``'s own
    path: one prefill pass over the first ``plen`` (an MoE layer's
    capacity depends on that width), then one token a step."""
    from kubeoperator_tpu_torch.workloads.generate import _decode_loop

    dev = model.embedding.device
    buf = torch.as_tensor([tokens], device=dev)
    shape = (1, cfg.max_seq_len, cfg.n_heads, cfg.head_dim)
    caches = [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
               torch.zeros(shape, dtype=cfg.dtype, device=dev))
              for _ in range(cfg.n_layers)]
    out = {}
    with torch.no_grad():
        out["logits"] = model(buf[:, :plen], torch.arange(plen, device=dev),
                              caches)[0, -1]
        _decode_loop(dataclasses.replace(cfg, decode=True, remat=False),
                     model, caches, buf, range(plen, len(tokens)),
                     lambda logits, pos: out.update(logits=logits[0]))
    return out["logits"].float()


def serve_moe_phase(moe_cfg, smi: str) -> dict:
    """Phase (g): the MoE LM, trained 2 steps from seed 1 as phase 5
    trains the dense one, behind phase (a)'s engine shape and traffic:
    every segment under sync-debug "error" and launching no port kernel,
    ``expert_load().sum()`` exactly slots × top_k × layers × micro-steps
    (at one token a step nothing drops), and the power-of-two greedy rows
    equal to solo ``generate()`` or first different at a near-tie of the
    solo decode's logits."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer

    lt = LMTrainer(moe_cfg)
    state = lt.init_state(seed=1)
    toks = lt.synthetic_batch(8, 2048, seed=1)
    for _ in range(2):
        state, metrics = lt.train_step(state, toks)
    model = state["model"]
    model.zero_grad(set_to_none=True)
    del state, toks
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = serve_requests(moe_cfg.vocab_size)
    engine = SlotPoolEngine(moe_cfg, model, slots=SERVE_SLOTS,
                            segment=SERVE_SEGMENT,
                            device=model.embedding.device)
    batcher, stats, results, m = drive(engine, reqs, SERVE_CLIENTS)
    peak = torch.cuda.max_memory_allocated()
    load = engine.expert_load()
    steps = m["segments"] * SERVE_SEGMENT
    want = SERVE_SLOTS * moe_cfg.moe_top_k * moe_cfg.n_layers * steps
    if float(load.sum()) != want:
        raise AssertionError(f"serve_moe: expert load sums to "
                             f"{float(load.sum())}, not {want}")
    prom = {line.split()[0]: float(line.split()[1])
            for line in stats.prometheus().splitlines()
            if line.startswith("ko_serve_moe_expert_load{")}
    if sorted(prom.values()) != sorted(float(x) for x in load):
        raise AssertionError(f"serve_moe: /metrics load {prom} against "
                             f"{load.tolist()}")
    check_repeats(batcher, reqs, SERVE_SAMPLED, results)
    checks = []
    for i, (prompt, mt, temp, _) in enumerate(reqs):
        if temp or len(prompt) & (len(prompt) - 1):
            continue
        with torch.no_grad():
            solo = generate(moe_cfg, model, [prompt], mt,
                            device=model.embedding.device)[0].tolist()
        checks.append({**near_tie(
            model, i, results[i], solo, NEAR_TIE,
            lambda pre, n=len(prompt): decode_logits(moe_cfg, model, pre, n)),
            "prompt_len": len(prompt), "max_tokens": mt})
    rec = {"phase": "serve_moe", "nvidia_smi": smi,
           "config": {**dataclasses.asdict(moe_cfg),
                      "dtype": str(moe_cfg.dtype)},
           "train_loss": float(metrics["loss"]),
           "slots": SERVE_SLOTS, "segment": SERVE_SEGMENT,
           "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS, **m,
           "micro_steps": steps, "expert_load": load.tolist(),
           "expert_load_sum": float(load.sum()),
           "max_memory_allocated": peak,
           "greedy_pow2_vs_solo": checks,
           "near_tie_rows": sum(not c["equal"] for c in checks)}
    emit(rec)
    return rec


def http_call(url: str, body: dict | None = None) -> tuple[int, str]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read().decode()


def counter_value(text: str, name: str) -> float:
    """The value of the unlabelled counter ``name`` in Prometheus text; a
    counter with no sample yet renders no series and counts 0."""
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def serve_http_phase(cfg, jobs, smi: str) -> dict:
    """Phase (b): the serve entry point with each engine, and the
    continuous one again with int8 pages and a spill tier, with
    speculation (``--spec-k 4 --draft-layers 1``) and over an MoE model
    (``--moe 8``), on a free local port, at the bench LM's widths (fresh
    weights); each /metrics carries its engine's families."""
    widths = ["--vocab", str(cfg.vocab_size), "--d-model", str(cfg.d_model),
              "--heads", str(cfg.n_heads), "--layers", str(cfg.n_layers),
              "--d-ff", str(cfg.d_ff), "--max-seq-len", str(cfg.max_seq_len),
              "--host", "127.0.0.1", "--port", "0"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 33, 64, 100)]
    out = {}
    for label, engine, flags, n in (
            ("continuous", "continuous", [], 4), ("dynamic", "dynamic", [], 2),
            ("continuous_int8_spill", "continuous",
             ["--kv-dtype", "int8", "--spill-pages", "64"], 4),
            ("continuous_spec", "continuous",
             ["--spec-k", str(SPEC_K), "--draft-layers", str(DRAFT_LAYERS)],
             4),
            ("continuous_moe", "continuous", ["--moe", "8"], 4)):
        args = jobs.build_parser().parse_args(["serve", "--engine", engine,
                                               *widths, *flags])
        t0 = time.perf_counter()
        server, batcher = jobs.build_server(args)
        up_s = time.perf_counter() - t0
        # the serve job's stats live on the process registry, which every
        # server of this process shares: counts are read as deltas
        base = batcher.stats.snapshot()["requests_total"]
        base_text = counter_value(batcher.stats.prometheus(),
                                  "ko_serve_requests_total")
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
                    raise AssertionError(f"serve {label}: bad reply {i}: "
                                         f"{status} {body[:200]}")
            health = http_call(url + "/healthz")
            stats = json.loads(http_call(url + "/stats")[1])
            metrics = http_call(url + "/metrics")[1]
            if health[0] != 200 or stats["requests_total"] - base != n:
                raise AssertionError(f"serve {label}: healthz {health}, "
                                     f"stats {stats} (requests before: "
                                     f"{base})")
            if (counter_value(metrics, "ko_serve_requests_total")
                    - base_text != n):
                raise AssertionError(f"serve {label}: /metrics does not "
                                     f"count {n} more ko_serve_requests_total")
            family = {"continuous_spec": "ko_serve_spec_draft_tokens_total ",
                      "continuous_moe": "ko_serve_moe_expert_load{"}.get(
                          label)
            if family and family not in metrics:
                raise AssertionError(f"serve {label}: /metrics lacks "
                                     f"{family.strip()}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        out[label] = {"requests": n, "build_s": up_s, "answer_s": answer_s,
                      "flags": flags,
                      "new_tokens": [json.loads(b)["new_tokens"]
                                     for _, b in replies.values()],
                      "stats": stats}
    emit({"phase": "serve_http", "nvidia_smi": smi, **out})
    return out


def cluster_instrument(engines: list, strict: bool) -> dict:
    """Wrap every device call of ``engines`` (the gateway's replicas and
    its prefill worker's engine) in place. ``strict``: the calls of all
    of them take one lock, and every segment runs under
    ``torch.cuda.set_sync_debug_mode("error")`` while it holds it. The
    mode is the process's, not a thread's, so without the lock another
    replica's retirement fetch would trip it; with it, no segment syncs
    and no other call runs meanwhile. Counts the segments either way."""
    rec = {"segments": 0}
    lock = threading.RLock()
    for eng in engines:
        for name in ("admit", "run_segment", "poll", "release",
                     "export_prefix", "import_prefix"):
            call = getattr(eng, name)

            def wrapped(*a, _call=call, _seg=name == "run_segment", **kw):
                with lock if strict else contextlib.nullcontext():
                    if not _seg:
                        return _call(*a, **kw)
                    rec["segments"] += 1
                    if strict:
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        return _call(*a, **kw)
                    finally:
                        if strict:
                            torch.cuda.set_sync_debug_mode("default")

            setattr(eng, name, wrapped)
    return rec


def release_pools(engines) -> None:
    """Free the page pools of engines whose batchers are done. A
    batcher's worker thread idles for the life of the process and keeps
    its engine object; the later phases need the pages' device memory."""
    for eng in engines:
        eng._pools = []
    gc.collect()
    torch.cuda.empty_cache()


def serve_cluster_phase(cfg, model, smi: str, base: dict) -> dict:
    """Phase (h): the cluster tier at the bench LM's width with phase 5's
    weights. (0) The tracer's cost: phase (a)'s traffic behind one
    batcher with the tracer off, on, on, off (tokens/s; reported, not
    gated). Then two ``SlotPoolEngine(slots=16, segment=8)`` replicas
    and a third engine behind a ``PrefillWorker``, all behind one
    ``ServeGateway`` (sticky prefix, a ``ServeTracer``; prompts of more
    than ``PREFIX_LEN`` tokens hand their pages off): (1) phase (a)'s
    traffic from 8 clients: tokens/s and TTFT beside phase (a)'s one
    replica; (2) its first ``CLUSTER_DRAIN_REQUESTS`` requests again,
    ``drain_replica(0)`` once replica 0 holds ``CLUSTER_DRAIN_AT`` rows
    mid-decode, then ``readmit_replica(0)``: requeued requests and the
    drain's wall time; (3) ``CLUSTER_HANDOFFS`` of serve_prefix's cover
    and partial requests (greedy), each handed off: pages and seconds a
    handoff. Runs (2) and (3) check every segment under sync-debug
    "error" (run (1) is timed without the lock that needs); no port
    kernel may launch; every greedy reply equals solo ``generate()`` or
    differs first at a near-tie; every retired request's tree is
    complete and its critical path tiles its duration."""
    from kubeoperator_tpu_torch.cluster import PrefillWorker, ServeGateway
    from kubeoperator_tpu_torch.telemetry.serve_trace import (
        ServeTracer, ServeTraceStore, critical_path, render_record,
    )
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.serving import (
        BatcherStats, ContinuousBatcher,
    )

    t_phase = time.perf_counter()
    dev = model.embedding.device

    def build(strict: bool):
        engines = [SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                                  segment=SERVE_SEGMENT, device=dev)
                   for _ in range(2)]
        prefill = SlotPoolEngine(cfg, model, slots=1, segment=SERVE_SEGMENT,
                                 device=dev)
        seg = cluster_instrument([*engines, prefill], strict)
        batchers = [ContinuousBatcher(e, stats=BatcherStats())
                    for e in engines]
        store = ServeTraceStore(max_records=1024)
        gw = ServeGateway(batchers, policy="sticky_prefix",
                          prefill_worker=PrefillWorker(prefill),
                          handoff_min_pages=PREFIX_LEN // engines[0].page
                          + 1, tracer=ServeTracer(store))
        return gw, batchers, store, seg, [*engines, prefill]

    reqs = serve_requests(cfg.vocab_size)
    tokens = sum(mt for _, mt, _, _ in reqs)
    reset_port_launches()
    out: dict = {}
    # (0) the tracer's cost: phase (a)'s engine and traffic behind one
    # batcher, off, on, on, off
    overhead = {"off": [], "on": []}
    for arm in ("off", "on", "on", "off"):
        engine = SlotPoolEngine(cfg, model, slots=SERVE_SLOTS,
                                segment=SERVE_SEGMENT, device=dev)
        store = ServeTraceStore(max_records=len(reqs))
        batcher = ContinuousBatcher(engine, tracer=(
            ServeTracer(store) if arm == "on" else None))
        t0 = time.perf_counter()
        run_clients(batcher.submit, reqs, SERVE_CLIENTS)
        overhead[arm].append(tokens / (time.perf_counter() - t0))
        if arm == "on" and len(store.records()) != len(reqs):
            raise AssertionError("serve_cluster: the tracer kept "
                                 f"{len(store.records())} trees")
        release_pools([engine])
    out["trace_overhead"] = {
        "tokens_per_s": overhead,
        "on_over_off": statistics.median(overhead["on"])
        / statistics.median(overhead["off"])}
    # (1) throughput through the gateway
    gw, batchers, store, seg, engines = build(strict=False)
    t0 = time.perf_counter()
    replies = {"throughput": run_clients(gw.submit, reqs, SERVE_CLIENTS)}
    wall = time.perf_counter() - t0
    out["throughput"] = {
        "requests": len(reqs), "clients": SERVE_CLIENTS, "wall_s": wall,
        "generated_tokens": tokens, "tokens_per_s": tokens / wall,
        "one_replica_tokens_per_s": base["tokens_per_s"],
        "ttft_p50_s": gw.stats.ttft_quantile(0.5),
        "ttft_p95_s": gw.stats.ttft_quantile(0.95),
        "one_replica_ttft_p50_s": base["ttft_p50_s"],
        "one_replica_ttft_p95_s": base["ttft_p95_s"],
        "segments": seg["segments"], "gateway": gw.snapshot(),
        "per_replica_requests": [b.stats.snapshot()["requests_total"]
                                 for b in batchers]}
    traces = [render_record(r) for r in store.records()]
    release_pools(engines)
    # (2) a drain mid-decode, then the readmit, under the strict checks
    gw, batchers, store, seg, engines = build(strict=True)
    dreqs = reqs[:CLUSTER_DRAIN_REQUESTS]
    box: dict = {}
    clients = threading.Thread(target=lambda: box.update(
        r=run_clients(gw.submit, dreqs, SERVE_CLIENTS)))
    clients.start()
    deadline = time.monotonic() + 600.0
    while len(batchers[0]._track) < CLUSTER_DRAIN_AT:
        if time.monotonic() > deadline or not clients.is_alive():
            raise AssertionError("serve_cluster: replica 0 never held "
                                 f"{CLUSTER_DRAIN_AT} rows")
        time.sleep(0.001)
    in_flight = len(batchers[0]._track)
    t0 = time.perf_counter()
    requeued = gw.drain_replica(0)
    drain_s = time.perf_counter() - t0
    gw.readmit_replica(0)
    clients.join(timeout=900.0)
    if "r" not in box:
        raise AssertionError("serve_cluster: the drained run did not finish")
    replies["drain"] = box["r"]
    snap = gw.snapshot()
    drain_segments = seg["segments"]
    out["drain"] = {"requests": len(dreqs),
                    "in_flight_on_replica_0": in_flight,
                    "requeued": len(requeued), "drain_s": drain_s,
                    "routed": snap["routed"],
                    "requeued_total": snap["requeued_total"],
                    "segments": drain_segments,
                    "sync_debug_mode": "error",
                    "requests_requeued_total": gw.stats.snapshot()[
                        "requests_requeued_total"]}
    if not requeued:
        raise AssertionError("serve_cluster: the drain requeued nothing")
    # (3) handoffs: serve_prefix's shared system prompt and tails
    system, kinds, tails = prefix_traffic(cfg.vocab_size)
    page = batchers[0].engine.page
    picked = [i for kind in ("cover", "partial") for i in [
        j for j, k in enumerate(kinds)
        if k == kind and len(tails[j][0]) >= page][:CLUSTER_HANDOFFS // 2]]
    hreqs = [(system + tails[i][0], tails[i][1], 0.0, i) for i in picked]
    before = gw.snapshot()["handoff_pages"]
    t0 = time.perf_counter()
    replies["handoff"] = run_clients(gw.submit, hreqs, len(hreqs) // 2)
    handoff_wall = time.perf_counter() - t0
    launches = port_launches()
    torch.cuda.synchronize()
    if any(launches.values()):
        raise AssertionError(f"serve_cluster: port kernels launched: "
                             f"{launches}")
    traces += [render_record(r) for r in store.records()]
    prefix_hits = sum(b.engine.prefix_hits for b in batchers)
    release_pools(engines)
    hand = [s["duration_s"] for t in traces for s in t["spans"]
            if s["name"] == "handoff"]
    pages = gw.snapshot()["handoff_pages"] - before
    out["handoff"] = {"requests": len(hreqs), "kinds": [kinds[i]
                                                        for i in picked],
                      "prompt_lens": [len(r[0]) for r in hreqs],
                      "wall_s": handoff_wall, "handoffs": len(hand),
                      "pages": pages,
                      "seconds_per_handoff": (statistics.median(hand)
                                              if hand else None),
                      "prefix_hits": prefix_hits,
                      "segments": seg["segments"] - drain_segments}
    if not pages or not hand:
        raise AssertionError(f"serve_cluster: no pages handed off "
                             f"({pages} pages, {len(hand)} spans)")
    # every retired request's tree
    bad = []
    for t in traces:
        names = {s["name"] for s in t["spans"]}
        cp = critical_path(t)
        if not {"request", "gateway", "enqueue", "admit", "segment",
                "retire"} <= names or cp["status"] != "ok" or abs(
                    sum(cp["phases"].values()) + cp["unattributed"]
                    - cp["duration_s"]) > 1e-5:
            bad.append({"request": t["request"], "spans": sorted(names),
                        "critical_path": cp})
    if bad or len(traces) != len(reqs) + len(dreqs) + len(hreqs):
        raise AssertionError(f"serve_cluster: {len(traces)} trees, "
                             f"incomplete: {bad[:3]}")
    out["traces"] = {"trees": len(traces), "with_hop": sum(
        any(s["name"] == "hop" for s in t["spans"]) for t in traces),
        "critical_path_s_sum": {
            k: sum(critical_path(t)["phases"].get(k, 0.0) for t in traces)
            for k in ("gateway_wait", "replica_queue", "admit", "prefill",
                      "handoff", "decode", "host_blocked", "hop")}}
    # greedy replies against solo generate(), near-tie rule
    checks, solo = [], {}
    for run, rs in (("throughput", reqs), ("drain", dreqs),
                    ("handoff", hreqs)):
        for i, (prompt, mt, temp, _) in enumerate(rs):
            row = replies[run][i]
            if len(row) != len(prompt) + mt or row[:len(prompt)] != prompt:
                raise AssertionError(f"serve_cluster {run}: request {i} "
                                     f"came back malformed")
            if temp:
                continue
            key = (len(prompt), tuple(prompt[-8:]), mt)
            if key not in solo:
                with torch.no_grad():
                    solo[key] = generate(cfg, model, [prompt], mt,
                                         device=dev)[0].tolist()
            checks.append({**near_tie(model, i, row, solo[key], NEAR_TIE),
                           "run": run})
    out["greedy_vs_solo"] = {"rows": len(checks), "near_tie_rows": [
        c for c in checks if not c["equal"]]}
    rec = {"phase": "serve_cluster", "nvidia_smi": smi, "replicas": 2,
           "slots": SERVE_SLOTS, "segment": SERVE_SEGMENT,
           "launches": launches, **out,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def run_job(jobs, argv: list) -> tuple[int, list[dict]]:
    """A job through its entry point, its records captured and echoed:
    (exit code, records)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jobs.main(argv)
    print(out.getvalue(), end="", flush=True)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


def http_get(url: str) -> tuple[int, str]:
    """(status, body) of one GET, error statuses included."""
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def jobs_smoke_phase(jobs, smi: str) -> dict:
    """The smoke job: a 256×256 bf16 matmul of ones on the card must sum
    to 256³."""
    rc, records = run_job(jobs, ["smoke"])
    rec = records[-1]
    emit({"phase": "jobs_smoke", "nvidia_smi": smi, "rc": rc, "record": rec})
    if rc != 0 or not rec["ok"] or rec["matmul_sum"] != 16_777_216.0:
        raise AssertionError(f"jobs smoke: rc {rc}, {rec}")
    return rec


def jobs_mnist_phase(jobs, smi: str) -> dict:
    """The mnist job at its defaults (30 steps of a depth-18 ResNet in f32
    on one batch of 128 28² images): exit 0 with the loss improved; a
    step's seconds are the median gap between step starts (each step ends
    on a host read of its loss)."""
    from kubeoperator_tpu_torch.workloads.train import Trainer

    starts = []
    step = Trainer.train_step

    def timed(self, *a):
        starts.append(time.perf_counter())
        return step(self, *a)

    Trainer.train_step = timed
    t0 = time.perf_counter()
    try:
        rc, records = run_job(jobs, ["mnist"])
    finally:
        Trainer.train_step = step
    seconds = time.perf_counter() - t0
    done = records[-1]
    gaps = [b - a for a, b in zip(starts, starts[1:])]
    rec = {"phase": "jobs_mnist", "nvidia_smi": smi, "rc": rc,
           "seconds": seconds, "steps": done["steps"],
           "seconds_per_step": statistics.median(gaps),
           "first_step_seconds": gaps[0],
           **{k: done[k] for k in ("first_loss", "last_loss", "improved")}}
    emit(rec)
    if rc != 0 or not done["improved"] or done["steps"] != 30:
        raise AssertionError(f"jobs mnist: rc {rc}, {done}")
    return rec


def jobs_metrics_phase(jobs, smi: str) -> dict:
    """The llm job at a tiny depth (one layer of the default width, 256
    tokens) with ``--metrics-port`` on a free port: after the job, its
    daemon server answers ``/metrics`` with the process registry (the
    ko_train_* families declared) and ``/nope`` with 404; then it is shut
    down."""
    servers = []
    start = jobs.maybe_start_metrics_server

    def keep(port):
        servers.append(start(port))
        return servers[-1]

    port = free_port()
    jobs.maybe_start_metrics_server = keep
    try:
        rc, records = run_job(jobs, ["llm", "--steps", "2", "--layers", "1",
                                     "--seq-len", "256", "--batch", "2",
                                     "--metrics-port", str(port)])
        status, text = http_get(f"http://127.0.0.1:{port}/metrics")
        missing = http_get(f"http://127.0.0.1:{port}/nope")[0]
    finally:
        jobs.maybe_start_metrics_server = start
        for server in servers:
            server.shutdown()
            server.server_close()
    rec = {"phase": "jobs_metrics", "nvidia_smi": smi, "rc": rc,
           "port": port, "metrics_status": status, "nope_status": missing,
           "families": re.findall(r"^# TYPE (ko_train_\S+) (\S+)$", text,
                                  re.M),
           "losses": [r["loss"] for r in records if "loss" in r]}
    emit(rec)
    if (rc != 0 or status != 200 or missing != 404
            or "# TYPE ko_train_step_seconds histogram" not in text):
        raise AssertionError(f"jobs metrics: {rec}")
    return rec


def jobs_ckpt_phase(cfg, jobs, smi: str) -> dict:
    """Checkpoint and resume through the jobs, in a directory under
    ``build/`` removed after. (a) The resnet50 job at its defaults (batch
    64) with ``--ckpt-every 1``: 2 steps, then a rerun to 3 that resumes
    at 2. (b) The llm job at the bench LM's widths (batch 8): 2 steps,
    checkpointed at the end. (c) ``build_server --ckpt-dir`` at those
    widths announces ``checkpoint step 2``, and a greedy ``/generate``
    equals ``generate()`` on the checkpoint restored here, token for token
    (a 64-token prompt and 16 new tokens, so the dynamic batcher's bucket
    is the call made here). Checkpoint bytes, save and restore seconds."""
    from kubeoperator_tpu_torch.workloads.checkpoint import (
        WorkloadCheckpointer,
    )
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.serving import plan_bucket
    from kubeoperator_tpu_torch.workloads.transformer import (
        TransformerConfig,
    )

    # the model as the llm and serve jobs build it from these widths
    job_cfg = TransformerConfig(vocab_size=cfg.vocab_size,
                                d_model=cfg.d_model, n_heads=cfg.n_heads,
                                n_layers=cfg.n_layers, d_ff=cfg.d_ff,
                                max_seq_len=cfg.max_seq_len)
    saves = []
    save = WorkloadCheckpointer.save

    def timed_save(self, step, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, step, state)
        saves.append({"dir": Path(self.directory).name, "step": step,
                      "seconds": time.perf_counter() - t0,
                      "bytes": Path(self.path(step)).stat().st_size})

    widths = ["--vocab", str(cfg.vocab_size), "--d-model", str(cfg.d_model),
              "--heads", str(cfg.n_heads), "--layers", str(cfg.n_layers),
              "--d-ff", str(cfg.d_ff)]
    (ROOT / "build").mkdir(exist_ok=True)
    WorkloadCheckpointer.save = timed_save
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            rn = str(Path(tmp) / "resnet50")
            resnet = ["resnet50", "--batch-per-chip", "64", "--ckpt-dir", rn,
                      "--ckpt-every", "1"]
            rc1, first = run_job(jobs, [*resnet, "--steps", "2"])
            rc2, again = run_job(jobs, [*resnet, "--steps", "3"])
            resnet_steps = WorkloadCheckpointer(rn).steps()
            llm_dir = str(Path(tmp) / "llm")
            rc3, lm_records = run_job(jobs, [
                "llm", "--steps", "2", *widths, "--seq-len",
                str(cfg.max_seq_len), "--batch", "8", "--ckpt-dir", llm_dir])
            state = LMTrainer(job_cfg).init_state(seed=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            WorkloadCheckpointer(llm_dir).restore(state)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            model = state["model"].eval()
            del state
            gc.collect()
            out = io.StringIO()
            args = jobs.build_parser().parse_args([
                "serve", *widths, "--max-seq-len", str(cfg.max_seq_len),
                "--ckpt-dir", llm_dir, "--host", "127.0.0.1", "--port", "0"])
            with contextlib.redirect_stdout(out):
                server, _ = jobs.build_server(args)
            print(out.getvalue(), end="", flush=True)
            announced = json.loads(out.getvalue().splitlines()[0])
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            prompt = np.random.default_rng(2).integers(
                0, cfg.vocab_size, 64).tolist()
            try:
                status, body = http_call(
                    f"http://127.0.0.1:{server.server_address[1]}/generate",
                    {"prompt_ids": prompt, "max_tokens": 16})
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=60)
            p, n, prefill = plan_bucket([64], [16], cfg.max_seq_len)
            want = generate(job_cfg, model, [prompt + [0] * (p - 64)], n,
                            temperature=0.0, seed=0, prompt_lens=[64],
                            prefill_len=prefill)[0, :64 + 16].tolist()
            del model
    finally:
        WorkloadCheckpointer.save = save
    got = json.loads(body)["tokens"] if status == 200 else None
    rec = {"phase": "jobs_ckpt", "nvidia_smi": smi,
           "resnet50": {"rc": [rc1, rc2], "resumed": again[0],
                        "done": again[-1], "kept_steps": resnet_steps},
           "llm": {"rc": rc3, "done": lm_records[-1]},
           "saves": saves, "llm_restore_seconds": restore_s,
           "serve_weights": announced.get("weights"),
           "generate_equal": got == want, "tokens": got, "want": want}
    emit(rec)
    if (rc1 or rc2 or rc3 or again[0] != {"job": "resnet50", "resumed_at": 2}
            or again[-1]["steps"] != 3 or lm_records[-1]["steps"] != 2):
        raise AssertionError(f"jobs ckpt: the jobs did not resume: {rec}")
    if announced.get("weights") != "checkpoint step 2" or got != want:
        raise AssertionError(f"jobs ckpt: serve --ckpt-dir: {rec}")
    return rec


def resnet_dot2_phase(rcfg, smi: str, resnet_ms: float, conv_launches,
                      reset_conv) -> dict:
    """ResNet-50 in the K7/K8 configuration with ``conv_bwd="dot2"`` and
    ``fused_bn=False``: a few measured steps, a finite loss, no K7/K8 and
    no flash launch; its step ms beside ``resnet_train``'s."""
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    from kubeoperator_tpu_torch.workloads.train import Trainer

    cfg = dataclasses.replace(rcfg, conv_bwd="dot2", fused_bn=False)
    fa.reset_launches()
    reset_conv()
    m = Trainer(cfg).measure(batch=cfg.batch_size, steps=2, warmup=1,
                             steps_per_call=8, repeats=3)
    launches = {**conv_launches(), **fa.LAUNCHES}
    rec = {"phase": "resnet_dot2", "nvidia_smi": smi,
           "config": {**dataclasses.asdict(cfg), "dtype": str(cfg.dtype)},
           "launches": launches, "resnet_train_step_time_ms": resnet_ms,
           **{k: v for k, v in m.items() if k != "step_stats"},
           "step_stats": m["step_stats"]}
    emit(rec)
    if not math.isfinite(m["final_loss"]) or any(launches.values()):
        raise AssertionError(f"resnet_dot2: loss {m['final_loss']}, "
                             f"launches {launches}")
    return rec


def aot_bringup_arm(cache_dir: str, out: str) -> None:
    """One arm of aot_bringup, run in a process of its own: under
    ``compile_count_guard``, ``Trainer(RESNET_K7_K8,
    compile_cache=CompileCache(cache_dir))`` built and stepped once on the
    card. Writes to ``out`` the nvcc builds the guard counted, the
    bring-up seconds (from construction to the first kernel launch; each
    wrapper loads its library just before it launches), the first step's
    seconds, the launches, the loss and its bits, the cache's result, and
    the file the wrappers' ``conv_bwd`` library was opened from."""
    from kubeoperator_tpu_torch import kernels
    from kubeoperator_tpu_torch.analysis import compile_count_guard
    from kubeoperator_tpu_torch.aot import CompileCache
    from kubeoperator_tpu_torch.profile_lm import RESNET_K7_K8
    from kubeoperator_tpu_torch.workloads import bn_fused, conv_vjp
    from kubeoperator_tpu_torch.workloads.train import Trainer

    first_launch: list[float] = []
    load = kernels.load

    def timed_load(name):
        if not first_launch:
            first_launch.append(time.perf_counter())
        return load(name)

    kernels.load = timed_load
    torch.zeros(1, device="cuda")              # the context, before t0
    with compile_count_guard() as guard:
        t0 = time.perf_counter()
        tr = Trainer(RESNET_K7_K8, compile_cache=CompileCache(cache_dir))
        state = tr.init_state()
        state, metrics = tr.train_step(state, *tr.synthetic_batch())
        loss = float(metrics["loss"])
        step_s = time.perf_counter() - t0
    path = kernels.loaded_path("conv_bwd")
    Path(out).write_text(json.dumps({
        "compiles": guard.total(), "builds": guard.by_function(),
        "bringup_s": first_launch[0] - t0, "first_step_s": step_s,
        "loss": loss, "loss_hex": loss.hex(),
        "launches": {**conv_vjp.LAUNCHES, **bn_fused.LAUNCHES},
        "aot": {"hit": tr.aot.hit, "source": tr.aot.source,
                "fingerprint": tr.aot.fingerprint,
                "seconds": tr.aot.seconds,
                "libraries": [{"name": r.name, "hit": r.hit,
                               "source": r.source, "path": r.path,
                               "seconds": r.seconds}
                              for r in tr.aot.libraries]},
        "loaded_path": str(path), "artifact_bytes": path.stat().st_size}))


def aot_bringup_phase(smi: str) -> dict:
    """The compile cache on the card, the counterpart of
    ``scripts/bench_serving.py::bench_bringup``: ``aot_bringup_arm`` in a
    fresh process against an empty cache under ``build/`` (cold: two nvcc
    builds, ``conv_bwd`` and ``batch_norm``), then in another against the
    same cache (warm: none). Both arms launch K7 24 times and each K8 kernel 9 times from
    the cache's library and give the same loss bits. Then the slot pool
    with ``compile_cache=``: ``source`` "none", nothing written, and its
    greedy rows equal to the same engine's without a cache."""
    from kubeoperator_tpu_torch.aot import CompileCache

    t0 = time.perf_counter()
    cache_dir = ROOT / "build" / "aot_smoke"
    shutil.rmtree(cache_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    arms = {}
    for arm in ("cold", "warm"):
        out = ROOT / "build" / f"aot_smoke_{arm}.json"
        out.unlink(missing_ok=True)
        proc = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke."
             f"aot_bringup_arm({str(cache_dir)!r}, {str(out)!r})"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"aot_bringup {arm}: rc {proc.returncode}"
                                 f"\n{proc.stderr[-4000:]}")
        arms[arm] = json.loads(out.read_text())
    cold, warm = arms["cold"], arms["warm"]
    plain = pool_run({})
    cached = pool_run({}, compile_cache=CompileCache(str(cache_dir)))
    entries = [r["name"] for r in CompileCache(str(cache_dir)).entries()]
    serve = {"source": cached["aot"].source, "hit": cached["aot"].hit,
             "libraries": len(cached["aot"].libraries),
             "rows_equal": cached["rows"] == plain["rows"],
             "cache_entries_after": entries}
    rec = {"phase": "aot_bringup", "nvidia_smi": smi,
           "cold": cold, "warm": warm,
           "bringup_speedup": cold["bringup_s"] / warm["bringup_s"],
           "artifact_bytes": warm["artifact_bytes"], "serve": serve,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    bad = []
    if cold["compiles"] != 2 or set(cold["builds"]) != {"conv_bwd",
                                                         "batch_norm"}:
        bad.append(f"cold arm built {cold['builds']}, not conv_bwd and "
                   f"batch_norm once each")
    if warm["compiles"] != 0:
        bad.append(f"warm arm built {warm['builds']}")
    if (cold["aot"]["hit"], cold["aot"]["source"]) != (False, "compile"):
        bad.append(f"cold arm: {cold['aot']}")
    if (warm["aot"]["hit"], warm["aot"]["source"]) != (True, "cache"):
        bad.append(f"warm arm: {warm['aot']}")
    for arm in (cold, warm):
        if arm["launches"] != RESNET_STEP_LAUNCHES:
            bad.append(f"launches {arm['launches']}, not "
                       f"{RESNET_STEP_LAUNCHES}")
        if Path(arm["loaded_path"]) != Path(
                arm["aot"]["libraries"][0]["path"]).resolve():
            bad.append(f"the wrappers launched {arm['loaded_path']}, not "
                       f"the cache's library")
    if cold["loss_hex"] != warm["loss_hex"]:
        bad.append(f"loss {cold['loss']} cold, {warm['loss']} warm")
    if (serve["source"], serve["hit"], serve["libraries"]) != ("none", True,
                                                                0):
        bad.append(f"serve engine: {serve}")
    if not serve["rows_equal"] or sorted(entries) != ["batch_norm",
                                                       "conv_bwd"]:
        bad.append(f"serve engine: {serve}")
    if bad:
        raise AssertionError(f"aot_bringup: {bad}")
    return rec


@contextlib.contextmanager
def torchrun_env():
    """The environment ``torchrun`` gives rank 0 of a world of one (a free
    local port), and the process group the job joins from it destroyed,
    and the environment restored, after."""
    import os

    import torch.distributed as dist

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_smoke_phase(jobs, smi: str) -> dict:
    """The smoke job joining an NCCL group from ``torchrun``'s
    environment (one rank: this process, one card): the matmul sums to
    256³ and the psum equals the world's size. Leaves the group joined
    for ``dist_llm``."""
    import torch.distributed as dist

    rc, records = run_job(jobs, ["smoke"])
    rec = records[-1]
    backend = dist.get_backend() if dist.is_initialized() else None
    emit({"phase": "dist_smoke", "nvidia_smi": smi, "rc": rc,
          "backend": backend, "record": rec})
    if (rc != 0 or not rec["ok"] or backend != "nccl"
            or rec["psum"] != float(rec["num_processes"])
            or rec["num_processes"] != dist.get_world_size()):
        raise AssertionError(f"dist_smoke: rc {rc}, backend {backend}, "
                             f"{rec}")
    return rec


def dist_llm_phase(cfg, jobs, smi: str, train: dict, steps: int) -> dict:
    """The llm job at the bench LM's widths (batch 8 × 2,048) through
    ``--mesh dp:auto`` in the NCCL group ``dist_smoke`` joined, as many
    steps as phase ``train`` ran from the same seeded weights and batch:
    K1-K3 each at least once a layer and step, every loss finite, the last
    one within ``TOL`` of ``train``'s final loss (the job's config leaves
    the logits f32, ``train``'s takes them from bf16 operands), step ms
    and MFU beside ``train``'s."""
    from kubeoperator_tpu_torch.workloads import flash_attention as fa

    fa.reset_launches()
    rc, records = run_job(jobs, [
        "llm", "--mesh", "dp:auto", "--steps", str(steps), "--d-model",
        str(cfg.d_model), "--heads", str(cfg.n_heads), "--layers",
        str(cfg.n_layers), "--d-ff", str(cfg.d_ff), "--seq-len",
        str(cfg.max_seq_len), "--batch", "8"])
    launches = dict(fa.LAUNCHES)
    losses = [r["loss"] for r in records if "loss" in r]
    done = records[-1]
    want = train["final_loss"]
    emit({"phase": "dist_llm", "nvidia_smi": smi, "rc": rc,
          "mesh": done.get("mesh"), "num_processes": done.get(
              "num_processes"), "steps": done.get("steps"),
          "launches": launches, "losses": losses,
          "train_final_loss": want, "step_time_ms": done.get("step_time_ms"),
          "mfu": done.get("mfu"), "train_step_time_ms": train["step_time_ms"],
          "train_mfu": train["mfu"]})
    if rc != 0 or not done.get("done") or done["steps"] != steps:
        raise AssertionError(f"dist_llm: rc {rc}, {done}")
    for kname, _ in KERNELS:
        if launches[kname] < cfg.n_layers * steps:
            raise AssertionError(f"dist_llm: {kname} launched "
                                 f"{launches[kname]} times, expected >= "
                                 f"{cfg.n_layers * steps}")
    if not (losses and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"dist_llm: losses {losses}")
    if abs(losses[-1] - want) > TOL["atol"] + TOL["rtol"] * abs(want):
        raise AssertionError(f"dist_llm: final loss {losses[-1]}, train's "
                             f"{want}")
    return done


def dist_resnet_phase(rcfg, jobs, smi: str, train: dict, settings: dict,
                      conv_launches, reset_conv) -> dict:
    """ResNet-50 in the K7/K8 configuration through ``Trainer(rcfg,
    MeshSpec(dp=1))`` in the NCCL group ``dist_smoke`` joined, measured as
    ``resnet_train`` was (``settings``) from the same seeded weights and
    batch: K7 at least 24 and each K8 kernel 9 launches a step, the final
    loss within ``TOL`` of ``resnet_train``'s, step ms beside it. Then the
    resnet50 job with ``--mesh dp:auto --ckpt-dir``: 2 steps, and a rerun
    to 3 that resumes at 2."""
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
    from kubeoperator_tpu_torch.workloads.train import Trainer

    reset_conv()
    trainer = Trainer(rcfg, MeshSpec(dp=1))
    m = trainer.measure(batch=rcfg.batch_size, **settings)
    launches = conv_launches()
    steps = (settings["warmup"] + settings["steps"] * settings["repeats"]
             ) * settings["steps_per_call"]
    want = train["final_loss"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        job = ["resnet50", "--mesh", "dp:auto", "--batch-per-chip", "64",
               "--ckpt-dir", tmp]
        rc1, first = run_job(jobs, [*job, "--steps", "2"])
        rc2, again = run_job(jobs, [*job, "--steps", "3"])
    rec = {"phase": "dist_resnet", "nvidia_smi": smi, "mesh": m["mesh"],
           "steps_run": steps, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "final_loss": m["final_loss"], "resnet_train_final_loss": want,
           "step_time_ms": m["step_time_ms"],
           "resnet_train_step_time_ms": train["step_time_ms"],
           "img_per_sec_per_chip": m["img_per_sec_per_chip"],
           "mfu": m["mfu"], "step_stats": m["step_stats"],
           "job": {"rc": [rc1, rc2], "resumed": again[0] if again else None,
                   "done": again[-1] if again else None}}
    emit(rec)
    per_step = {"conv1x1_bwd_dx": 24, "conv1x1_bwd_dw": 24,
                "bn_bwd_stats": 9, "bn_bwd_dx": 9, "bn_bwd_dw": 9}
    for kname, k in per_step.items():
        if launches[kname] < k * steps:
            raise AssertionError(f"dist_resnet: {kname} launched "
                                 f"{launches[kname]} times, expected >= "
                                 f"{k * steps}")
    if not abs(m["final_loss"] - want) <= TOL["atol"] + TOL["rtol"] * abs(
            want):
        raise AssertionError(f"dist_resnet: final loss {m['final_loss']}, "
                             f"resnet_train's {want}")
    if (rc1 or rc2 or again[0] != {"job": "resnet50", "resumed_at": 2}
            or again[-1]["steps"] != 3 or again[-1]["mesh"]["dp"] != 1):
        raise AssertionError(f"dist_resnet: the job did not resume: {rec}")
    return rec


def dist_vit_phase(vcfg, smi: str, train: dict, settings: dict) -> dict:
    """ViT-B/16 through ``ViTTrainer(vcfg)`` (dp over the world) in the
    NCCL group ``dist_smoke`` joined, measured as ``vit_train`` was
    (``settings``): K4-K6 each at least once a layer (12) and step, K1-K3
    never, the final loss within ``TOL`` of ``vit_train``'s, step ms
    beside it."""
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    from kubeoperator_tpu_torch.workloads.vit import ViTTrainer

    fa.reset_launches()
    m = ViTTrainer(vcfg).measure(**settings)
    launches = dict(fa.LAUNCHES)
    steps = (settings["warmup"] + settings["steps"] * settings["repeats"]
             ) * settings["steps_per_call"]
    want = train["final_loss"]
    rec = {"phase": "dist_vit", "nvidia_smi": smi, "mesh": m["mesh"],
           "steps_run": steps, "launches": launches,
           "final_loss": m["final_loss"], "vit_train_final_loss": want,
           "step_time_ms": m["step_time_ms"],
           "vit_train_step_time_ms": train["step_time_ms"],
           "img_per_sec_per_chip": m["img_per_sec_per_chip"],
           "mfu": m["mfu"], "step_stats": m["step_stats"]}
    emit(rec)
    n_layers = vcfg.encoder.n_layers
    for kname, _ in PACKED_KERNELS:
        if launches[kname] < n_layers * steps:
            raise AssertionError(f"dist_vit: {kname} launched "
                                 f"{launches[kname]} times, expected >= "
                                 f"{n_layers * steps}")
    if any(launches[k] for k, _ in KERNELS):
        raise AssertionError(f"dist_vit: K1-K3 launched: {launches}")
    if not abs(m["final_loss"] - want) <= TOL["atol"] + TOL["rtol"] * abs(
            want):
        raise AssertionError(f"dist_vit: final loss {m['final_loss']}, "
                             f"vit_train's {want}")
    return rec


# dist_multi's cases: (name, job argv); the LM at the bench LM's widths,
# 2 layers, batch 4 × 2,048, bf16; the MLP jobs print every step, the
# warm-up ones (NCCL's first collectives) included, and time the rest
def dist_moe_phase(moe_cfg, jobs, smi: str, moe: dict) -> dict:
    """The MoE LM at ``moe_train``'s width (8 experts, top-2; batch 8 ×
    2,048) through ``llm --experts 8 --mesh ep:auto`` in the NCCL group
    ``dist_smoke`` joined, as many steps as ``moe_train`` ran from the same
    seeded weights and batch: K1-K3 each at least once a layer and step,
    Δ once per dQ launch, every loss finite and the last within ``TOL`` of
    ``moe_train``'s (the job leaves the logits f32), step ms, MFU and peak
    memory (above what earlier phases hold) beside ``moe_train``'s.
    Returns the launches."""
    from kubeoperator_tpu_torch.workloads import flash_attention as fa

    steps = moe["steps_run"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' live tensors
    fa.reset_launches()
    rc, records = run_job(jobs, [
        "llm", "--experts", str(moe_cfg.moe_experts), "--mesh", "ep:auto",
        "--steps", str(steps), "--vocab", str(moe_cfg.vocab_size),
        "--d-model", str(moe_cfg.d_model), "--heads", str(moe_cfg.n_heads),
        "--layers", str(moe_cfg.n_layers), "--d-ff", str(moe_cfg.d_ff),
        "--seq-len", str(moe_cfg.max_seq_len), "--batch", "8"])
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in records if "loss" in r]
    done = records[-1]
    want = moe["final_loss"]
    emit({"phase": "dist_moe", "nvidia_smi": smi, "rc": rc,
          "mesh": done.get("mesh"), "steps": done.get("steps"),
          "launches": launches, "losses": losses,
          "moe_train_final_loss": want,
          "step_time_ms": done.get("step_time_ms"), "mfu": done.get("mfu"),
          "tokens_per_sec": (8 * moe_cfg.max_seq_len * 1e3
                             / done["step_time_ms"]
                             if done.get("step_time_ms") else None),
          "max_memory_allocated": peak, "held_before": held,
          "phase_peak_bytes": peak - held,
          "moe_train_step_time_ms": moe["step_time_ms"],
          "moe_train_tokens_per_sec": moe["tokens_per_sec"],
          "moe_train_mfu": moe["mfu"]})
    if rc != 0 or not done.get("done") or done["steps"] != steps:
        raise AssertionError(f"dist_moe: rc {rc}, {done}")
    for kname, _ in KERNELS:
        if launches[kname] < moe_cfg.n_layers * steps:
            raise AssertionError(f"dist_moe: {kname} launched "
                                 f"{launches[kname]} times, expected >= "
                                 f"{moe_cfg.n_layers * steps}")
    if launches["flash_delta"] != launches["flash_bwd_dq"]:
        raise AssertionError(f"dist_moe: flash_delta launched "
                             f"{launches['flash_delta']} times, not once "
                             f"per dQ launch")
    if not (losses and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"dist_moe: losses {losses}")
    if abs(losses[-1] - want) > TOL["atol"] + TOL["rtol"] * abs(want):
        raise AssertionError(f"dist_moe: final loss {losses[-1]}, "
                             f"moe_train's {want}")
    return launches


def dist_serve_phase(cfg, jobs, smi: str) -> dict:
    """The serve job at the bench LM's widths through ``--mesh dp:auto``
    in the NCCL group ``dist_smoke`` joined (a world of one rank: the
    reference's one-device spec, so no command crosses ranks):
    ``serve_engine``'s engine shape, its greedy requests sent one at a
    time over HTTP, each reply equal to the same request through a
    one-device ``SlotPoolEngine`` of that shape on the served weights
    (or first different at a near-tie of the solo decode's logits);
    tokens/s and peak memory (above what earlier phases hold)."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.serving import ContinuousBatcher

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' live tensors
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        server, batcher = jobs.build_server(jobs.build_parser().parse_args([
            "serve", "--engine", "continuous", "--mesh", "dp:auto",
            "--vocab", str(cfg.vocab_size), "--d-model", str(cfg.d_model),
            "--heads", str(cfg.n_heads), "--layers", str(cfg.n_layers),
            "--d-ff", str(cfg.d_ff), "--max-seq-len", str(cfg.max_seq_len),
            "--slots", str(SERVE_SLOTS), "--segment", str(SERVE_SEGMENT),
            "--seed", "3", "--host", "127.0.0.1", "--port", "0"]))
    records = [json.loads(x) for x in out.getvalue().splitlines()]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    reqs = [r for r in serve_requests(cfg.vocab_size) if not r[2]][:6]
    replies, t0 = [], time.perf_counter()
    try:
        for prompt, mt, _t, _s in reqs:
            status, body = http_call(url + "/generate", {
                "prompt_ids": prompt, "max_tokens": mt})
            if status != 200:
                raise AssertionError(f"dist_serve: HTTP {status}: {body}")
            replies.append(json.loads(body)["tokens"])
        seconds = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        if hasattr(batcher.engine, "stop"):
            batcher.engine.stop()
    peak = torch.cuda.max_memory_allocated()
    model, serve_cfg = batcher.engine.model, batcher.engine.cfg
    ref = ContinuousBatcher(SlotPoolEngine(
        serve_cfg, model, slots=SERVE_SLOTS, segment=SERVE_SEGMENT,
        device=model.embedding.device))
    checks = []
    for i, (prompt, mt, _t, _s) in enumerate(reqs):
        want = ref.submit(prompt, mt)
        checks.append({**near_tie(
            model, i, replies[i], want, NEAR_TIE,
            lambda pre, n=len(prompt): decode_logits(serve_cfg, model, pre,
                                                     n)),
            "prompt_len": len(prompt), "max_tokens": mt})
    # a world of one is the one-device spec: the engine reports no mesh
    mesh = next(r["mesh"] for r in records if "mesh" in r)
    rec = {"phase": "dist_serve", "nvidia_smi": smi, "mesh": mesh,
           "num_processes": torch.distributed.get_world_size(),
           "requests": len(reqs), "seconds": seconds,
           "tokens_per_sec": sum(mt for _, mt, _, _ in reqs) / seconds,
           "max_memory_allocated": peak, "held_before": held,
           "phase_peak_bytes": peak - held, "greedy_vs_one_device": checks,
           "near_tie_rows": sum(not c["equal"] for c in checks)}
    emit(rec)
    if mesh is not None or torch.distributed.get_world_size() != 1:
        raise AssertionError(f"dist_serve: mesh {mesh} in a world of "
                             f"{torch.distributed.get_world_size()}")
    return rec


MULTI_LM = ["--d-model", "2048", "--heads", "16", "--layers", "2", "--d-ff",
            "8192", "--seq-len", "2048", "--batch", "4", "--steps", "3"]
MULTI_MLP = ["--steps", "5"]
MULTI_MOE = [*MULTI_LM, "--experts", "8"]
MULTI_CASES = (
    ("smoke", ["smoke"]),
    ("llm_dp2", ["llm", *MULTI_LM, "--mesh", "dp:2"]),
    ("llm_sp2_ring", ["llm", *MULTI_LM, "--mesh", "sp:2"]),
    ("llm_sp2_ulysses", ["llm", *MULTI_LM, "--mesh", "sp:2",
                         "--sp-attention", "ulysses"]),
    ("llm_tp2", ["llm", *MULTI_LM, "--mesh", "tp:2"]),
    ("moe_ep2", ["llm", *MULTI_MOE, "--mesh", "ep:2"]),
    ("moe_dp2", ["llm", *MULTI_MOE, "--mesh", "dp:2"]),
    ("fsdp", ["fsdp", "--mesh", "fsdp:2", *MULTI_MLP]),
    ("fsdp_no_overlap", ["fsdp", "--mesh", "fsdp:2", "--no-overlap",
                         *MULTI_MLP]),
    ("pipeline", ["pipeline", "--mesh", "pp:2", *MULTI_MLP]),
)
# dist_multi's trainer cases: (name, model, mesh), each MULTI_STEPS steps
# on the global batch of 128 from seed 0 (64 a rank over dp and fsdp, 128
# a rank over tp: ViT-B/16's 6 heads a rank, a packed width of 384) and
# held against the same steps on one rank; ResNet-50 in the K7/K8
# configuration
MULTI_TRAINERS = (("resnet_dp2", "resnet", {"dp": 2}),
                  ("resnet_fsdp2", "resnet", {"fsdp": 2}),
                  ("vit_dp2", "vit", {"dp": 2}), ("vit_tp2", "vit", {"tp": 2}))
MULTI_STEPS = 5
# dist_multi's serving cases: the slot pool of the bench LM cut to 2
# layers over each mesh, every rank making the engine calls, against the
# one-rank pool; (prompt length, max_tokens) of its greedy requests, one
# a slot
MULTI_POOLS = (("pool_tp2", {"tp": 2}), ("pool_dp2", {"dp": 2}))
MULTI_POOL_REQS = ((16, 48), (200, 32), (64, 40), (33, 64), (128, 24),
                   (7, 56), (256, 32), (90, 40))
# dist_multi's handoff case: that pool's prefill→decode handoff over tp 2,
# and its request (prompt length, max_tokens): 32 whole pages hand off
MULTI_HANDOFF = ("handoff_tp2", {"tp": 2})
MULTI_HANDOFF_REQ = (520, 40)


def pool_run(mesh: dict, compile_cache=None) -> dict:
    """``MULTI_POOL_REQS`` through ``SlotPoolEngine(slots=8, segment=8)``
    over ``mesh`` (one device for {}) on the bench LM cut to 2 layers,
    seeded: every request's row, the segment ms (median), the model (for
    the near-tie rule) and the engine's compile-cache result."""
    from kubeoperator_tpu_torch.profile_lm import BENCH_LM
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
    from kubeoperator_tpu_torch.workloads.transformer import Transformer

    cfg = dataclasses.replace(BENCH_LM, n_layers=2)
    with torch.device("cuda"):
        model = Transformer(cfg).reset_parameters(4).eval()
    eng = SlotPoolEngine(cfg, model, slots=8, segment=8,
                         mesh_spec=MeshSpec(**mesh),
                         compile_cache=compile_cache, device="cuda")
    rng = np.random.default_rng(4)
    entries = [(i, rng.integers(0, cfg.vocab_size, n).tolist(), mt, 0.0, 0)
               for i, (n, mt) in enumerate(MULTI_POOL_REQS)]
    pos = eng.admit(entries)
    steps = max(len(pr) + mt - 1 - pos[i] for i, pr, mt, _, _ in entries)
    times = []
    for _ in range(-(-steps // eng.segment)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_segment()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    buf, _ = eng.poll()
    rows = [buf[i][:len(pr) + mt].tolist() for i, pr, mt, _, _ in entries]
    return {"rows": rows, "segment_ms": statistics.median(times) * 1e3,
            "cfg": cfg, "model": model, "aot": eng.aot,
            "prompts": [len(pr) for _, pr, _, _, _ in entries]}


def handoff_run(mesh: dict) -> dict:
    """The prefill→decode handoff of ``MULTI_HANDOFF_REQ``'s prompt (its
    whole pages) on ``pool_run``'s model over ``mesh``, every rank making
    the engine calls: a ``PrefillWorker`` on the mesh exports the pages,
    which rank 0 lands in a one-device pool and decodes over; then rank
    0's one-device export lands in a fresh meshed pool (the other ranks
    pass no payload), which decodes. Each decode's row, pages, prefix
    hits and the export and import seconds. With ``mesh`` {} the row of a
    cold decode, the model and the prompt's length (for the near-tie
    rule)."""
    import torch.distributed as dist

    from kubeoperator_tpu_torch.cluster import PrefillWorker, aligned_prefix
    from kubeoperator_tpu_torch.profile_lm import BENCH_LM
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
    from kubeoperator_tpu_torch.workloads.transformer import Transformer

    cfg = dataclasses.replace(BENCH_LM, n_layers=2)
    with torch.device("cuda"):
        model = Transformer(cfg).reset_parameters(4).eval()
    n, mt = MULTI_HANDOFF_REQ
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               n).tolist()

    def engine(m: dict):
        return SlotPoolEngine(cfg, model, slots=8, segment=8,
                              mesh_spec=MeshSpec(**m), device="cuda")

    def decode(eng) -> tuple[list[int], int]:
        pos = eng.admit([(0, prompt, mt, 0.0, 0)])[0]
        while pos < n + mt - 1:
            eng.run_segment()
            pos = min(pos + eng.segment, n + mt - 1)
        buf, _ = eng.poll()
        return buf[0][:n + mt].tolist(), eng.prefix_hits

    if not mesh:
        return {"row": decode(engine({}))[0], "cfg": cfg, "model": model,
                "prompt_len": n}
    lead = dist.get_rank() == 0
    out: dict = {}
    src = engine(mesh)
    aligned = aligned_prefix(prompt, src.page)
    t0 = time.perf_counter()
    payload = PrefillWorker(src).prefill(aligned)
    torch.cuda.synchronize()
    out["export_s"] = time.perf_counter() - t0
    if lead:
        one = engine({})
        out["export_pages"] = one.import_prefix(payload["tokens"],
                                                payload["layers"])
        out["export_row"], out["export_hits"] = decode(one)
        layers = PrefillWorker(engine({})).prefill(aligned)["layers"]
    else:
        layers = None
    del src, payload
    dst = engine(mesh)
    t0 = time.perf_counter()
    out["import_pages"] = dst.import_prefix(aligned, layers)
    torch.cuda.synchronize()
    out["import_s"] = time.perf_counter() - t0
    out["import_row"], out["import_hits"] = decode(dst)
    out["pages"] = len(aligned) // dst.page
    return out


def handoff_check(got: dict) -> dict:
    """``handoff_run``'s meshed rows against its one-device cold row, by
    the near-tie rule of the solo decode's logits; each decode a prefix
    hit over every page."""
    one = handoff_run({})
    rows = [near_tie(one["model"], i, got[k], one["row"], NEAR_TIE,
                     lambda pre: decode_logits(one["cfg"], one["model"], pre,
                                               one["prompt_len"]))
            for i, k in enumerate(("export_row", "import_row"))]
    ok = (got["export_pages"] == got["import_pages"] == got["pages"]
          and got["export_hits"] == got["import_hits"] == 1)
    return {"ok": ok, "rows": rows, "pages": got["pages"],
            "export_pages": got["export_pages"],
            "import_pages": got["import_pages"],
            "prefix_hits": [got["export_hits"], got["import_hits"]],
            "export_s": got["export_s"], "import_s": got["import_s"]}


def trainer_run(model: str, mesh: dict, steps: int = MULTI_STEPS) -> dict:
    """``steps`` train steps of ResNet-50 (K7/K8) or ViT-B/16 at batch 128
    over ``mesh`` (one device for {}): the losses, the fenced step ms and
    the host's ms to enqueue a step (medians after the first), the port's
    launches, whether every rank holds the same BatchNorm running
    statistics, and the device seconds of NCCL's kernels in one more step
    under the profiler (None without NCCL)."""
    import torch.distributed as dist

    from kubeoperator_tpu_torch.profile_lm import RESNET_K7_K8
    from kubeoperator_tpu_torch.workloads import bn_fused, conv_vjp, costmodel
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
    from kubeoperator_tpu_torch.workloads.train import Trainer
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer

    spec = MeshSpec(**mesh)
    tr = (Trainer(RESNET_K7_K8, spec) if model == "resnet"
          else ViTTrainer(ViTConfig(), spec))
    state = tr.init_state()
    images, labels = tr.synthetic_batch(128)
    for mod in (fa, conv_vjp, bn_fused):
        mod.reset_launches()
    losses, times, enqueue = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = tr.train_step(state, images, labels)
        enqueue.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    launches = {**fa.LAUNCHES, **conv_vjp.LAUNCHES, **bn_fused.LAUNCHES}
    nccl = costmodel.profiled_collective_seconds(tr.train_step, state,
                                                 images, labels)
    stats = [b.flatten() for b in state["model"].buffers()]
    same = True
    if stats and dist.is_initialized():
        flat = torch.cat(stats)
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        same = bool(torch.equal(hi, lo))
    return {"losses": losses, "step_ms": statistics.median(times[1:]) * 1e3,
            "enqueue_ms": statistics.median(enqueue[1:]) * 1e3,
            "nccl_device_s": nccl, "launches": launches,
            "bn_stats_equal_across_ranks": same}


def dist_multi_rank(rank: int, world: int, out: str, cases: tuple) -> None:
    """One NCCL rank of ``dist_multi``: every case's job, then
    ``MULTI_TRAINERS``; rank 0 writes the records and each case's flash
    launches, and the trainers' results, to ``out``."""
    from kubeoperator_tpu_torch.train import jobs
    from kubeoperator_tpu_torch.workloads import flash_attention as fa

    results = {name: trainer_run(model, mesh)
               for name, model, mesh in MULTI_TRAINERS}
    for name, mesh in MULTI_POOLS:
        got = pool_run(mesh)
        results[name] = {"rows": got["rows"],
                         "segment_ms": got["segment_ms"]}
    results[MULTI_HANDOFF[0]] = handoff_run(MULTI_HANDOFF[1])
    for name, argv in cases:
        fa.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = jobs.main(argv)
        if rc != 0:
            raise AssertionError(f"dist_multi {name}: rank {rank} rc {rc}")
        results[name] = {"records": [json.loads(x) for x in
                                     buf.getvalue().splitlines()],
                         "launches": dict(fa.LAUNCHES)}
    if rank == 0:
        Path(out, "rank0.json").write_text(json.dumps(results))


def mlp_serial_loss(jobs, argv: list) -> float:
    """The two-rank fsdp or pipeline job's first loss on one device: its
    seeded weights and batch through the layers in order."""
    args = jobs.build_parser().parse_args(argv)
    dev = torch.device("cuda")
    fsdp = argv[0] == "fsdp"
    embed, stages, head, fns = jobs.mlp_lm(args, args.layers if fsdp else 2,
                                           dev)
    batch = args.batch or (8 * 2 if fsdp else args.microbatches)
    x = jobs.synthetic_ids(batch, args.vocab, 1, dev)
    y = jobs.synthetic_ids(batch, args.vocab, 2, dev)
    h = fns["embed_fn"](embed, x)
    for p in stages:
        h = fns["stage_fn"](p, h)
    return float(fns["loss_fn"](fns["head_fn"](head, h), y).mean())


# dist_multi's multislice case: the 2-layer bench LM, 3 steps of a global
# batch of 4 × 2,048 from seed 1, over two virtual slices: dp 2 × tp 2 on
# four ranks, dp 2 on two (a slice a rank)
MULTISLICE_LM_STEPS, MULTISLICE_BATCH = 3, 4
MULTISLICE_SPECS = {4: {"dp": 2, "tp": 2}, 2: {"dp": 2}}


def multislice_lm(mesh: dict, slices=None) -> dict:
    """``MULTISLICE_LM_STEPS`` steps of ``LMTrainer`` on the 2-layer bench
    LM over ``mesh`` (one device for {}) and ``slices``, seeded: the
    losses, K1-K3's launches and the mesh's ranks."""
    from kubeoperator_tpu_torch.profile_lm import BENCH_LM
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec

    tr = LMTrainer(dataclasses.replace(BENCH_LM, n_layers=2),
                   MeshSpec(**mesh), slices=slices)
    state = tr.init_state(seed=1)
    tokens = tr.synthetic_batch(MULTISLICE_BATCH, 2048, seed=1)
    fa.reset_launches()
    losses = []
    for _ in range(MULTISLICE_LM_STEPS):
        state, metrics = tr.train_step(state, tokens)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "launches": dict(fa.LAUNCHES),
            "mesh": tr.mesh.mesh.tolist() if tr.mesh is not None else None}


def multislice_rank(rank: int, world: int, out: str) -> None:
    """One NCCL rank of the multislice case: the refusal of a model axis
    across the two virtual slices (``MeshSpec(tp=2, sp=world/2)``, which
    must raise before any collective), then ``multislice_lm`` over
    ``MULTISLICE_SPECS[world]``; each rank writes its result."""
    from kubeoperator_tpu_torch.workloads import sharding

    slices = sharding.with_virtual_slices(world, 2)
    try:
        sharding.build_mesh(sharding.MeshSpec(tp=2, sp=world // 2), "cuda",
                            slices)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    got = multislice_lm(MULTISLICE_SPECS[world], slices)
    Path(out, f"multislice.rank{rank}.json").write_text(json.dumps(
        {**got, "slices": slices, "refusal": refusal}))


def multislice_case(out: Path, cards: int) -> dict:
    """dist_multi's multislice case on four NCCL ranks where four cards
    are visible (two virtual slices of two, dp 2 × tp 2), else two (dp 2,
    a slice each): each dp row's ranks in one slice, the refusal of tp
    across the slices, every loss within ``TOL`` of one rank's, K1-K3
    each at least once a layer and step on every rank."""
    from kubeoperator_tpu_torch.train import launch

    world = 4 if cards >= 4 else 2
    mesh = MULTISLICE_SPECS[world]
    t0 = time.perf_counter()
    out = out.resolve()                     # the file:// store's path
    launch.spawn(multislice_rank, world, (str(out),), backend="nccl",
                 store=str(out / "store_multislice"), timeout_s=300.0,
                 deadline_s=600.0)
    seconds = time.perf_counter() - t0
    ranks = [json.loads((out / f"multislice.rank{r}.json").read_text())
             for r in range(world)]
    one = multislice_lm({})
    slices = ranks[0]["slices"]
    rows = np.asarray(ranks[0]["mesh"]).reshape(mesh["dp"], -1).tolist()
    rows_in_one_slice = all(len({slices[r] for r in row}) == 1
                            for row in rows)
    refused = all(r["refusal"] is not None and "only a data axis" in
                  r["refusal"] for r in ranks)
    close = all(len(r["losses"]) == len(one["losses"]) and all(
        abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)
        for a, b in zip(r["losses"], one["losses"])) for r in ranks)
    flash = min(r["launches"][k] for r in ranks for k, _ in KERNELS)
    return {"ok": rows_in_one_slice and refused and close
            and flash >= 2 * MULTISLICE_LM_STEPS,
            "case": f"{'dp2_tp2' if world == 4 else 'dp2'} over 2 virtual "
                    f"slices on {world} ranks",
            "world": world, "slices": slices, "dp_rows": rows,
            "dp_rows_in_one_slice": rows_in_one_slice,
            "refusal": ranks[0]["refusal"],
            "losses": [r["losses"] for r in ranks],
            "one_rank_losses": one["losses"],
            "min_flash_launches": flash, "seconds": seconds}


def dist_multi_phase(smi: str) -> dict:
    """With two or more cards: ``MULTI_CASES`` and ``MULTI_TRAINERS`` on
    two NCCL ranks spawned by ``launch.spawn``, each against its one-rank
    run in this process: the LM's losses against the job without
    ``--mesh`` (within ``TOL``), K1-K3 launched on every rank that runs
    flash (dp, tp: T 2,048 a rank; sp runs ring or Ulysses einsums), the
    fsdp and pipeline jobs' first loss against their layers run in order,
    overlap or not the same losses, smoke's psum 2; the llm job saved at dp
    2 and resumed here on one rank for a third step, its loss against the
    one-rank job's third; ResNet-50 (K7/K8) at dp 2 and fsdp 2 and ViT-B/16
    at dp 2 and tp 2, their losses within ``TOL`` of one rank's, the
    BatchNorm running statistics equal on both ranks, and every K7/K8
    site of a rank's rows (K7 where its rows are a multiple of 128) or
    K4-K6 every layer. With one card it says so and runs nothing."""
    from kubeoperator_tpu_torch.train import jobs, launch

    cards = torch.cuda.device_count()
    if cards < 2:
        rec = {"phase": "dist_multi", "ran": False, "cards": cards,
               "why": f"needs two cards; {cards} visible"}
        emit(rec)
        return rec
    out = ROOT / "build" / "dist_multi"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ckpt = out / "llm_ckpt"
    cases = (*MULTI_CASES, ("llm_ckpt_dp2", [
        "llm", *MULTI_LM, "--mesh", "dp:2", "--steps", "2", "--ckpt-dir",
        str(ckpt)]))
    t0 = time.perf_counter()
    launch.spawn(dist_multi_rank, 2, (str(out), cases), backend="nccl",
                 store=str(out / "store"), timeout_s=300.0, deadline_s=900.0)
    seconds = time.perf_counter() - t0
    res = json.loads((out / "rank0.json").read_text())
    _, one = run_job(jobs, ["llm", *MULTI_LM])
    one_losses = [r["loss"] for r in one if "loss" in r]
    _, one_moe = run_job(jobs, ["llm", *MULTI_MOE])
    one_moe_losses = [r["loss"] for r in one_moe if "loss" in r]
    checks = {}
    one_pool = pool_run({})
    for name, mesh in MULTI_POOLS:
        got = res[name]
        rows = [near_tie(one_pool["model"], i, row, want, NEAR_TIE,
                         lambda pre, n=n: decode_logits(
                             one_pool["cfg"], one_pool["model"], pre, n))
                for i, (row, want, n) in enumerate(zip(
                    got["rows"], one_pool["rows"], one_pool["prompts"]))]
        checks[name] = {"ok": True, "rows": rows,
                        "near_tie_rows": sum(not r["equal"] for r in rows),
                        "segment_ms": got["segment_ms"],
                        "one_rank_segment_ms": one_pool["segment_ms"]}
    del one_pool
    checks[MULTI_HANDOFF[0]] = handoff_check(res[MULTI_HANDOFF[0]])
    rc, resumed = run_job(jobs, ["llm", *MULTI_LM, "--ckpt-dir", str(ckpt)])
    third = [r["loss"] for r in resumed if "loss" in r]
    checks["llm_ckpt_dp2"] = {
        "ok": (rc == 0 and resumed[0] == {"job": "llm", "resumed_at": 2}
               and len(third) == 1 and abs(third[0] - one_losses[-1])
               <= TOL["atol"] + TOL["rtol"] * abs(one_losses[-1])),
        "saved_at_dp2": [r.get("loss") for r in
                         res["llm_ckpt_dp2"]["records"] if "loss" in r],
        "resumed": resumed[0], "third_loss": third,
        "one_rank_third_loss": one_losses[-1]}
    k7_sites_at_64 = sum(k for n, _, _, k in K7_SITES if (n // 2) % 128 == 0)
    for name, model, mesh in MULTI_TRAINERS:
        got, want = res[name], trainer_run(model, {})
        ok = got["bn_stats_equal_across_ranks"] and all(
            abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)
            for a, b in zip(got["losses"], want["losses"]))
        if model == "resnet":
            rows = 64 if "dp" in mesh or "fsdp" in mesh else 128
            per_step = {"conv1x1_bwd_dx": k7_sites_at_64 if rows == 64
                        else 24, "bn_bwd_stats": 9, "bn_bwd_dx": 9,
                        "bn_bwd_dw": 9}
        else:
            per_step = {k: 12 for k, _ in PACKED_KERNELS}
        ok = ok and all(got["launches"][k] >= n * MULTI_STEPS
                        for k, n in per_step.items())
        checks[name] = {"ok": ok, "losses": got["losses"],
                        "one_rank_losses": want["losses"],
                        "step_ms": got["step_ms"],
                        "one_rank_step_ms": want["step_ms"],
                        "enqueue_ms": got["enqueue_ms"],
                        "one_rank_enqueue_ms": want["enqueue_ms"],
                        "nccl_device_s": got["nccl_device_s"],
                        "launches": got["launches"],
                        "bn_stats_equal_across_ranks":
                            got["bn_stats_equal_across_ranks"]}
    for name, argv in MULTI_CASES:
        records = res[name]["records"]
        losses = [r["loss"] for r in records if "loss" in r and "step" in r]
        if name == "smoke":
            ok = records[-1]["ok"] and records[-1]["psum"] == 2.0
            checks[name] = {"ok": ok, "record": records[-1]}
        elif name.startswith(("llm", "moe")):
            base = one_moe_losses if name.startswith("moe") else one_losses
            ok = len(losses) == len(base) and all(
                abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)
                for a, b in zip(losses, base))
            flash = min(res[name]["launches"][k] for k, _ in KERNELS)
            if name in ("llm_dp2", "llm_tp2", "moe_ep2", "moe_dp2"):
                ok = ok and flash >= 2 * 3
            checks[name] = {"ok": ok, "losses": losses,
                            "one_rank_losses": base,
                            "one_rank_step_time_ms": (
                                one_moe if name.startswith("moe")
                                else one)[-1]["step_time_ms"],
                            "step_time_ms": records[-1]["step_time_ms"],
                            "mfu": records[-1]["mfu"],
                            "launches": res[name]["launches"]}
        else:
            want = mlp_serial_loss(jobs, argv)
            ok = abs(losses[0] - want) <= 1e-4 * abs(want)
            checks[name] = {"ok": ok, "first_loss": losses[0],
                            "serial_first_loss": want, "losses": losses,
                            "step_time_s": records[-1]["step_time_s"]}
    if checks["fsdp"]["losses"] != checks["fsdp_no_overlap"]["losses"]:
        checks["fsdp"]["ok"] = False
    checks["multislice"] = multislice_case(out, cards)
    rec = {"phase": "dist_multi", "ran": True, "cards": cards, "world": 2,
           "nvidia_smi": smi, "seconds": seconds, "cases": checks}
    emit(rec)
    bad = [n for n, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"dist_multi: {bad} disagree with their "
                             f"one-rank runs")
    return rec


# the benches phase: ring attention at the width --cost-model prices (the
# reference decoder's d 4096 over heads of 128), in bf16, at T 8192
BENCH_RING = {"batch": 1, "heads": 32, "head_dim": 128, "dtype": "bfloat16"}


def benches_phase(cfg, model, smi: str) -> dict:
    """The port's benches and dry run on the card (see the module doc);
    each record on a line of its own, then the phase's summary. Any
    failed record or check fails the phase."""
    from kubeoperator_tpu_torch import bench_multichip as bm
    from kubeoperator_tpu_torch import bench_serving as bs
    from kubeoperator_tpu_torch import dryrun

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    cards = torch.cuda.device_count()

    def show(part: str, rec: dict) -> None:
        emit({"phase": "benches", "part": part, "nvidia_smi": smi, **rec})

    # -- the cost model, priced for this card
    priced = bm.cost_model_records([1, 2, 4, 8], name)
    for rec in priced["records"]:
        show("cost_model", rec)
    wins = [r["speedup"] for r in priced["records"]
            if r["config"] == "fsdp-overlap"]
    g = priced["guards"]
    if not (wins[0] == 1.0 and wins == sorted(wins)
            and abs(g["bubble_measured"] - g["bubble_analytic"])
            <= 0.10 * g["bubble_analytic"]):
        raise AssertionError(f"benches cost model: wins {wins}, {g}")
    ring_name = f"ring-attention-{bm.SEQ_POINTS[0] // 1024}k"    # T 8192
    ring_price = {r["n_devices"]: r["compute_s"] for r in priced["records"]
                  if r["config"] == ring_name}

    # -- the measured matrix over the visible cards
    worlds = [n for n in (1, 2, 4) if n <= cards]
    t_matrix = time.perf_counter()
    measured = bm.run_measured(worlds, 3, 1, False, card=name,
                               ring=BENCH_RING)
    matrix_s = time.perf_counter() - t_matrix
    for rec in measured:
        show("measured", rec)
    if cards == 1:
        show("measured", {"config": "fsdp-overlap, gpipe", "ran": False,
                          "why": "the matrix runs the fsdp A/B and GPipe "
                                 "from 2 cards; 1 is visible"})
    bad = [r for r in measured if not r["ok"]]
    if bad:
        raise AssertionError(f"benches measured: {bad}")
    rings = [r for r in measured if r["config"] == ring_name]
    if {r["n_devices"] for r in rings} != set(worlds) or any(
            r["shape"] != BENCH_RING or r["priced_card"] != name
            or abs(r["priced_compute_s"] - ring_price[r["n_devices"]])
            > 1e-6 for r in rings):
        raise AssertionError(f"benches ring: {rings}")
    for n in {r["n_devices"] for r in measured
              if r["config"] == "fsdp-overlap"}:
        over, eager = (next(r for r in measured if r["config"] == c
                            and r["n_devices"] == n)
                       for c in ("fsdp-overlap", "fsdp-eager"))
        if abs(over["loss"] - eager["loss"]) \
                > TOL["atol"] + TOL["rtol"] * abs(eager["loss"]):
            raise AssertionError(f"benches fsdp A/B at {n}: losses "
                                 f"{over['loss']} vs {eager['loss']}")

    # -- the serving arms at the bench LM's width
    spec = bs.bench_spec_real(cfg, model)
    rows = [{**near_tie(model, i, got, want, NEAR_TIE),
             "prompt_len": len(bs.SPEC_PROMPTS[i])}
            for i, (got, want) in enumerate(zip(spec["rows"],
                                                 spec["plain_rows"]))]
    show("spec_real", {**{k: v for k, v in spec.items()
                          if k not in ("rows", "plain_rows")},
                       "greedy_vs_plain": rows,
                       "near_tie_rows": sum(not r["equal"] for r in rows)})
    if not 0 <= spec["accepted"] <= spec["drafted"] or not spec["drafted"]:
        raise AssertionError(f"benches spec: {spec}")
    scaling = bs.bench_scaling_real(cfg, model)
    show("scaling_real", scaling)
    ran = [p for p in scaling["curve"] if "skipped" not in p]
    if [(p["dp"], p["tp"]) for p in ran] != [
            s for s in bs.SCALING_SHAPES
            if s[0] * s[1] <= scaling["world"]] or any(
            p["tok_s"] <= 0 for p in ran):
        raise AssertionError(f"benches scaling: {scaling}")
    bring = bs.bench_bringup(cfg, model)
    show("bringup", bring)
    for arm in bring["bringup_ab"].values():
        if isinstance(arm, dict) and (arm["compiles"]
                                      or arm["source"] != "none"):
            raise AssertionError(f"benches bring-up: {bring}")

    # -- the dry run over the visible cards, then entry()'s forward
    t_dry = time.perf_counter()
    dry = dryrun.dryrun_multichip(cards)
    dry_s = time.perf_counter() - t_dry
    for rec in dry:
        show("dryrun", rec)
    want = ["resnet", "transformer", "vit", "pipeline-stance",
            "fsdp-overlap", "gpipe"]
    if cards % 8 == 0:
        want[3:3] = ["multislice", "resnet-multislice"]
        want.append("moe")
    if [r["config"] for r in dry] != want or not all(
            r["ok"] and math.isfinite(r["loss"]) for r in dry):
        raise AssertionError(f"benches dryrun: {dry}")
    forward, inputs = dryrun.entry()
    logits = forward(*inputs)
    torch.cuda.synchronize()
    if tuple(logits.shape) != (8, 1000) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"benches entry: {logits.shape}")
    del inputs, forward
    rec = {"phase": "benches", "part": "total", "nvidia_smi": smi,
           "cards": cards, "worlds": worlds, "seconds":
           time.perf_counter() - t0, "matrix_seconds": matrix_s,
           "dryrun_seconds": dry_s, "entry_logits": list(logits.shape)}
    emit(rec)
    return rec


def benches_alone() -> dict:
    """The benches phase by itself, on the bench LM seeded from 0 (no
    kernel is built: the phase launches none): ``python3 -c "import
    chip_smoke as c; c.benches_alone()"``."""
    from kubeoperator_tpu_torch.profile_lm import BENCH_LM
    from kubeoperator_tpu_torch.workloads.transformer import Transformer

    smi = nvidia_smi()
    print(smi, flush=True)
    with torch.device("cuda"):
        model = Transformer(BENCH_LM).reset_parameters(0).eval()
    return benches_phase(BENCH_LM, model, smi)


def handoff_rank(rank: int, world: int, out: str) -> None:
    """One NCCL rank of ``handoff_alone``: ``MULTI_HANDOFF``'s case."""
    got = handoff_run(MULTI_HANDOFF[1])
    if rank == 0:
        Path(out, "handoff.json").write_text(json.dumps(got))


def handoff_alone() -> dict:
    """``dist_multi``'s handoff case by itself on two NCCL ranks (no
    kernel is built: the pool launches none): ``python3 -c "import
    chip_smoke as c; c.handoff_alone()"`` on a machine with two or more
    cards."""
    from kubeoperator_tpu_torch.train import launch

    out = ROOT / "build" / "handoff_alone"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    launch.spawn(handoff_rank, 2, (str(out),), backend="nccl",
                 store=str(out / "store"), timeout_s=300.0, deadline_s=600.0)
    rec = {"phase": "handoff_alone", "nvidia_smi": nvidia_smi(),
           "seconds": time.perf_counter() - t0,
           MULTI_HANDOFF[0]: handoff_check(json.loads(
               (out / "handoff.json").read_text()))}
    emit(rec)
    if not rec[MULTI_HANDOFF[0]]["ok"]:
        raise AssertionError(f"handoff_alone: {rec}")
    return rec


def serve_cluster_alone() -> dict:
    """Phases (a) and (h) by themselves, on the bench LM seeded from 0
    (no kernel is built: serving launches none): ``python3 -c "import
    chip_smoke as c; c.serve_cluster_alone()"``."""
    from kubeoperator_tpu_torch.profile_lm import BENCH_LM
    from kubeoperator_tpu_torch.workloads.train import peak_hbm_bytes_per_chip
    from kubeoperator_tpu_torch.workloads.transformer import Transformer

    smi = nvidia_smi()
    print(smi, flush=True)
    with torch.device("cuda"):
        model = Transformer(BENCH_LM).reset_parameters(0).eval()
    base, _ = serve_engine_phase(BENCH_LM, model, smi,
                                 peak_hbm_bytes_per_chip())
    return serve_cluster_phase(BENCH_LM, model, smi, base)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def bench_phase(smi: str, resnet_ms: float, conv_launches,
                reset_conv, measured: dict) -> dict:
    """``kubeoperator_tpu_torch.bench.main()`` once, its line echoed, with
    each point's launches: K1-K3 and Δ at least once a layer and step in
    the three LM points, K4-K6 and Δ in the ViT point, and no K7/K8 or
    flash kernel in the ResNet headline. Its headline step ms beside
    ``resnet_train``'s (the same model, batch and stem with K7 and K8).
    ``measured`` maps "llm" and "vit" to (result, flash launches) of
    phases ``train`` and ``vit_train``, which measured those points with
    the bench's settings: the bench takes their numbers instead of
    measuring the same configurations again."""
    from kubeoperator_tpu_torch import bench
    from kubeoperator_tpu_torch.workloads import flash_attention as fa

    points = {}

    def on_point(name, result):
        flash = (measured[name][1] if name in measured
                 else dict(fa.LAUNCHES))
        points[name] = {"flash": flash, "conv": conv_launches(),
                        "step_time_ms": result["step_time_ms"],
                        "mfu": result["mfu"], "reused": name in measured}
        fa.reset_launches()
        reset_conv()

    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_launches()
    reset_conv()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(on_point, {k: v[0] for k, v in measured.items()})
    seconds = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    line = json.loads(out.getvalue().splitlines()[-1])
    head = points.get("resnet") or points.get("resnet-fallback") or {}
    rec = {"phase": "bench", "nvidia_smi": smi, "rc": rc, "seconds": seconds,
           "points": points, "headline_step_time_ms": line.get(
               "step_time_ms"), "resnet_train_step_time_ms": resnet_ms,
           "k7_k8_saves_ms": (line["step_time_ms"] - resnet_ms
                              if "step_time_ms" in line else None)}
    emit(rec)
    if rc != 0 or line.get("metric") != "resnet50_img_per_sec_per_chip":
        raise AssertionError(f"bench: rc {rc}, line {line}")
    if not (line["value"] > 0 and 0 < line["mfu"] < 1):
        raise AssertionError(f"bench: value {line['value']}, mfu "
                             f"{line['mfu']}")
    if [c["config"] for c in line["configs"]] != [
            "resnet", "llm", "llm4k", "llm8k", "vit"]:
        raise AssertionError(f"bench: configs {line['configs']}")
    if any(head["conv"].values()) or any(head["flash"].values()):
        raise AssertionError(f"bench: the headline launched port kernels: "
                             f"{head}")
    for name, _, _, _, steps in bench.LM_POINTS:
        want = 4 * (bench.LM_WARMUP + 3 * steps)     # 4 layers
        got = points[name]["flash"]
        for kname in (*(k for k, _ in KERNELS), "flash_delta"):
            if got[kname] < want:
                raise AssertionError(f"bench {name}: {kname} launched "
                                     f"{got[kname]} times, expected >= "
                                     f"{want}")
    vm = bench.VIT_MEASURE
    want = 12 * (vm["warmup"] + 3 * vm["steps"]) * vm["steps_per_call"]
    for kname in (*(k for k, _ in PACKED_KERNELS), "flash_delta"):
        if points["vit"]["flash"][kname] < want:
            raise AssertionError(f"bench vit: {kname} launched "
                                 f"{points['vit']['flash'][kname]} times, "
                                 f"expected >= {want}")
    return line


def main() -> int:
    script_t0 = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on the card and has no CPU mode")
    from kubeoperator_tpu_torch import kernels
    from kubeoperator_tpu_torch.profile_lm import BENCH_LM as cfg
    from kubeoperator_tpu_torch.profile_lm import BENCH_MOE as moe_cfg
    from kubeoperator_tpu_torch.train import jobs
    from kubeoperator_tpu_torch.workloads import flash_attention as fa
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer
    from kubeoperator_tpu_torch.workloads.train import (
        peak_flops_per_chip, peak_hbm_bytes_per_chip)

    smi = nvidia_smi()
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
    # K1-K3 at the bench's LM 4k and 8k points (B·H 64 at T 4096, B·H 32
    # at T 8192): the causal grid, tensor-map extents, lse and Δ sizes at
    # 32 and 64 q-tiles, against the path's 16
    kernel_phase(fa, peaks, "causal_t4096", 4, 16, 4096, 128, True,
                 timed=True)
    kernel_phase(fa, peaks, "causal_t8192", 2, 16, 8192, 128, True,
                 timed=True)

    # -- 4. main path: train -------------------------------------------------
    # the bench's 2k LM point's settings, so phase bench takes this number
    from kubeoperator_tpu_torch import bench

    steps, warmup, repeats = bench.LM_POINTS[0][4], bench.LM_WARMUP, 3
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

    # -- 4b. main path: the MoE LM's training --------------------------------
    moe_launches, moe_m = moe_train_phase(moe_cfg, smi, peaks)

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

    # -- 5a. the llm entry point with MoE FFNs --------------------------------
    jobs_llm_moe_phase(moe_cfg, jobs, smi)

    # -- 5b. serve: the slot pool with phase 5's weights, its prefix cache,
    # quantized pages, spill tier and speculation, the MoE pool, then the
    # entry point
    serve_t0 = time.perf_counter()
    bf16_serve, bf16_rows = serve_engine_phase(cfg, model, smi, peaks[1])
    serve_spec_phase(cfg, model, smi, bf16_serve, bf16_rows)
    serve_prefix_phase(cfg, model, smi)
    serve_kv_quant_phase(cfg, model, smi, bf16_serve)
    for kv in ("bf16", "int8"):
        serve_spill_phase(cfg, model, smi, kv)
    serve_moe_phase(moe_cfg, smi)
    serve_http_phase(cfg, jobs, smi)
    serve_cluster_phase(cfg, model, smi, bf16_serve)
    emit({"phase": "serve_total", "seconds": time.perf_counter() - serve_t0})

    # -- 5c. the one-device jobs: smoke, mnist, /metrics, checkpoints -------
    jobs_t0 = time.perf_counter()
    jobs_smoke_phase(jobs, smi)
    jobs_mnist_phase(jobs, smi)
    jobs_metrics_phase(jobs, smi)
    jobs_ckpt_phase(cfg, jobs, smi)
    emit({"phase": "jobs_total", "seconds": time.perf_counter() - jobs_t0})

    # -- 6. main path: ViT-B/16 training on the packed kernels ---------------
    vcfg = ViTConfig()
    # the bench's ViT point's settings, so phase bench takes this number
    v_steps, v_warmup, per_call = (bench.VIT_MEASURE[k] for k in (
        "steps", "warmup", "steps_per_call"))
    v_repeats, v_batch = 3, bench.VIT_BATCH
    fa.reset_launches()
    v_settings = dict(batch=v_batch, steps=v_steps, warmup=v_warmup,
                      steps_per_call=per_call, repeats=v_repeats)
    vm = ViTTrainer(vcfg).measure(**v_settings)
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
    from kubeoperator_tpu_torch.workloads import batch_norm as bnk
    bn_kernel_phase(peaks)

    def conv_launches():
        return {**conv_vjp.LAUNCHES, **bn_fused.LAUNCHES}

    def reset_conv():
        conv_vjp.reset_launches()
        bn_fused.reset_launches()

    # -- 9. main path: ResNet-50 training on K7 and K8 ----------------------
    r_steps, r_warmup, r_repeats, r_per_call = 4, 2, 3, 8
    r_settings = dict(steps=r_steps, warmup=r_warmup,
                      steps_per_call=r_per_call, repeats=r_repeats)
    fa.reset_launches()
    reset_conv()
    trainer = Trainer(rcfg)
    rm = trainer.measure(batch=rcfg.batch_size, **r_settings)
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
    for kname, want in RESNET_STEP_LAUNCHES.items():
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
    bnk.reset_launches()
    try:
        trainer.train_step(trainer.init_state(),
                           *trainer.synthetic_batch(rcfg.batch_size))
        torch.cuda.synchronize()
    finally:
        conv_vjp.conv1x1_bwd = k7_call
    want_sites = {(n, ci, co): k for n, ci, co, k in K7_SITES}
    bn_want = bn_step_launches(bn_sites(rcfg.batch_size), True)
    emit({"phase": "resnet_k7_sites",
          "sites": [[*key, k] for key, k in sorted(sites.items())],
          "bn_launches": dict(bnk.LAUNCHES), "bn_want": bn_want})
    if dict(sites) != want_sites:
        raise AssertionError(f"resnet_train: K7 ran at {dict(sites)}, not "
                             f"at the sites kernels_conv times")
    if bnk.LAUNCHES != bn_want:
        raise AssertionError(f"resnet_train: BatchNorm's kernels "
                             f"{bnk.LAUNCHES}, not {bn_want} a step")

    # -- 10. the resnet50 entry point at its defaults -----------------------
    reset_conv()
    bnk.reset_launches()
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
    # every BatchNorm on its kernels, forward and backward, 53 a step
    bn_job = dict(bnk.LAUNCHES)
    emit({"phase": "resnet_job", "losses": losses,
          "img_per_sec": records[-1]["img_per_sec"],
          "launches": job_launches, "bn_launches": bn_job})
    if (bn_job["bn_plain"] or bn_job["bn_fwd_sums"] % 53
            or not bn_job["bn_fwd_sums"]
            or len({v for k, v in bn_job.items() if k != "bn_plain"}) != 1):
        raise AssertionError(f"jobs resnet50: BatchNorm's kernels "
                             f"{bn_job}, not 53 of each a step")

    # -- 10b. ResNet-50 with the dot2 backward -------------------------------
    resnet_dot2_phase(rcfg, smi, rm["step_time_ms"], conv_launches,
                      reset_conv)

    # -- 10c. the compile cache: cold and warm bring-up of the K7/K8 path ----
    aot = aot_bringup_phase(smi)

    # -- 10d. multi-device: the smoke, llm, ViT and ResNet paths in an NCCL
    # group of one rank, each against its one-device phase; then two ranks
    # where two cards are visible
    dist_t0 = time.perf_counter()
    with torchrun_env():
        dist_smoke_phase(jobs, smi)
        dist_llm_phase(cfg, jobs, smi, m, total_steps)
        dist_moe_launches = dist_moe_phase(moe_cfg, jobs, smi, moe_m)
        dist_serve_phase(cfg, jobs, smi)
        dist_vit_phase(vcfg, smi, vm, v_settings)
        dist_resnet_phase(rcfg, jobs, smi, rm, r_settings, conv_launches,
                          reset_conv)
    emit({"phase": "dist_total", "seconds": time.perf_counter() - dist_t0})
    multi = dist_multi_phase(smi)

    # -- 10e. the port's benches and dry run --------------------------------
    benches = benches_phase(cfg, model, smi)

    # -- 11. K9's probe -----------------------------------------------------
    bp.reset_launches()
    probe = bp.probe()
    probe_launches = dict(bp.LAUNCHES)
    emit({"phase": "bitcast_probe", **probe, "launches": probe_launches})
    for variant in ("kernel_nhwc", "kernel_after_copy", "library"):
        err = probe[variant]
        if not err["max_abs_err"] <= 1e-5 * err["max_abs_want"] + 1e-2:
            raise AssertionError(f"bitcast_probe {variant}: {err}")

    # -- 12. the port's bench -------------------------------------------------
    bench_phase(smi, rm["step_time_ms"], conv_launches, reset_conv,
                {"llm": (m, train_launches), "vit": (vm, vit_launches)})

    emit({"phase": "script_total", "seconds": time.perf_counter() - script_t0,
          "aot_bringup_seconds": aot["seconds"],
          "benches_seconds": benches["seconds"],
          "multislice_seconds": (multi["cases"]["multislice"]["seconds"]
                                 if multi["ran"] else None)})

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
                          for k in CUDA_KERNELS[kname]},
         # the MoE LM's paths run K1-K3 and Δ too (phase moe_train; the
         # meshed MoE LM, phase dist_moe)
         **({"moe_train_launches": moe_launches[kname],
             "dist_moe_launches": dist_moe_launches[kname]}
            if kname in (*(k for k, _ in KERNELS), "flash_delta")
            else {})}
        for kname, where, source, launches, r in main_runs]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
