"""Where a train step's time goes on the card.

    python -m kubeoperator_tpu_torch.profile_lm [--steps 3] [--top 15]
    python -m kubeoperator_tpu_torch.profile_lm --model vit [--batch 128]
    python -m kubeoperator_tpu_torch.profile_lm --model resnet [--batch 128]
    python -m kubeoperator_tpu_torch.profile_lm --model serve [--batch 16]

Trains the bench LM (d2048, 16 heads, 4 layers, d_ff 8192, seq 2048,
batch 8, bf16, remat dots+attn, bf16 logits), with ``--model vit``
ViT-B/16 (``ViTConfig()``, batch 128), or with ``--model resnet``
ResNet-50 at 224² in the configuration that runs K7 and K8
(``RESNET_K7_K8``, batch 128), for a few warm steps, then traces
``--steps`` more with ``torch.profiler`` and prints one JSON line: the
window's wall time, the device's busy and idle share, the device time by
class (the port's kernels, cuDNN convs, cuBLAS GEMMs, the rest) and the
``--top`` kernels by device time. With ``--model serve`` a step is one
decode segment of the bench LM's ``SlotPoolEngine`` (``--batch`` slots,
all live, 8 tokens each, from 512-token prompts). Needs the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from kubeoperator_tpu_torch.workloads.lm import LMTrainer
from kubeoperator_tpu_torch.workloads.train import TrainConfig
from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig

BENCH_LM = TransformerConfig(vocab_size=32_000, d_model=2048, n_heads=16,
                             n_layers=4, d_ff=8192, max_seq_len=2048,
                             dtype=torch.bfloat16, remat=True,
                             attention="auto", logits_bf16=True,
                             remat_policy="dots+attn")
# ResNet-50 as bench.py:112-113 measures it, with the two kernel modes on:
# every 1x1 conv takes make_conv's backward (dw_dot_max_k=1), K7 on the
# stride-1 ones, and the 56x56 neighbourhoods are fused units (K8)
RESNET_K7_K8 = TrainConfig(batch_size=128, image_size=224,
                           stem="space_to_depth", dw_dot_max_k=1,
                           conv_bwd="pallas", fused_bn=True)


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_" in low and "kernel" in low:
        return "flash (port)"
    if any(k in low for k in ("k8_dx_wgmma_kernel", "k8_dw_wgmma_kernel",
                              "k7_wgmma_kernel", "colsum_kernel",
                              "reduce_chunks_kernel")):
        return "conv backward K7/K8 (port)"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
        return "conv (cuDNN)"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "gemm (cuBLAS)"
    if "softmax" in low or "nll_loss" in low:
        return "cross-entropy"
    if "multi_tensor_apply" in low or "adam" in low or "sgd" in low:
        return "optimizer"
    if "copy_kernel" in low:
        return "casts and copies"
    if "index" in low or "gather" in low:
        return "gather/scatter (indexing)"
    return "other elementwise/reduction"


def serve_segment(slots: int):
    """One decode segment of a bench-LM slot pool with every slot live, as
    a step: ``slots`` requests of 512 random prompt tokens and 1,024 new
    ones, greedy, admitted once. Returns the step (it has no metrics)."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.transformer import Transformer

    with torch.device("cuda"):
        model = Transformer(BENCH_LM)
    model.reset_parameters(0)
    engine = SlotPoolEngine(BENCH_LM, model, slots=slots, segment=8)
    rng = np.random.default_rng(0)
    engine.admit([(s, rng.integers(0, BENCH_LM.vocab_size, 512).tolist(),
                   1024, 0.0, s) for s in range(slots)])

    def step():
        engine.run_segment()

    return step


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--model", choices=("lm", "vit", "resnet", "serve"),
                    default="lm")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 8 for the LM, 128 for the ViT and ResNet, "
                         "16 slots for serve")
    args = ap.parse_args(argv)

    if args.model == "serve":
        args.batch = args.batch or 16
        step, seq_len = serve_segment(args.batch), None
    elif args.model == "lm":
        args.batch = args.batch or 8
        tr = LMTrainer(BENCH_LM)
        inputs = (tr.synthetic_batch(args.batch, BENCH_LM.max_seq_len),)
        seq_len = BENCH_LM.max_seq_len
    elif args.model == "vit":
        from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer
        args.batch = args.batch or 128
        tr = ViTTrainer(ViTConfig())
        inputs = tr.synthetic_batch(args.batch)
        seq_len = tr.cfg.seq_len
    else:
        from kubeoperator_tpu_torch.workloads.train import Trainer
        args.batch = args.batch or 128
        tr = Trainer(RESNET_K7_K8)
        inputs = tr.synthetic_batch(args.batch)
        seq_len = None
    if args.model != "serve":
        state = {"train": tr.init_state()}

        def step():
            state["train"], metrics = tr.train_step(state["train"], *inputs)
            return metrics

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            metrics = step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    loss = None if metrics is None else float(metrics["loss"])

    kernels = []
    for ev in prof.key_averages():
        # user annotations (e.g. "Optimizer.step#AdamW.step") carry the
        # device time of the kernels under them: counting both would
        # count those kernels twice. Kernel names may hold "#" too (C++
        # lambdas, "{lambda()#1}"), but always with a parenthesis.
        if getattr(ev, "is_user_annotation", False) or (
                "#" in ev.key and "(" not in ev.key):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us / 1e3, ev.count))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    classes: dict[str, float] = {}
    for name, ms, _ in kernels:
        cls = kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + ms
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": args.model,
        "steps": args.steps, "batch": args.batch, "seq_len": seq_len,
        "loss": loss,
        "wall_ms_per_step": wall_ms / args.steps,
        "device_ms_per_step": device_ms / args.steps,
        "device_busy_share": device_ms / wall_ms,
        "class_ms_per_step": {c: ms / args.steps
                              for c, ms in sorted(classes.items(),
                                                  key=lambda kv: -kv[1])},
        "top": [{"kernel": n[:120], "ms_per_step": ms / args.steps,
                 "calls_per_step": c / args.steps}
                for n, ms, c in kernels[:args.top]]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
