"""Headline benchmark of the port: ResNet-50 training throughput on the
card, the counterpart of the repo's ``bench.py``.

    python -m kubeoperator_tpu_torch.bench

Prints ONE JSON line with ``bench.py``'s keys: ``metric``
(``resnet50_img_per_sec_per_chip``), ``value``, ``unit``, ``vs_baseline``
(MFU / 0.60, the north star of the ResNet-50 chart at 60% MFU), ``mfu``,
``achieved_tflops``, ``peak_tflops_per_chip``, ``chips``,
``batch_per_chip``, ``step_time_ms``, ``device_kind``, ``image_size``,
``step_ms``, ``configs`` (one ``costmodel.config_record`` a point) and the
secondary points' ``llm_mfu``, ``llm_tokens_per_sec``, ``llm_step_ms``,
``llm_mfu_seq4k``, ``llm_mfu_seq8k``, ``vit_mfu``,
``vit_img_per_sec_per_chip`` and ``vit_step_ms``.

The points are ``bench.py``'s configurations:

- ResNet-50, 224², space-to-depth stem, ``dw_dot_max_k=1`` (the dot
  path: no kernel of the port), 8 steps a call, batch 128 per card, then
  64, then 16 when a batch runs out of memory;
- the bench LM (d2048, 16 heads, 4 layers, d_ff 8192, bf16, remat
  ``dots+attn``) at batch 8 × 2,048 tokens, then with remat ``dots`` at
  4 × 4,096 and 2 × 8,192 (K1-K3 and Δ);
- ViT-B/16 on the packed flash kernels at batch 128, 8 steps a call
  (K4-K6 and Δ).

A point whose step times look suspect (slowest repeat over twice the
median) is measured once more and the better run kept, as ``bench.py``
does. Unlike ``bench.py``, only running out of device memory moves the
headline to a smaller batch, and a failed retry or secondary point ends
the run with an exception: a broken kernel must not hide behind a line
that still prints. Needs the card: the peaks are known only for CUDA
devices.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
from typing import Callable

import torch

TARGET_MFU = 0.60
# measure() settings of each point, as bench.py sets them
RESNET_BATCHES = (128, 64, 16)
RESNET_MEASURE = {"steps": 6, "warmup": 2, "steps_per_call": 8}
# (name, seq_len, batch, remat policy, measured steps)
LM_POINTS = (("llm", 2048, 8, "dots+attn", 6), ("llm4k", 4096, 4, "dots", 4),
             ("llm8k", 8192, 2, "dots", 4))
LM_WARMUP = 2
VIT_BATCH = 128
VIT_MEASURE = {"steps": 4, "warmup": 2, "steps_per_call": 8}


def guarded(name: str, run: Callable[[], dict], out: dict) -> dict:
    """Run a measure() thunk; when its step times disown themselves
    (``step_stats["suspect"]``: the slowest repeat over twice the median)
    run it once more and keep the run of higher MFU, noting the point in
    ``out["remeasured"]``. A retry that raises propagates."""
    result = run()
    stats = result.get("step_stats", {})
    if stats.get("suspect"):
        print(f"# {name}: mfu {result['mfu']:.4f} suspect distribution "
              f"(steps min/med/max = {stats.get('min_ms', 0):.0f}/"
              f"{stats.get('median_ms', 0):.0f}/{stats.get('max_ms', 0):.0f}"
              " ms) — re-measuring once", file=sys.stderr)
        retry = run()
        result = max(result, retry, key=lambda r: r["mfu"])
        out["remeasured"] = sorted(set(out.get("remeasured", []) + [name]))
    return result


def stats_brief(result: dict) -> dict:
    """Compact per-point step-time distribution for the JSON line."""
    s = result.get("step_stats", {})
    brief = {k: round(s[k], 2) for k in ("min_ms", "median_ms", "max_ms")
             if k in s}
    if s.get("suspect"):
        brief["suspect"] = True
    return brief


def record_config(out: dict, name: str, result: dict) -> None:
    """Append this point to ``out["configs"]`` in the shared per-config
    schema (``costmodel.config_record``)."""
    from kubeoperator_tpu_torch.workloads.costmodel import config_record

    step_ms = result.get("step_time_ms")
    out.setdefault("configs", []).append(config_record(
        config=name, n_devices=result.get("chips", 1),
        step_time_s=step_ms / 1e3 if step_ms is not None else None,
        mfu=result.get("mfu"), step_ms=stats_brief(result)))


def headline(result: dict, peak_flops: float, device_kind: str,
             image_size: int) -> dict:
    """The headline keys of the line from the ResNet point's result."""
    return {
        "metric": "resnet50_img_per_sec_per_chip",
        "value": round(result["img_per_sec_per_chip"], 2),
        "unit": "img/s/chip",
        "vs_baseline": round(result["mfu"] / TARGET_MFU, 4),
        "mfu": round(result["mfu"], 4),
        "achieved_tflops": round(result["achieved_tflops"], 2),
        "peak_tflops_per_chip": round(peak_flops / 1e12, 1),
        "chips": result["chips"],
        "batch_per_chip": result["batch"] // result["chips"],
        "step_time_ms": round(result["step_time_ms"], 2),
        "device_kind": device_kind,
        "image_size": image_size,
        "step_ms": stats_brief(result),
    }


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main(on_point: Callable[[str, dict], None] | None = None,
         measured: dict[str, dict] | None = None) -> int:
    """Measure every point on the card and print the line. ``on_point``,
    if given, is called with each point's name and result as it ends.
    ``measured`` maps a point's name to a result its caller already took
    with the point's own configuration and ``measure()`` settings (here:
    LM_POINTS, LM_WARMUP, VIT_BATCH, VIT_MEASURE); that point is not
    measured again."""
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.train import (
        TrainConfig, Trainer, peak_flops_per_chip,
    )
    from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer

    peak = peak_flops_per_chip()          # raises without a known card
    done = on_point or (lambda name, result: None)
    measured = measured or {}
    image = 224
    out: dict = {}
    result = None
    for per_chip_batch in RESNET_BATCHES:
        cfg = TrainConfig(batch_size=per_chip_batch, image_size=image,
                          stem="space_to_depth", dw_dot_max_k=1)
        name = "resnet" if per_chip_batch == RESNET_BATCHES[0] else (
            "resnet-fallback")
        try:
            result = guarded(name, lambda: Trainer(
                cfg, workload=name).measure(**RESNET_MEASURE), out)
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"# batch {per_chip_batch}/chip failed: {e}",
                  file=sys.stderr)
            _release()
    if result is None:
        print(json.dumps({"metric": "resnet50_img_per_sec_per_chip",
                          "value": 0.0, "unit": "img/s/chip",
                          "vs_baseline": 0.0,
                          "error": "all batch sizes ran out of memory"}))
        return 1
    done(name, result)
    record_config(out, "resnet", result)
    out |= headline(result, peak, torch.cuda.get_device_name(), image)
    _release()

    lm_cfg = TransformerConfig(
        vocab_size=32_000, d_model=2048, n_heads=16, n_layers=4, d_ff=8192,
        max_seq_len=2048, dtype=torch.bfloat16, remat=True, attention="auto",
        logits_bf16=True, remat_policy="dots+attn")
    for name, seq, batch, policy, steps in LM_POINTS:
        cfg = dataclasses.replace(lm_cfg, max_seq_len=seq,
                                  remat_policy=policy)
        lm = measured.get(name) or guarded(name, lambda: LMTrainer(
            cfg, workload=name).measure(batch=batch, seq_len=seq,
                                        steps=steps, warmup=LM_WARMUP), out)
        done(name, lm)
        record_config(out, name, lm)
        if name == "llm":
            out["llm_mfu"] = round(lm["mfu"], 4)
            out["llm_tokens_per_sec"] = round(lm["tokens_per_sec"])
            out["llm_step_ms"] = stats_brief(lm)
        else:
            out[f"llm_mfu_seq{seq // 1024}k"] = round(lm["mfu"], 4)
        _release()

    # ViTConfig() is bench.py's ViT-B/16: packed flash at block 256, remat
    # dots+attn, unrolled layers
    vit = measured.get("vit") or guarded("vit", lambda: ViTTrainer(
        ViTConfig()).measure(batch=VIT_BATCH, **VIT_MEASURE), out)
    done("vit", vit)
    out["vit_mfu"] = round(vit["mfu"], 4)
    out["vit_img_per_sec_per_chip"] = round(vit["img_per_sec_per_chip"], 1)
    out["vit_step_ms"] = stats_brief(vit)
    record_config(out, "vit", vit)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
