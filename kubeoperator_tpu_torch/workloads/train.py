"""Measurement helpers shared by the port's trainers: the card's peak, the
warmup/fence/timed loop, and per-step statistics. Counterparts of
``peak_flops_per_chip``, ``timed_steps`` and ``step_stats`` in
``kubeoperator_tpu/workloads/train.py``.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

# Peak dense bf16 FLOP/s and HBM bytes/s by device-name substring (NVIDIA's
# data sheets). Order matters: the first match wins.
PEAKS = (
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 sxm", 989e12, 3.35e12),
    ("h100 80gb hbm3", 989e12, 3.35e12),    # the SXM part's device name
    ("h200", 989e12, 4.8e12),
)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on the card unless asked for the CPU:
    ``None`` means ``"cuda"``, and CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless "
                           "the caller passes device='cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _peaks(device) -> tuple[float, float]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no published peak for device type {dev.type!r}")
    name = torch.cuda.get_device_name(dev).lower()
    for key, flops, hbm in PEAKS:
        if key in name:
            return flops, hbm
    raise ValueError(f"unknown card {name!r}: add its bf16 dense peak and "
                     f"HBM rate to PEAKS")


def peak_flops_per_chip(device: str | torch.device | None = None) -> float:
    """bf16 dense peak of the card, from its name. Raises for a device this
    table does not know rather than guessing."""
    return _peaks(device)[0]


def peak_hbm_bytes_per_chip(device: str | torch.device | None = None) -> float:
    """HBM bytes/s of the card, from its name; raises like
    ``peak_flops_per_chip``."""
    return _peaks(device)[1]


def _fence(metrics: dict) -> None:
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in metrics.values()):
        torch.cuda.synchronize()
    float(next(iter(metrics.values())))


def timed_steps(step_fn: Callable, state: Any, inputs: tuple, steps: int,
                warmup: int, repeats: int = 3) -> tuple[Any, list[float]]:
    """``warmup`` steps, then ``repeats`` blocks of ``steps`` calls with one
    fence per block (``torch.cuda.synchronize`` plus a host read of the
    first metric). Returns (state, per-repeat seconds per step)."""
    warmup = max(1, warmup)
    for _ in range(warmup):
        state, metrics = step_fn(state, *inputs)
    _fence(metrics)
    times: list[float] = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step_fn(state, *inputs)
        _fence(metrics)
        times.append((time.perf_counter() - t0) / steps)
    return state, times


def step_stats(times: list[float], steps_per_call: int = 1) -> dict:
    """min/median/max/mean per-step milliseconds from per-repeat seconds;
    ``suspect`` when the slowest repeat is over twice the median."""
    ts = sorted(t / steps_per_call * 1e3 for t in times)
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    return {"min_ms": ts[0], "median_ms": med, "max_ms": ts[-1],
            "mean_ms": sum(ts) / n, "n_repeats": n,
            "suspect": bool(ts[-1] > 2.0 * med)}
