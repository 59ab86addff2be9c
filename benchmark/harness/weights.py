"""Weights made from the seed, on the device, in one large draw.

A configuration lists its leaves as (name, shape, init, fan_in) with init
``"normal"`` (N(0, 1/fan_in)), ``"ones"`` or ``"zeros"``; every normal
leaf is a slice of one ``torch.randn`` on the card's generator, so the
same seed gives the same weights on every rank and on a second call, and
making them costs one kernel. They are f32, the type the trainers hold
their masters in.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness.traffic import sub_seed


def make(leaves: list[tuple], seed: int, device) -> dict:
    """{name: f32 tensor} in the order of ``leaves``."""
    total = sum(math.prod(shape) for _, shape, init, _ in leaves
                if init == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init, fan_in in leaves:
        n = math.prod(shape)
        if init == "normal":
            out[name] = flat[off:off + n].view(shape) * (1.0 / math.sqrt(fan_in))
            off += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out


def map_by_order(ours: dict, names: list[str], shapes: list[tuple]) -> dict:
    """``ours`` (the benchmark's leaves, in the model's order) under the
    program's parameter ``names``, each shape checked."""
    if len(ours) != len(names):
        raise ValueError(f"{len(ours)} leaves for {len(names)} parameters")
    out = {}
    for (ours_name, t), name, shape in zip(ours.items(), names, shapes):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{ours_name} {tuple(t.shape)} does not fit "
                             f"{name} {tuple(shape)}")
        out[name] = t
    return out
