"""The one traffic generator: a closed training loop over a pool of
distinct batches.

A mix is a data file (``traffic/<name>.json``):

- ``loop``: ``"closed"``, the next step dispatched as the last one is
  queued, as a training job's loop does;
- ``batch_per_chip``: images a card takes a step (the global batch is
  this times the cell's chips);
- ``pool``: distinct global batches, cycled;
- ``images``: ``"normal"`` (N(0, 1) pixels), ``labels``: ``"uniform"``;
- ``path``: the configuration's path (a key of its ``paths``);
- ``trace_steps``: steps in the profiled stretch of a ``--trace 1`` run,
  ``host_steps``: fenced steps that read the host's time in a call.

Every batch is made on the device from the seed and its index, so a seed
gives the same pool on every rank and every run; a rank keeps its block of
rows (rank ``r`` of ``w``: rows ``[r·b, (r+1)·b)``).
"""

from __future__ import annotations

import hashlib

import torch

FIRST_STEPS = 3         # the steps set-up drives and the reference follows


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one use of ``seed``, the same on every host."""
    text = ":".join(str(k) for k in (seed, *keys)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def check_mix(traffic: dict) -> None:
    for key, want in (("loop", "closed"), ("images", "normal"),
                      ("labels", "uniform")):
        if traffic.get(key) != want:
            raise ValueError(f"traffic {key}={traffic.get(key)!r}: the "
                             f"generator makes {want!r}")
    if traffic["pool"] < FIRST_STEPS:
        raise ValueError(f"a pool of {traffic['pool']} batches: the first "
                         f"{FIRST_STEPS} steps need rows that all differ")


def global_batch(traffic: dict, config: dict, seed: int, index: int,
                 world: int, device) -> tuple:
    """Batch ``index`` of the pool, whole: images [B, S, S, C] f32 and
    labels [B] int64, B = batch_per_chip · world."""
    b = traffic["batch_per_chip"] * world
    s, c = config["image_size"], config["channels"]
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "batch", index))
    images = torch.randn(b, s, s, c, generator=gen, device=device)
    labels = torch.randint(0, config["num_classes"], (b,), generator=gen,
                           device=device)
    return images, labels


def rank_pool(traffic: dict, config: dict, seed: int, rank: int,
              world: int, device) -> list[tuple]:
    """This rank's block of every batch of the pool."""
    check_mix(traffic)
    b = traffic["batch_per_chip"]
    pool = []
    for i in range(traffic["pool"]):
        images, labels = global_batch(traffic, config, seed, i, world, device)
        rows = slice(rank * b, (rank + 1) * b)
        pool.append((images[rows].contiguous(), labels[rows].contiguous()))
        del images, labels
    return pool
