"""The readings that the correctness limits are set from, at a cell's own
size, in one process a card (``benchmark/calibrate.py``):

- ``program``: the program's first steps against the reference, per seed
  (the lower readings: the largest over a dozen seeds or more);
- ``control``: the reference computed in fp8 (the precision below the
  configuration's bf16) against the same reference in f32;
- a fault (``harness.faults``) planted under the program, per seed.

No measured window: training's readings need none.
"""

from __future__ import annotations

import time

from benchmark.harness import compare
from benchmark.harness.driver import (
    free, kernel_mask, prepare, rank_device, reference_numbers,
)


def readings_rank(rank: int, world: int, cell, payload: dict,
                  device_type: str = "cuda") -> dict:
    dev = rank_device(rank, device_type)
    mod = cell.module()
    kernels = kernel_mask(cell)
    refs: dict[int, dict] = {}
    out = []

    def reference(seed):
        if seed not in refs:
            refs[seed] = reference_numbers(cell, mod, seed, dev, world)
            free(dev)
        return refs[seed]

    def program(seed, fault):
        t = time.perf_counter()
        subject, pool, numbers, undo = prepare(cell, mod, seed, dev, rank,
                                               world, fault)
        undo()
        del subject, pool
        free(dev)
        if rank != 0:
            return
        prog_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = reference(seed)
        out.append({"kind": fault or "program", "seed": seed,
                    **compare.training_numbers(numbers, ref, kernels),
                    "program_s": prog_s,
                    "reference_s": time.perf_counter() - t,
                    "losses": numbers["losses"],
                    "reference_losses": ref["losses"]})

    for seed in payload.get("seeds", []):
        program(seed, None)
    for fault in payload.get("faults", []):
        for seed in payload.get("fault_seeds", []):
            program(seed, fault)
    if rank == 0:
        for seed in payload.get("control_seeds", []):
            ref = reference(seed)
            t = time.perf_counter()
            low = reference_numbers(cell, mod, seed, dev, world, "fp8")
            free(dev)
            out.append({"kind": "control", "seed": seed,
                        **compare.training_numbers(low, ref, kernels),
                        "control_s": time.perf_counter() - t,
                        "losses": low["losses"],
                        "reference_losses": ref["losses"]})
    return {"rank": rank, "readings": out}
