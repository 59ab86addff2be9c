"""Process groups for the port's multi-device jobs: one process per
device, the counterpart of JAX's one controller over many devices.

``maybe_initialize_distributed`` joins the group ``torchrun`` describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/
``MASTER_PORT``): NCCL on cards, gloo for ``--device cpu``, with an
explicit timeout.
``spawn`` starts the ranks itself with ``torch.multiprocessing`` (spawn
method) on a ``file://`` store, runs a function on every rank and joins
them within a deadline: the multi-rank CPU tests and ``chip_smoke.py``'s
several-card phase use it. A rank that raises fails the whole run.

    torchrun --nproc-per-node N -m kubeoperator_tpu_torch.train.jobs llm \\
        --mesh dp:2,tp:2 ...
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

# how long a collective may wait for the other ranks before the group
# gives up (gloo and NCCL both enforce it)
TIMEOUT = timedelta(seconds=600)


def backend_for(device: str | None) -> str:
    """gloo for the CPU, NCCL for cards (``None`` means the card)."""
    return "gloo" if device is not None and str(device).startswith("cpu") \
        else "nccl"


def group_info() -> dict:
    if not dist.is_initialized():
        return {"process_id": 0, "num_processes": 1}
    return {"process_id": dist.get_rank(),
            "num_processes": dist.get_world_size()}


def maybe_initialize_distributed(device: str | None = None,
                                 timeout: timedelta = TIMEOUT) -> dict:
    """Join the group ``torchrun`` describes (NCCL on cards, gloo for
    ``device`` "cpu"), if it describes one and none is joined yet: the
    counterpart of the JAX jobs' ``jax.distributed.initialize``. Returns
    {process_id, num_processes} for the records; {0, 1} without ``RANK``
    in the environment."""
    if dist.is_initialized() or "RANK" not in os.environ:
        return group_info()
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 os.environ["RANK"])))
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=timeout)
    return group_info()


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_method: str, timeout_s: float, args: tuple) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, backend: str,
          store: str, timeout_s: float = 60.0,
          deadline_s: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` new processes joined in
    one ``backend`` group through the file ``store`` (which must not
    exist yet), each collective bounded by ``timeout_s``. Raises if a rank
    raises, or kills them all and raises ``TimeoutError`` when they have
    not finished after ``deadline_s``. ``fn`` must be importable by name
    (the spawn method pickles it)."""
    import torch.multiprocessing as mp

    if os.path.exists(store):
        raise FileExistsError(f"store {store} exists: a stale group would "
                              f"join it")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, f"file://{store}", timeout_s,
                          args),
        nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(0.0, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
