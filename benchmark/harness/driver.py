"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference, and the result line.

A rank (one process a card):

1. makes the weights and its block of the batch pool from the seed, on
   its card, builds the port's trainer from them (the configuration's
   ``build``), and drives it through its first three steps through the
   window's own call: that is the warm-up (the kernels build or load,
   every shape of the cell runs) and what the reference follows;
2. opens the window after a ``torch.cuda.synchronize()`` (and, over
   several cards, a barrier), dispatches train steps back to back, as the
   job's loop does, for as long as ``--seconds`` lasts, and closes it
   with a synchronize after the last step it started: ``train_step_ms`` is
   the window's time over its steps. Over several cards every rank has to
   run the same steps, and no host collective may stop them in the
   window: the ranks agree once, before it opens, on as many steps as
   ``--seconds`` holds at rank 0's pace in its warm-up (its last steps,
   fenced), and the window runs that many;
3. with ``--trace 1`` then profiles ``trace_steps`` more steps
   (``portbench.step`` ranges, unfenced) and times ``host_steps`` fenced
   ones (the host's wall time inside the call);
4. reads its peak memory, frees the program's state, and, on rank 0, runs
   the plain reference over the same weights and rows
   (``compare.training_numbers``).

Several cards: the ranks are ``torch.multiprocessing`` processes started
by the port's ``train/launch.py::spawn`` (NCCL, its store under
``TMPDIR``); each writes its record there, and the process that started
them prints the line.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from benchmark.harness import compare, faults, isolation, peaks, trace
from benchmark.harness import spec as specmod
from benchmark.harness import traffic as tr
from benchmark.harness.traffic import FIRST_STEPS

COLLECTIVE_TIMEOUT_S = 300.0
DEADLINE_S = 1150.0     # a first run builds the kernels on every rank


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py",
                                 description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(ctrl) -> None:
    if ctrl is not None:
        import torch.distributed as dist
        dist.barrier(group=ctrl)


def prepare(cell, mod, seed: int, dev, rank: int, world: int,
            fault: str | None = None):
    """Build the subject from the seed and drive it through its first
    steps. Returns (subject, pool, program numbers, undo of ``fault``)."""
    params = mod.make_params(cell.config, seed, dev)
    subject = mod.build(cell.config, cell.traffic, params, dev, world)
    del params
    pool = tr.rank_pool(cell.traffic, cell.config, seed, rank, world, dev)
    undo = faults.install(fault, subject)
    losses, grads = [], None
    for i in range(FIRST_STEPS):
        metrics = subject.step(*pool[i])
        losses.append(metrics["loss"].detach().float().clone())
        if i == 0:
            grads = compare.leaf_norms(mod.raw_grads(subject))  # reads back
            t_warm = time.perf_counter()
    _sync(dev)
    warm_step_s = (time.perf_counter() - t_warm) / (FIRST_STEPS - 1)
    p0 = mod.make_params(cell.config, seed, dev)
    change = compare.leaf_norms([p.detach() - q for p, q in
                                 zip(subject.params(), p0.values(),
                                     strict=True)])
    del p0
    program = {"losses": [float(x) for x in losses], "grad_norms": grads,
               "change_norms": change, "warm_step_s": warm_step_s}
    return subject, pool, program, undo


def agreed_steps(seconds: float, warm_step_s: float, ctrl) -> int:
    """The steps ``seconds`` holds at rank 0's warm pace, the same on every
    rank (one broadcast on the CPU group)."""
    import torch
    import torch.distributed as dist
    n = torch.tensor([max(1, int(seconds / warm_step_s))], dtype=torch.int64)
    dist.broadcast(n, 0, group=ctrl)
    return int(n[0])


def window(subject, pool, seconds: float, ctrl, dev, start: float,
           warm_step_s: float) -> dict:
    steps = None if ctrl is None else agreed_steps(seconds, warm_step_s,
                                                   ctrl)
    _sync(dev)
    _barrier(ctrl)
    t_open = time.perf_counter()
    setup_s = time.time() - start
    i, n, metrics = FIRST_STEPS, 0, None
    while (n < steps if steps is not None
           else time.perf_counter() - t_open < seconds):
        metrics = subject.step(*pool[i % len(pool)])
        i, n = i + 1, n + 1
    _sync(dev)
    t_close = time.perf_counter()
    return {"steps": n, "seconds": t_close - t_open, "setup_s": setup_s,
            "next": i, "last_loss": float(metrics["loss"])}


def traced(subject, pool, first: int, steps: int, mod, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for k in range(steps):
            with record_function(trace.STEP):
                subject.step(*pool[(first + k) % len(pool)])
        with record_function(trace.SYNC):
            _sync(dev)
    return trace.reduce(trace.extract(prof), mod.OP_RANGES, steps)


def fenced(subject, pool, first: int, steps: int, dev) -> dict:
    """The host's wall time inside ``steps`` train-step calls, each begun
    on an empty launch queue (a synchronize before and after)."""
    inside = 0.0
    for k in range(steps):
        _sync(dev)
        t = time.perf_counter()
        subject.step(*pool[(first + k) % len(pool)])
        inside += time.perf_counter() - t
        _sync(dev)
    return {"steps": steps, "call_s": inside}


def reference_numbers(cell, mod, seed: int, dev, world: int,
                      precision: str = "f32") -> dict:
    """The plain reference over the first steps' weights and global rows."""
    params = mod.make_params(cell.config, seed, dev)
    batches = [tr.global_batch(cell.traffic, cell.config, seed, i, world, dev)
               for i in range(FIRST_STEPS)]
    return mod.reference(cell.config, cell.traffic, params, batches, world,
                         precision)


def free(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def rank_device(rank: int, device_type: str):
    import torch
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def pin_threads(rank: int, world: int) -> None:
    """Give each of ``world`` ranks on one host its own block of this
    process's cores, every thread of the process included (the collectives
    make a step wait for the slowest rank's host)."""
    import os
    cores = sorted(os.sched_getaffinity(0))
    share = len(cores) // world
    if world == 1 or share == 0:
        return
    mine = cores[rank * share:(rank + 1) * share]
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mine)
        except OSError:         # a thread that ended meanwhile
            pass


def control_group(world: int):
    if world == 1:
        return None
    import torch.distributed as dist
    return dist.new_group(backend="gloo")


def run_rank(rank: int, world: int, cell, opts: dict,
             device_type: str = "cuda", fault: str | None = None) -> dict:
    """One rank's run (see the module docstring); the reference's numbers
    on rank 0 only."""
    import torch
    dev = rank_device(rank, device_type)
    ctrl = control_group(world)
    pin_threads(rank, world)
    mod = cell.module()
    seed = opts["seed"]
    subject, pool, program, undo = prepare(cell, mod, seed, dev, rank, world,
                                           fault)
    win = window(subject, pool, opts["seconds"], ctrl, dev, opts["start"],
                 program["warm_step_s"])
    rec = {"rank": rank, "window": win, "program": program}
    t = time.perf_counter()
    if opts["trace"]:
        first = win["next"]
        rec["trace"] = traced(subject, pool, first,
                              cell.traffic["trace_steps"], mod, dev)
        rec["host"] = fenced(subject, pool,
                             first + cell.traffic["trace_steps"],
                             cell.traffic["host_steps"], dev)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    undo()
    del subject, pool
    free(dev)
    traced_s = time.perf_counter() - t
    if rank == 0:
        rec["reference"] = reference_numbers(cell, mod, seed, dev, world)
        free(dev)
    rec["timings"] = {"traced_s": traced_s,
                      "reference_s": time.perf_counter() - t - traced_s}
    isolation.assert_isolated(f"rank {rank}")
    return rec


# ---------------------------------------------------------------------------
# several ranks
# ---------------------------------------------------------------------------

def rank_entry(rank: int, world: int, kind: str, cell, payload: dict,
               device_type: str, outdir: str) -> None:
    """A spawned rank: ``run_rank`` (kind "run") or the readings of
    ``harness.readings`` (kind "readings"); its record goes to
    ``outdir/rank<r>.json``."""
    if kind == "run":
        rec = run_rank(rank, world, cell, payload["opts"], device_type,
                       payload.get("fault"))
    else:
        from benchmark.harness import readings
        rec = readings.readings_rank(rank, world, cell, payload, device_type)
    with open(Path(outdir) / f"rank{rank}.json", "w") as f:
        json.dump(rec, f)


def run_ranks(cell, kind: str, payload: dict, device_type: str = "cuda",
              deadline_s: float = DEADLINE_S) -> list[dict]:
    """``kind`` on every rank of the cell: in this process on one card,
    else in ``cell.chips`` spawned processes. Returns the ranks' records,
    rank 0 first."""
    if cell.chips == 1:
        if kind == "run":
            return [run_rank(0, 1, cell, payload["opts"], device_type,
                             payload.get("fault"))]
        from benchmark.harness import readings
        return [readings.readings_rank(0, 1, cell, payload, device_type)]
    from kubeoperator_tpu_torch.train import launch
    outdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        launch.spawn(rank_entry, cell.chips,
                     (kind, cell, payload, device_type, outdir),
                     backend="nccl" if device_type == "cuda" else "gloo",
                     store=str(Path(outdir) / "store"),
                     timeout_s=COLLECTIVE_TIMEOUT_S, deadline_s=deadline_s)
        recs = []
        for r in range(cell.chips):
            with open(Path(outdir) / f"rank{r}.json") as f:
                recs.append(json.load(f))
        return recs
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

def card_info() -> dict:
    """The card's name and power limit (``nvidia-smi``); None where it
    cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {"power_limit": None}
    return {"power_limit": out[0].split(",")[-1].strip() if out else None}


def reader_input(cell, recs: list[dict], kind: str) -> dict:
    """What the metric readers read: the run's records, the frozen counts
    and bounds of the configuration, and the card's peaks."""
    mod = cell.module()
    r0 = recs[0]
    try:
        peak_flops, peak_bytes = peaks.peaks_for(kind)
    except ValueError:
        peak_flops = peak_bytes = None
    win = r0["window"]
    return {
        "chips": cell.chips, "global_batch": cell.global_batch,
        "setup_s": win["setup_s"], "steps": win["steps"],
        "step_s": win["seconds"] / win["steps"],
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in recs),
        "flops_per_step": 3 * mod.flops_per_image(cell.config)
        * cell.global_batch,
        "peak_flops": peak_flops,
        "bounds": (mod.layer_bounds(cell.config, cell.traffic, peak_flops,
                                    peak_bytes)
                   if peak_flops is not None else {}),
        "trace": r0.get("trace"), "host": r0.get("host"),
    }


def kernel_mask(cell) -> list[bool]:
    """Which of the configuration's leaves are kernels (two or more axes)."""
    return [len(shape) > 1 for _, shape, _, _ in cell.module().leaves(
        cell.config)]


def result_line(cell, recs: list[dict], traced_run: bool, kind: str,
                card: dict) -> dict:
    r0 = recs[0]
    numbers = compare.training_numbers(r0["program"], r0["reference"],
                                       kernel_mask(cell))
    correct, checks = compare.judge(numbers, cell.limits)
    run = reader_input(cell, recs, kind)
    metrics = {}
    for m in (cell.per_layer if traced_run else cell.end_to_end):
        value = specmod.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": r0["window"]["steps"],
            "failed": (0 if math.isfinite(r0["window"]["last_loss"])
                       else r0["window"]["steps"]),
            "metrics": metrics, "device": device}
    if traced_run:
        device["busy_s"] = statistics.mean(r["trace"]["busy_s"] for r in recs)
        device["window_s"] = r0["trace"]["window_s"]
        line["breakdown"] = {"device_ops": r0["trace"]["top_kernels"],
                             "idle_gaps": r0["trace"]["gaps"]}
    line["card"] = card
    line["timings"] = r0["timings"]
    line["readings"] = {k: v for k, v in numbers.items()
                        if k not in cell.limits}
    line["checks"] = checks
    return line


def main(argv, start: float) -> int:
    args = parse(argv)
    cell = specmod.resolve(specmod.load_spec(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    opts = {"seed": args.seed, "seconds": args.seconds,
            "trace": bool(args.trace), "start": start}
    recs = run_ranks(cell, "run", {"opts": opts})
    bad = isolation.forbidden_loaded()
    if bad:
        print(f"portbench: loaded {bad} once the window closed",
              file=sys.stderr)
        return 3
    line = result_line(cell, recs, bool(args.trace),
                       torch.cuda.get_device_name(0), card_info())
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
