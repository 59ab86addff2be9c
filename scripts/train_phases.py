"""The trainers' step phases on the card (``tracing.StepPhases``): what
they cost, and what they read in the benchmark's cells.

    python3 scripts/train_phases.py cost
    python3 scripts/train_phases.py cells <workload> [...] --seed N [--seconds 10]

``cost`` times, on the card, a loop of a step's phase entries and exits
with no work inside (the ResNet trainer's six phases, so seven markers a
step) beside a small kernel a step: µs a step with no profiler, and what
each call of a marker or a counter costs; beside it an inactive
``record_function`` and the profiler check that keeps ranges out of an
unprofiled step, µs each; and whether ``benchmark/harness/trace.py``
keeps a ``ko.train.*`` range's device-side annotation out of the device
list.

``cells`` runs each cell as ``benchmark/run.py --trace 1`` does (the
harness's own ``run_ranks``), and around the measured window and the
fenced steps flushes the markers and takes snapshots of the phase
counters: after the synchronize before the window, after the one that
closes it, and around the fenced steps, on every rank, the fenced steps
after a barrier of the ranks (without it the first fenced step's host
time holds the wait for the slowest rank). From the deltas it prints, a
line a cell, the numbers the per-layer readers would give (``fwd_ms``,
``bwd_ms``, ``opt_ms``, the ``metrics`` and ``step`` phases' device ms a
window step, ``host_step_ms``, ``host_fwd_ms``, ``host_bwd_ms``; over
several cards ``reduce_ms.dp`` and ``host_step_ms.dp``) beside the
harness's own metrics and the traced stretch's ms a step. Needs the cards
the cell asks for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------

def one_step(ph) -> None:
    with ph.step():
        with ph.phase("optimizer"):
            pass
        with ph.phase("forward"):
            pass
        with ph.phase("backward"):
            pass
        with ph.phase("optimizer"):
            pass
        with ph.phase("metrics"):
            pass


def cost(steps: int = 2000, repeats: int = 5) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import trace
    from kubeoperator_tpu_torch.telemetry.metrics import Registry
    from kubeoperator_tpu_torch.telemetry.tracing import StepPhases

    dev = torch.device("cuda", 0)
    ph = StepPhases("cost", dev, registry=Registry())
    x = torch.ones(1 << 20, device=dev)
    per_step = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        ph.flush()
        t = time.perf_counter()
        for _ in range(steps):
            one_step(ph)
            x.add_(1.0)          # the card stays behind, as in training
        per_step.append((time.perf_counter() - t) / steps * 1e6)
    torch.cuda.synchronize()
    ph.flush()
    empty = []
    for _ in range(repeats):
        t = time.perf_counter()
        for _ in range(steps):
            x.add_(1.0)
        empty.append((time.perf_counter() - t) / steps * 1e6)
    torch.cuda.synchronize()
    n = 20000
    t = time.perf_counter()
    for _ in range(n):
        with record_function("ko.train.forward"):
            pass
    inactive_range_us = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for _ in range(n):
        torch.autograd._profiler_enabled()
    check_us = (time.perf_counter() - t) / n * 1e6
    parts = calls(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.STEP):
            one_step(ph)
            with ph.step():
                with ph.phase("forward"):
                    x.mul_(0.5)
        with record_function(trace.SYNC):
            torch.cuda.synchronize()
    got = trace.extract(prof)
    leaked = sorted({d[0] for d in got["device"] if d[0].startswith("ko.")})
    hosted = sorted({o[0] for o in got["ops"] if o[0].startswith("ko.")})
    annotations = sorted({e.name for e in prof.events()
                          if e.name.startswith("ko.")
                          and e.device_type != torch.autograd.DeviceType.CPU})
    return {"phase": "cost", "device": torch.cuda.get_device_name(dev),
            "torch": torch.__version__,
            "loop_us_a_step": sorted(per_step),
            "bare_loop_us_a_step": sorted(empty),
            "phases_us_a_step": sorted(per_step)[repeats // 2]
            - sorted(empty)[repeats // 2],
            "inactive_range_us": inactive_range_us,
            "profiler_check_us": check_us, "calls_us": parts,
            "ko_ranges_on_host": hosted,
            "ko_annotations_on_device": annotations,
            "ko_in_device_list": leaked}


def calls(torch, dev, n: int = 5000) -> dict:
    """µs a call of what a step's markers and counters do."""
    from kubeoperator_tpu_torch.telemetry.metrics import (
        Registry, declare_train_metrics,
    )
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    stream = torch.cuda.current_stream(dev)
    out = {}
    t = time.perf_counter()
    for ev in evs[:n]:
        ev.record(stream)
    out["record"] = (time.perf_counter() - t) / n * 1e6
    evs[n].record(stream)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for a, b in zip(evs, evs[1:]):
        a.elapsed_time(b)
    out["elapsed_time"] = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for ev in evs[:n]:
        ev.query()
    out["query"] = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for _ in range(n):
        torch.cuda.current_stream(dev)
    out["current_stream"] = (time.perf_counter() - t) / n * 1e6
    c = declare_train_metrics(Registry())["phase_host"]
    t = time.perf_counter()
    for _ in range(n):
        c.inc(1e-3, workload="w", phase="forward")
    out["counter_inc"] = (time.perf_counter() - t) / n * 1e6
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def snapshot(subject, dev) -> dict:
    """The phase counters of the subject's workload, its finished markers
    counted first (the caller has synchronized)."""
    import torch

    from kubeoperator_tpu_torch.telemetry.metrics import (
        REGISTRY, declare_train_metrics,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ph = subject.trainer.phases
    ph.flush()
    fams = declare_train_metrics(REGISTRY)
    w = ph.workload

    def by_phase(fam):
        return {k[1]: v for k, v in fams[fam].samples().items()
                if k[0] == w}

    return {"steps": fams["steps"].value(workload=w),
            "skipped": fams["phase_skipped"].value(workload=w),
            "host": by_phase("phase_host"),
            "device": by_phase("phase_device")}


def delta(a: dict, b: dict) -> dict:
    return {"steps": b["steps"] - a["steps"],
            "skipped": b["skipped"] - a["skipped"],
            **{k: {p: b[k][p] - a[k].get(p, 0.0) for p in b[k]}
               for k in ("host", "device")}}


def install() -> None:
    """Wrap the harness's window and fenced steps in snapshots, here and in
    every rank that ``driver.run_ranks`` spawns; the fenced steps one at a
    time, so each step's host seconds are kept, after a barrier of the
    ranks."""
    import torch.distributed as dist

    from benchmark.harness import driver
    window, fenced = driver.window, driver.fenced

    def phased_window(subject, pool, seconds, ctrl, dev, start, warm):
        a = snapshot(subject, dev)
        rec = window(subject, pool, seconds, ctrl, dev, start, warm)
        rec["phases"] = delta(a, snapshot(subject, dev))
        return rec

    def phased_fenced(subject, pool, first, steps, dev):
        if dist.is_initialized():
            dist.barrier()
        a = snapshot(subject, dev)
        rec, each = {"steps": 0, "call_s": 0.0}, []
        for k in range(steps):
            b = snapshot(subject, dev)
            one = fenced(subject, pool, first + k, 1, dev)
            each.append(delta(b, snapshot(subject, dev))["host"]["step"])
            rec["steps"] += one["steps"]
            rec["call_s"] += one["call_s"]
        rec["phases"] = delta(a, snapshot(subject, dev))
        rec["step_host_s"] = each
        return rec

    driver.window, driver.fenced = phased_window, phased_fenced
    driver.rank_entry = spawned_rank


def spawned_rank(*args) -> None:
    """A rank of ``driver.run_ranks``: the harness's own, with the
    snapshots installed."""
    from benchmark.harness import driver
    entry = driver.rank_entry
    install()
    entry(*args)


def readings(recs: list[dict]) -> dict:
    """What the proposed per-layer readers would give (ms)."""
    win = recs[0]["window"]
    ph, n = win["phases"], win["steps"]
    dev = {p: s / n * 1e3 for p, s in ph["device"].items()}
    out = {"window_steps": n, "marked_steps": ph["steps"],
           "skipped": ph["skipped"],
           "device_ms": dev,
           "fwd_ms": dev.get("forward"), "bwd_ms": dev.get("backward"),
           "opt_ms": dev.get("optimizer"),
           "children_ms": sum(v for p, v in dev.items() if p != "step")}
    host = []
    for r in recs:
        h = r["host"]["phases"]
        k = h["steps"]
        host.append({p: s / k * 1e3 for p, s in h["host"].items()})
    out["host_ms"] = host[0]
    out["host_step_ms"] = host[0]["step"]
    out["host_fwd_ms"] = host[0]["forward"]
    out["host_bwd_ms"] = host[0]["backward"]
    if len(recs) > 1:
        out["reduce_ms.dp"] = dev.get("grad_reduce")
        out["host_step_ms.dp"] = max(h["step"] for h in host)
        out["host_step_ms_by_rank"] = [h["step"] for h in host]
        out["fenced_step_ms_by_rank"] = [
            [x * 1e3 for x in r["host"]["step_host_s"]] for r in recs]
    return out


def cells(names: list[str], seed: int, seconds: float) -> list[dict]:
    import torch

    from benchmark.harness import driver
    from benchmark.harness import spec as specmod
    install()
    out = []
    for name in names:
        cell = specmod.resolve(specmod.load_spec(), name)
        opts = {"seed": seed, "seconds": seconds, "trace": True,
                "start": time.time()}
        recs = driver.run_ranks(cell, "run", {"opts": opts})
        line = driver.result_line(cell, recs, True,
                                  torch.cuda.get_device_name(0),
                                  driver.card_info())
        r0 = recs[0]
        step_ms = r0["window"]["seconds"] / r0["window"]["steps"] * 1e3
        t = r0["trace"]
        rec = {"phase": "cells", "workload": name, "seed": seed,
               "correct": line["correct"], "card": line["card"],
               "train_step_ms": step_ms,
               "traced_ms_a_step": t["window_s"] / t["steps"] * 1e3,
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "idle_gaps": line["breakdown"]["idle_gaps"],
               **readings(recs)}
        dev = rec["device_ms"]
        rec["step_vs_window"] = dev["step"] / step_ms - 1.0
        rec["children_vs_window"] = rec["children_ms"] / step_ms - 1.0
        if "host_ms_per_step" in rec["metrics"]:
            rec["host_step_vs_harness"] = (
                rec["host_step_ms"] / rec["metrics"]["host_ms_per_step"]
                - 1.0)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("cost")
    c = sub.add_parser("cells")
    c.add_argument("workloads", nargs="+")
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from benchmark import run as bench_run
    bench_run.environment()
    if args.cmd == "cost":
        print(json.dumps(cost()), flush=True)
    else:
        cells(args.workloads, args.seed, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
