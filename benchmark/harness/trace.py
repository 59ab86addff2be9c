"""From a ``torch.profiler`` trace of the profiled stretch to the records
the per-layer readers take.

``extract`` turns the profiler's events into plain lists (so the readers
can be tested on a made-up trace):

- ``device``: [name, start_us, end_us] of each kernel, copy and set on
  the card (the profiler's own user-annotation ranges left out);
- ``ops``: [name, start_us, end_us, device_us, parent] of each host op
  and range, ``device_us`` the device time of every kernel launched
  inside it (its children's included), ``parent`` the index of the op it
  runs inside, or -1.

``reduce`` cuts them to the stretch (from the first of the harness's
``portbench.step`` ranges to the end of its ``portbench.sync``) and sums:
the busy time (the union of device intervals), the device time by kernel
and by class (``kernel_class``, a copy of ``profile_lm.kernel_class`` with
NCCL's kernels and the card's copies and sets given classes of their
own), the device time inside named op ranges (a configuration's
``OP_RANGES``: each range's outermost matching ops), and the idle gaps,
each labelled by the innermost host op running when it began.
"""

from __future__ import annotations

STEP, SYNC = "portbench.step", "portbench.sync"
TOP = 10


def kernel_class(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "nccl"
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
    if "copy_kernel" in low or "memcpy" in low or "memset" in low:
        return "casts and copies"
    if "index" in low or "gather" in low:
        return "gather/scatter (indexing)"
    return "other elementwise/reduction"


def _device_us(e) -> float:
    v = getattr(e, "device_time_total", None)
    return float(e.cuda_time_total if v is None else v)


def _is_annotation(e) -> bool:
    # the profiler's ranges (record_function, "Optimizer.step#SGD.step")
    # also appear on the device's timeline, over the kernels they hold;
    # kernel names may hold "#" too, but always with a parenthesis
    return bool(getattr(e, "is_user_annotation", False)) or (
        "#" in e.name and "(" not in e.name) or e.name.startswith("portbench.")


def extract(prof) -> dict:
    from torch.autograd import DeviceType
    device, ops, index = [], [], {}
    events = list(prof.events())
    for e in events:
        if e.device_type == DeviceType.CPU:
            index[id(e)] = len(ops)
            ops.append([e.name, float(e.time_range.start),
                        float(e.time_range.end), _device_us(e), -1])
        elif not _is_annotation(e):
            device.append([e.name, float(e.time_range.start),
                           float(e.time_range.end)])
    for e in events:
        if e.device_type == DeviceType.CPU and e.cpu_parent is not None:
            ops[index[id(e)]][4] = index.get(id(e.cpu_parent), -1)
    return {"device": device, "ops": ops}


def _merge(intervals: list[tuple]) -> list[list]:
    out: list[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(ops: list, at: float) -> str:
    """The innermost host op running at ``at``: the latest-starting op
    whose range holds it."""
    best = None
    for name, s, e, _, _ in ops:
        if s <= at < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "(no host op)"


def _outermost(ops: list, patterns: tuple) -> list[int]:
    def hit(i):
        return any(p in ops[i][0] for p in patterns)

    out = []
    for i in range(len(ops)):
        if not hit(i):
            continue
        j = ops[i][4]
        while j >= 0 and not hit(j):
            j = ops[j][4]
        if j < 0:
            out.append(i)
    return out


def reduce(rec: dict, op_ranges: dict, steps: int) -> dict:
    """The stretch's summary: ``window_s``, ``busy_s``, ``steps``,
    ``class_s`` and ``top_kernels`` (device seconds), ``op_device_s``
    (device seconds in each of ``op_ranges``), ``gaps`` (the longest idle
    gaps, [label, seconds])."""
    ops = rec["ops"]
    starts = [o[1] for o in ops if o[0] == STEP]
    ends = [o[2] for o in ops if o[0] == SYNC]
    if not starts or not ends:
        raise ValueError("the trace holds no portbench.step or "
                         "portbench.sync range")
    t0, t1 = min(starts), max(ends)
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in rec["device"]
              if e > t0 and s < t1]
    busy = _merge([(s, e) for _, s, e in inside])
    kernel_us: dict[str, float] = {}
    class_us: dict[str, float] = {}
    for name, s, e in inside:
        kernel_us[name] = kernel_us.get(name, 0.0) + (e - s)
        cls = kernel_class(name)
        class_us[cls] = class_us.get(cls, 0.0) + (e - s)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if t1 > prev:
        gaps.append((prev, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    in_stretch = [o for o in ops if o[1] < t1 and o[2] > t0]
    op_us = {}
    for key, patterns in op_ranges.items():
        hits = [i for i in _outermost(ops, tuple(patterns))
                if t0 <= ops[i][1] < t1]
        op_us[key] = sum(ops[i][3] for i in hits)
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "steps": steps,
        "class_s": {k: v / 1e6 for k, v in class_us.items()},
        "top_kernels": [[n[:160], us / 1e6] for n, us in top],
        "op_device_s": {k: v / 1e6 for k, v in op_us.items()},
        "gaps": [[_label(in_stretch, s), (e - s) / 1e6]
                 for s, e in gaps[:TOP]],
    }
