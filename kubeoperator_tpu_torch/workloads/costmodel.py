"""Collective cost model, schedule models, step attribution and benchmark
records: the counterpart of ``kubeoperator_tpu/workloads/costmodel.py``.

One ``LinkModel`` (per-hop latency + per-link rate) prices each
collective a schedule issues. The schedule models split a step into
compute and collectives:

* ``fsdp_step_model`` — the chunked ZeRO-3 step, overlapped or eager,
  and ``fsdp_overlap_win``, their ratio;
* ``gpipe_step_model`` — the fill/drain schedule, its bubble measured
  from two simulated step times by ``pipeline.bubble_from_timings``;
* ``ring_attention_model`` — one ring-attention forward, block compute
  against the K/V hop;
* ``reference_overlap_win`` — the overlap win at ``REFERENCE_LLM``'s
  scale.

``attribute`` scales a model's shares onto a measured step, and on a
card ``profiled_collective_seconds`` reads the NCCL kernels' device time
from ``torch.profiler`` instead. Peaks and links come from the card's
own tables (``train.PEAKS``/``peaks_for``, ``LINKS``/``link_for``),
never from the reference's TPU constants, so every model takes them as
arguments. ``config_record`` is the one per-config schema the benches
share.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubeoperator_tpu_torch.workloads.pipeline import bubble_from_timings

COLLECTIVES = ("all_gather", "reduce_scatter", "ppermute", "all_reduce")


@dataclass(frozen=True)
class LinkModel:
    """One inter-device link: fixed per-hop cost + streaming rate (bytes/s
    each way)."""

    latency_s: float
    bytes_per_s: float


# NVLink rate each way between two cards of one host, by device-name
# substring (NVIDIA's H100 and H200 data sheets: 900 GB/s NVLink per card,
# 450 GB/s each way). The data sheets give no per-hop latency, so the
# model carries none. Order matters: the first match wins.
LINKS = (
    ("h100 pcie", None),                   # NVLink bridge pairs only
    ("h100", LinkModel(latency_s=0.0, bytes_per_s=450e9)),
    ("h200", LinkModel(latency_s=0.0, bytes_per_s=450e9)),
)


def link_for(device_name: str) -> LinkModel:
    """The card's NVLink model from ``LINKS``; raises for a card the
    table does not know rather than guessing."""
    name = device_name.lower()
    for key, link in LINKS:
        if key in name:
            if link is None:
                break
            return link
    raise ValueError(f"no NVLink rate for {device_name!r}: add it to LINKS")


def ici_hops(kind: str, n_devices: int) -> int:
    """Hops on the critical path of one collective over ``n_devices``
    (ring algorithms for gather/scatter/reduce, one hop for a permute)."""
    if n_devices <= 1:
        return 0
    if kind in ("all_gather", "reduce_scatter"):
        return n_devices - 1
    if kind == "all_reduce":                   # reduce-scatter + all-gather
        return 2 * (n_devices - 1)
    if kind == "ppermute":
        return 1
    raise ValueError(f"unknown collective {kind!r}")


def collective_seconds(kind: str, n_bytes: float, n_devices: int,
                       link: LinkModel) -> float:
    """Ring-algorithm time for one collective moving ``n_bytes`` of
    payload (the full logical array for gather/scatter/reduce, the
    per-hop message for ppermute)."""
    hops = ici_hops(kind, n_devices)
    if hops == 0:
        return 0.0
    if kind in ("all_gather", "reduce_scatter"):
        wire = n_bytes * (n_devices - 1) / n_devices
    elif kind == "all_reduce":
        wire = 2 * n_bytes * (n_devices - 1) / n_devices
    else:
        wire = n_bytes
    return hops * link.latency_s + wire / link.bytes_per_s


@dataclass
class StepAttribution:
    """One schedule's priced step: where the seconds went.
    ``collective_s`` totals every collective the schedule issues;
    ``exposed_collective_s`` is what overlap leaves on the critical path.
    """

    step_s: float
    compute_s: float
    collective_s: dict[str, float] = field(default_factory=dict)
    exposed_collective_s: float = 0.0
    ici_hops: int = 0
    bubble_fraction: float = 0.0
    source: str = "cost-model"

    def as_dict(self) -> dict:
        return {
            "step_time_s": round(self.step_s, 6),
            "compute_s": round(self.compute_s, 6),
            "collective_seconds": {k: round(v, 6)
                                   for k, v in self.collective_s.items()},
            "exposed_collective_s": round(self.exposed_collective_s, 6),
            "ici_hops": self.ici_hops,
            "bubble_fraction": round(self.bubble_fraction, 4),
            "attribution_source": self.source,
        }


def attribute(measured_step_s: float, model: StepAttribution
              ) -> StepAttribution:
    """Scale a cost-model attribution onto a measured step: the model
    supplies the shares, the measurement the total."""
    if model.step_s <= 0:
        raise ValueError("model step time must be positive")
    s = measured_step_s / model.step_s
    return StepAttribution(
        step_s=measured_step_s, compute_s=model.compute_s * s,
        collective_s={k: v * s for k, v in model.collective_s.items()},
        exposed_collective_s=model.exposed_collective_s * s,
        ici_hops=model.ici_hops, bubble_fraction=model.bubble_fraction,
        source="cost-model")


def fsdp_step_model(*, n_layers: int, layer_param_bytes: float,
                    fwd_flops_per_layer: float, n_fsdp: int,
                    peak_flops: float, link: LinkModel,
                    overlap: bool = True) -> StepAttribution:
    """Chunked ZeRO-3 step time (fwd + bwd) per device. Per layer the
    schedule gathers the chunk (fwd), re-gathers it under remat and
    reduce-scatters the gradient (bwd); backward costs 2× the forward's
    FLOPs. Overlapped, each direction exposes one gather and then runs
    ``max(compute, comm)`` a layer; otherwise it pays the sum."""
    if n_layers < 1:
        raise ValueError("need at least one layer")
    g = collective_seconds("all_gather", layer_param_bytes, n_fsdp, link)
    rs = collective_seconds("reduce_scatter", layer_param_bytes, n_fsdp,
                            link)
    c_f = fwd_flops_per_layer / peak_flops
    c_b = 2 * c_f
    fwd_comm, bwd_comm = g, g + rs
    compute = n_layers * (c_f + c_b)
    if overlap:
        step = (fwd_comm + (n_layers - 1) * max(c_f, fwd_comm) + c_f
                + bwd_comm + (n_layers - 1) * max(c_b, bwd_comm) + c_b)
    else:
        step = n_layers * (c_f + fwd_comm) + n_layers * (c_b + bwd_comm)
    return StepAttribution(
        step_s=step, compute_s=compute,
        collective_s={"all_gather": 2 * n_layers * g,
                      "reduce_scatter": n_layers * rs},
        exposed_collective_s=max(step - compute, 0.0),
        ici_hops=n_layers * (2 * ici_hops("all_gather", n_fsdp)
                             + ici_hops("reduce_scatter", n_fsdp)))



def fsdp_overlap_win(*, n_layers: int, layer_param_bytes: float,
                     fwd_flops_per_layer: float, n_fsdp: int,
                     peak_flops: float, link: LinkModel) -> dict:
    """The two ZeRO-3 schedules priced side by side: each one's
    ``as_dict()`` and ``speedup``, eager over overlapped."""
    kw = dict(n_layers=n_layers, layer_param_bytes=layer_param_bytes,
              fwd_flops_per_layer=fwd_flops_per_layer, n_fsdp=n_fsdp,
              peak_flops=peak_flops, link=link)
    eager = fsdp_step_model(overlap=False, **kw)
    overlapped = fsdp_step_model(overlap=True, **kw)
    return {"eager": eager.as_dict(), "overlapped": overlapped.as_dict(),
            "speedup": round(eager.step_s / overlapped.step_s, 3)}


def gpipe_step_model(*, pp: int, microbatches: int,
                     stage_fwd_flops_per_micro: float, hop_bytes: float,
                     peak_flops: float, link: LinkModel,
                     overhead_s: float = 0.0) -> StepAttribution:
    """GPipe fill/drain step (fwd + bwd): ``M + pp − 1`` ticks, each one
    stage's compute (forward 1× + backward 2×) plus an activation hop each
    way. ``bubble_fraction`` is measured as the bench measures it, from
    the simulated step times at M and 2M through
    ``pipeline.bubble_from_timings``, so it can be held against the
    analytic ``(pp − 1)/(M + pp − 1)``."""
    c = 3 * stage_fwd_flops_per_micro / peak_flops
    hop = collective_seconds("ppermute", hop_bytes, pp, link)
    tick = c + 2 * hop

    def step_s(m: int) -> float:
        return overhead_s + (m + pp - 1) * tick

    t = step_s(microbatches)
    measured = (bubble_from_timings(t, microbatches,
                                    step_s(2 * microbatches),
                                    2 * microbatches, pp)
                if pp > 1 else 0.0)
    ticks = microbatches + pp - 1
    return StepAttribution(
        step_s=t, compute_s=ticks * c,
        collective_s={"ppermute": ticks * 2 * hop},
        exposed_collective_s=ticks * 2 * hop,
        ici_hops=ticks * 2 * ici_hops("ppermute", pp),
        bubble_fraction=measured)


def ring_attention_model(*, seq_len: int, sp: int, batch: int, heads: int,
                         head_dim: int, peak_flops: float, link: LinkModel,
                         bytes_per_elem: int = 4) -> StepAttribution:
    """One ring-attention forward: ``sp`` hops, each a Q block × K/V block
    (4·B·(T/sp)²·H·D FLOPs) overlapped with the K/V hop for the next, so
    each hop's critical path is ``max(block, hop)`` with one hop
    exposed."""
    s_local = seq_len // sp
    block = 4 * batch * s_local * s_local * heads * head_dim / peak_flops
    kv_bytes = 2 * batch * s_local * heads * head_dim * bytes_per_elem
    hop = collective_seconds("ppermute", kv_bytes, sp, link)
    compute = sp * block
    step = compute if sp == 1 else hop + sp * max(block, hop)
    return StepAttribution(
        step_s=step, compute_s=compute,
        collective_s={"ppermute": sp * hop},
        exposed_collective_s=step - compute if sp > 1 else 0.0,
        ici_hops=sp * ici_hops("ppermute", sp) if sp > 1 else 0)


# The reference's overlap scale: a 32-layer d=4096 decoder at seq 8192, one
# sequence per device; per-layer matmul params 12·d², forward FLOPs
# 2·params·tokens, f32 chunks. The peak is the card's (``peaks_for``).
REFERENCE_LLM = {
    "d_model": 4096,
    "n_layers": 32,
    "seq_len": 8192,
    "layer_params": 12 * 4096 * 4096,
}


def reference_overlap_win(n_fsdp: int, *, peak_flops: float,
                          link: LinkModel) -> dict:
    """``fsdp_overlap_win`` at ``REFERENCE_LLM``'s scale over ``n_fsdp``
    devices of ``peak_flops`` joined by ``link``."""
    layer_params = REFERENCE_LLM["layer_params"]
    return fsdp_overlap_win(
        n_layers=REFERENCE_LLM["n_layers"],
        layer_param_bytes=4 * layer_params,
        fwd_flops_per_layer=2 * layer_params * REFERENCE_LLM["seq_len"],
        n_fsdp=n_fsdp, peak_flops=peak_flops, link=link)

# substrings of NCCL's kernel names (lower case, no underscores) → keys
_NCCL_KERNELS = (("allgather", "all_gather"),
                 ("reducescatter", "reduce_scatter"),
                 ("sendrecv", "ppermute"), ("allreduce", "all_reduce"))


def profiled_collective_seconds(step_fn, *args) -> dict[str, float] | None:
    """Run ``step_fn(*args)`` once under ``torch.profiler`` and sum the
    device time of NCCL's kernels per collective. None when the arguments
    hold no CUDA tensor (the CPU has no device time to read) or the run
    launched no NCCL kernel; a profiler failure on the card raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def on_cuda(x) -> bool:
        if isinstance(x, dict):
            return any(on_cuda(v) for v in x.values())
        return isinstance(x, torch.Tensor) and x.is_cuda

    if not any(on_cuda(a) for a in args):
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(*args)
        torch.cuda.synchronize()
    totals = {key: 0.0 for _, key in _NCCL_KERNELS}
    for evt in prof.key_averages():
        name = evt.key.lower().replace("_", "")
        if "nccl" not in name:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        for needle, key in _NCCL_KERNELS:
            if needle in name:
                totals[key] += us / 1e6
                break
    return totals if any(totals.values()) else None


def config_record(*, config: str, n_devices: int, mesh: dict | None = None,
                  step_time_s: float | None = None, mfu: float | None = None,
                  attribution: StepAttribution | dict | None = None,
                  compile_counts: dict | None = None, ok: bool = True,
                  error: str | None = None, **extra) -> dict:
    """One benchmark config's structured record. Only measured fields
    appear; ``mesh`` keeps the axes above 1, ``attribution`` splices in
    ``StepAttribution.as_dict()`` (or a dict of that form), ``error`` sets
    ``ok`` false, and ``extra`` keys are appended as given."""
    rec: dict = {"config": config, "n_devices": int(n_devices),
                 "ok": bool(ok)}
    if mesh:
        rec["mesh"] = {k: int(v) for k, v in mesh.items() if int(v) > 1}
    if attribution is not None:
        rec.update(attribution.as_dict()
                   if isinstance(attribution, StepAttribution)
                   else dict(attribution))
    if step_time_s is not None:
        rec["step_time_s"] = round(float(step_time_s), 6)
    if mfu is not None:
        rec["mfu"] = round(float(mfu), 6)
    if compile_counts is not None:
        rec["compile_counts"] = compile_counts
    if error is not None:
        rec["ok"] = False
        rec["error"] = str(error)
    rec.update(extra)
    return rec
