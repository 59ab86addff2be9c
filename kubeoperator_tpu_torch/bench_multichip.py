"""Multi-device scaling bench of the port: the counterpart of
``scripts/bench_multichip.py``, with its flags and its artifact schema
(``costmodel.config_record``).

* ``--cost-model`` prices the reference-scale schedules for one card,
  named by ``--card`` (default: the visible card's name; with neither, it
  raises): the chunked ZeRO-3 overlap win (``reference_overlap_win``) at
  each device count, GPipe at n >= 2 with its bubble measured from two
  simulated step times beside the analytic ``(pp − 1)/(M + pp − 1)``,
  and the ring-attention curve at T 8k, 16k and 32k. The peak is the
  card's (``train.peaks_for``), the link its NVLink (``link_for``).
* measured (default) runs the reference's config matrix once per world
  size, each world one ``launch.spawn`` of its ranks: NCCL over the
  visible cards, or gloo ranks with ``--device cpu``; a world larger than
  the card count raises. The configs are resnet, transformer and vit (and
  multislice and moe from n 4) through the trainers' ``measure()``, the
  fsdp overlap-vs-eager A/B and the GPipe two-point bubble from n 2, and
  ring attention at T 8k (16k and 32k with ``--full``). Each runs under
  the compile-count guard; one that raises becomes an ``error`` record.
  Collective time comes from the NCCL kernels under the profiler on the
  card, else the cost model's shares scaled onto the measured step
  (priced for ``--card`` where one is named). The CPU has no published
  peak, so there MFU is None and the trainers, whose ``measure()`` needs
  the card, are timed by ``timed_steps``.

    python -m kubeoperator_tpu_torch.bench_multichip --cost-model \\
        --card "NVIDIA H100 80GB HBM3"
    python -m kubeoperator_tpu_torch.bench_multichip --devices 1,2 \\
        --device cpu --out artifact.json
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

SEQ_POINTS = (8192, 16384, 32768)
#: ``_measure_ring``'s default shape, the reference's (B 1, H 4, D 16, f32)
RING_SHAPE = {"batch": 1, "heads": 4, "head_dim": 16, "dtype": "float32"}


def card_name(card: str | None = None) -> str:
    """``card``, else the visible card's name; raises with neither."""
    if card:
        return card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device and no --card: name the card to "
                           "price (e.g. --card 'NVIDIA H100 80GB HBM3')")
    return torch.cuda.get_device_name(0)


def _pricing(card: str | None) -> tuple[float, object] | None:
    """(peak FLOP/s, link) of ``card``, None when no card is named."""
    if card is None:
        return None
    from kubeoperator_tpu_torch.workloads import costmodel as cm
    from kubeoperator_tpu_torch.workloads.train import peaks_for

    return peaks_for(card)[0], cm.link_for(card)


# ---------------------------------------------------------------------------
# cost-model mode
# ---------------------------------------------------------------------------

def cost_model_records(device_counts: list[int], card: str) -> dict:
    from kubeoperator_tpu_torch.workloads import costmodel as cm
    from kubeoperator_tpu_torch.workloads.pipeline import bubble_fraction

    ref = cm.REFERENCE_LLM
    peak, link = _pricing(card)
    records: list[dict] = []
    guards: dict = {}

    for n in device_counts:
        win = cm.reference_overlap_win(n, peak_flops=peak, link=link)
        records.append(cm.config_record(
            config="fsdp-overlap", n_devices=n, mesh={"fsdp": n},
            attribution=win["overlapped"], speedup=win["speedup"],
            eager_step_time_s=win["eager"]["step_time_s"]))
        if n == max(device_counts):
            guards["fsdp_overlap_speedup"] = win["speedup"]

    microbatches = 8
    for n in device_counts:
        if n < 2:
            continue
        pp = min(4, n)
        # the reference decoder over pp stages, the sequence over M micros
        stage_flops = (ref["n_layers"] / pp) * 2 * ref["layer_params"] \
            * (ref["seq_len"] / microbatches)
        hop_bytes = 2 * (ref["seq_len"] / microbatches) * ref["d_model"]
        att = cm.gpipe_step_model(
            pp=pp, microbatches=microbatches,
            stage_fwd_flops_per_micro=stage_flops, hop_bytes=hop_bytes,
            peak_flops=peak, link=link)
        analytic = bubble_fraction(pp, microbatches)
        records.append(cm.config_record(
            config="gpipe", n_devices=n, mesh={"pp": pp}, attribution=att,
            microbatches=microbatches,
            analytic_bubble_fraction=round(analytic, 4)))
        if n == max(device_counts):
            guards["bubble_measured"] = att.bubble_fraction
            guards["bubble_analytic"] = round(analytic, 4)

    heads = ref["d_model"] // 128
    for n in device_counts:
        for seq in SEQ_POINTS:
            att = cm.ring_attention_model(
                seq_len=seq, sp=n, batch=1, heads=heads, head_dim=128,
                peak_flops=peak, link=link, bytes_per_elem=2)
            records.append(cm.config_record(
                config=f"ring-attention-{seq // 1024}k", n_devices=n,
                mesh={"sp": n}, attribution=att, seq_len=seq))

    return {"records": records, "guards": guards}


# ---------------------------------------------------------------------------
# measured mode: the configs one rank runs
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step: Callable, *args, steps: int, warmup: int,
           device: torch.device):
    """Mean post-warmup seconds a call, each call fenced; (seconds, last
    output)."""
    times: list[float] = []
    out = None
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        out = step(*args)
        _sync(device)
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return sum(times) / len(times), out


def _mlp(d: int, vocab: int, n_stages: int, seed: int,
         device: torch.device):
    """The fsdp and pipeline jobs' MLP LM (``jobs.mlp_lm``) at width
    ``d``: (embed, stages, head, ``pipeline.MLP_FNS``), the same weights on
    every rank."""
    from types import SimpleNamespace

    from kubeoperator_tpu_torch.train import jobs

    return jobs.mlp_lm(SimpleNamespace(d_model=d, vocab=vocab, seed=seed),
                       n_stages, device)


def _measure_fsdp_ab(n: int, steps: int, warmup: int, device: torch.device,
                     card: str | None) -> list[dict]:
    """Chunked ZeRO-3 with and without the prefetch overlap, on the same
    params and data: one SGD step a call."""
    from kubeoperator_tpu_torch.analysis import compile_count_guard
    from kubeoperator_tpu_torch.train.jobs import sgd_step, synthetic_ids
    from kubeoperator_tpu_torch.workloads import costmodel as cm
    from kubeoperator_tpu_torch.workloads.sharding import (
        MeshSpec, build_mesh, fsdp_overlapped_loss_fn,
        fsdp_overlapped_shardings, pack_stages, shard_tensor,
    )
    from kubeoperator_tpu_torch.workloads.train import peak_flops_per_chip

    d, vocab, layers, lr = 64, 128, 4, 0.1
    spec = MeshSpec(fsdp=n)
    mesh = build_mesh(spec, device.type)
    embed, stages, head, fns = _mlp(d, vocab, layers, 0, device)
    stacked, unpack = pack_stages(stages, multiple=n)
    shd = fsdp_overlapped_shardings(mesh)
    batch = 8 * n
    x, y = (synthetic_ids(batch, vocab, seed, device) for seed in (1, 2))
    pricing = _pricing(card)
    model_flops = 3 * (layers * 4 * batch * d * d + 2 * batch * d * vocab)

    out: list[dict] = []
    step_by_mode: dict[str, float] = {}
    for name, prefetch in (("fsdp-overlap", True), ("fsdp-eager", False)):
        # each schedule from the same weights: its own copies to update
        params = {"embed": embed.clone().requires_grad_(),
                  "stages": shard_tensor(stacked, shd["stages"],
                                         mesh).clone().requires_grad_(),
                  "head": head.clone().requires_grad_()}
        loss_fn = fsdp_overlapped_loss_fn(mesh, unpack=unpack,
                                          prefetch=prefetch, **fns)
        with compile_count_guard() as guard:
            step_s, loss = _timed(sgd_step, loss_fn, params, x, y, lr,
                                  steps=steps, warmup=warmup, device=device)
        step_by_mode[name] = step_s
        att, mfu = None, None
        if pricing is not None:
            model = cm.fsdp_step_model(
                n_layers=layers, layer_param_bytes=4.0 * stacked.shape[1],
                fwd_flops_per_layer=4.0 * (batch // n) * d * d, n_fsdp=n,
                peak_flops=pricing[0], link=pricing[1], overlap=prefetch)
            att = cm.attribute(step_s, model)
        prof = cm.profiled_collective_seconds(loss_fn, params, x, y)
        if prof is not None and att is not None:
            att.collective_s, att.source = prof, "profiler"
        if device.type == "cuda":
            mfu = model_flops / (peak_flops_per_chip(device) * n * step_s)
        out.append(cm.config_record(
            config=name, n_devices=n, mesh=dict(spec.sizes()),
            attribution=att, step_time_s=None if att else step_s, mfu=mfu,
            compile_counts=guard.by_function(),
            loss=round(float(loss), 4)))
    out[0]["measured_speedup"] = round(
        step_by_mode["fsdp-eager"] / step_by_mode["fsdp-overlap"], 3)
    return out


def _measure_gpipe(n: int, steps: int, warmup: int,
                   device: torch.device) -> dict:
    """GPipe's forward and backward at M and 2M microbatches → the
    two-point measured bubble beside the analytic one."""
    from kubeoperator_tpu_torch.analysis import compile_count_guard
    from kubeoperator_tpu_torch.train.jobs import synthetic_ids
    from kubeoperator_tpu_torch.workloads import costmodel as cm
    from kubeoperator_tpu_torch.workloads import pipeline as pipe
    from kubeoperator_tpu_torch.workloads.sharding import (
        MeshSpec, axis_index, build_mesh,
    )

    pp = min(4, n)
    spec = MeshSpec(dp=n // pp, pp=pp)
    mesh = build_mesh(spec, device.type)
    d, vocab, m = 32, 64, 4
    embed, stages, head, fns = _mlp(d, vocab, pp, 3, device)
    params = {"embed": embed.requires_grad_(),
              "stages": {k: v.requires_grad_() for k, v in
                         stages[axis_index(mesh, "pp")].items()},
              "head": head.requires_grad_()}
    times = {}
    with compile_count_guard() as guard:
        for micros in (m, 2 * m):
            loss_fn = pipe.gpipe_loss_fn(mesh, n_micro=micros, **fns)
            batch = micros * max(1, spec.dp)
            x, y = (synthetic_ids(batch, vocab, seed, device)
                    for seed in (1, 2))
            # forward and backward (the gradients accumulate; no update)
            times[micros], _ = _timed(
                lambda x, y: loss_fn(params, x, y).backward(), x, y,
                steps=steps, warmup=warmup, device=device)
    measured = pipe.bubble_from_timings(times[m], m, times[2 * m], 2 * m, pp)
    return cm.config_record(
        config="gpipe", n_devices=n, mesh=dict(spec.sizes()),
        step_time_s=times[m], microbatches=m,
        bubble_fraction=round(measured, 4),
        analytic_bubble_fraction=round(pipe.bubble_fraction(pp, m), 4),
        compile_counts=guard.by_function())


def _measure_ring(n: int, seq: int, steps: int, warmup: int,
                  device: torch.device, card: str | None = None,
                  batch: int = 1, heads: int = 4, head_dim: int = 16,
                  dtype: str = "float32") -> dict:
    """Ring attention's forward over sp ``n`` at [batch, seq, heads,
    head_dim] in ``dtype``, beside ``ring_attention_model``'s price of the
    same work for ``card`` (its ``priced_compute_s``)."""
    from kubeoperator_tpu_torch.analysis import compile_count_guard
    from kubeoperator_tpu_torch.workloads import costmodel as cm
    from kubeoperator_tpu_torch.workloads.ring_attention import (
        sharded_ring_attention,
    )
    from kubeoperator_tpu_torch.workloads.sharding import (
        MeshSpec, build_mesh, shard_batch,
    )

    mesh = build_mesh(MeshSpec(sp=n), device.type)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(7)
    q, k, v = (shard_batch(mesh, torch.randn(
        batch, seq, heads, head_dim, generator=gen, device=device,
        dtype=dt), seq_dim=1) for _ in range(3))

    def fn(q, k, v):
        with torch.no_grad():
            return sharded_ring_attention(mesh, q, k, v)

    with compile_count_guard() as guard:
        step_s, _ = _timed(fn, q, k, v, steps=steps, warmup=warmup,
                           device=device)
    extra: dict = {}
    att = None
    pricing = _pricing(card)
    if pricing is not None:
        model = cm.ring_attention_model(
            seq_len=seq, sp=n, batch=batch, heads=heads, head_dim=head_dim,
            peak_flops=pricing[0], link=pricing[1],
            bytes_per_elem=dt.itemsize)
        att = cm.attribute(step_s, model) if n > 1 else None
        extra = {"priced_compute_s": model.compute_s,
                 "priced_step_s": model.step_s, "priced_card": card}
    return cm.config_record(
        config=f"ring-attention-{seq // 1024}k", n_devices=n,
        mesh={"sp": n}, attribution=att, step_time_s=step_s, seq_len=seq,
        compile_counts=guard.by_function(),
        shape={"batch": batch, "heads": heads, "head_dim": head_dim,
               "dtype": dtype}, **extra)


def _trainer_point(name: str, n: int, make: Callable, inputs: Callable,
                   measure_kw: dict, steps: int, warmup: int) -> dict:
    """One trainer config: on the card its own ``measure()`` (step ms,
    MFU); on the CPU, which has no peak, ``timed_steps`` of its
    ``train_step`` on the same inputs and MFU None."""
    from kubeoperator_tpu_torch.analysis import compile_count_guard
    from kubeoperator_tpu_torch.workloads import costmodel as cm
    from kubeoperator_tpu_torch.workloads.train import (
        step_stats, timed_steps,
    )

    with compile_count_guard() as guard:
        tr = make()
        if tr.device.type == "cuda":
            res = tr.measure(steps=steps, warmup=warmup, repeats=1,
                             **measure_kw)
            step_s, mfu = res["step_time_ms"] / 1e3, res["mfu"]
        else:
            _, times = timed_steps(tr.train_step, tr.init_state(),
                                   inputs(tr), steps, warmup, repeats=1)
            step_s, mfu = step_stats(times)["median_ms"] / 1e3, None
    return cm.config_record(
        config=name, n_devices=n, mesh=dict(tr.spec.sizes()),
        step_time_s=step_s, mfu=mfu, compile_counts=guard.by_function())


_LM = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq_len=64)


def matrix(n: int, steps: int, warmup: int, full: bool,
           device: torch.device, card: str | None = None,
           ring: dict | None = None) -> list[tuple[str, Callable]]:
    """The reference's config matrix at world ``n``, in its order: (name,
    thunk) pairs, each thunk returning a record or a list of them.
    ``ring`` overrides ``RING_SHAPE``; the ring runs at T 8k, or at all of
    ``SEQ_POINTS`` when ``full``."""
    from kubeoperator_tpu_torch.workloads.sharding import (
        MeshSpec, with_virtual_slices,
    )
    from kubeoperator_tpu_torch.workloads.transformer import (
        TransformerConfig,
    )

    dev = device

    def resnet() -> dict:
        from kubeoperator_tpu_torch.workloads.train import (
            TrainConfig, Trainer,
        )

        spec = MeshSpec(dp=n) if n > 1 else MeshSpec()
        return _trainer_point(
            "resnet", n,
            lambda: Trainer(TrainConfig(batch_size=2 * n, image_size=32,
                                        stem="space_to_depth"), spec,
                            device=dev, workload="resnet"),
            lambda tr: tr.synthetic_batch(), {}, steps, warmup)

    def transformer() -> dict:
        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        if n >= 4:
            spec = MeshSpec(dp=n // 4, tp=2, sp=2)
        elif n == 2:
            spec = MeshSpec(dp=1, sp=2)
        else:
            spec = MeshSpec(dp=1)
        batch = 2 * max(1, spec.dp)
        return _trainer_point(
            "transformer", n,
            lambda: LMTrainer(TransformerConfig(**_LM), spec, device=dev,
                              workload="transformer"),
            lambda tr: (tr.synthetic_batch(batch, 64),),
            {"batch": batch, "seq_len": 64}, steps, warmup)

    def vit() -> dict:
        from kubeoperator_tpu_torch.workloads.vit import (
            ViTConfig, ViTTrainer,
        )

        spec = MeshSpec(dp=min(2, n), fsdp=n // min(2, n)) \
            if n > 1 else MeshSpec()
        cfg = ViTConfig(num_classes=16, image_size=32, patch=8,
                        encoder=TransformerConfig(d_model=64, n_heads=4,
                                                  n_layers=2, d_ff=128,
                                                  causal=False,
                                                  max_seq_len=16))
        return _trainer_point(
            "vit", n, lambda: ViTTrainer(cfg, spec, device=dev,
                                         workload="vit"),
            lambda tr: tr.synthetic_batch(2 * n), {"batch": 2 * n},
            steps, warmup)

    def multislice() -> dict:
        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        inner = n // 2
        tp = 2 if inner >= 2 else 1
        spec = MeshSpec(dp=2, tp=tp, sp=inner // tp)
        slices = with_virtual_slices(n, 2)
        rec = _trainer_point(
            "multislice", n,
            lambda: LMTrainer(TransformerConfig(**_LM), spec, device=dev,
                              slices=slices, workload="multislice"),
            lambda tr: (tr.synthetic_batch(2 * spec.dp, 64),),
            {"batch": 2 * spec.dp, "seq_len": 64}, steps, warmup)
        rec["slices"] = 2
        return rec

    def moe() -> dict:
        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        spec = MeshSpec(dp=n // 4, ep=2, tp=2)
        cfg = TransformerConfig(**{**_LM, "max_seq_len": 32},
                                moe_experts=4)
        batch = 2 * max(1, spec.dp)
        return _trainer_point(
            "moe", n, lambda: LMTrainer(cfg, spec, device=dev,
                                        workload="moe"),
            lambda tr: (tr.synthetic_batch(batch, 32),),
            {"batch": batch, "seq_len": 32}, steps, warmup)

    configs = [("resnet", resnet), ("transformer", transformer),
               ("vit", vit)]
    if n >= 4:
        configs += [("multislice", multislice), ("moe", moe)]
    if n >= 2:
        configs += [("fsdp-overlap",
                     lambda: _measure_fsdp_ab(n, steps, warmup, dev, card)),
                    ("gpipe", lambda: _measure_gpipe(n, steps, warmup, dev))]
    shape = {**RING_SHAPE, **(ring or {})}
    for seq in SEQ_POINTS if full else SEQ_POINTS[:1]:
        configs.append((f"ring-attention-{seq // 1024}k",
                        lambda s=seq: _measure_ring(
                            n, s, max(2, steps // 2), warmup, dev, card,
                            **shape)))
    return configs


def run_config(name: str, fn: Callable, n: int) -> list[dict]:
    """One config's records; an exception becomes its ``error`` record
    (the reference's per-config isolation). Rank 0 reports each to
    stderr."""
    from kubeoperator_tpu_torch.train.launch import group_info
    from kubeoperator_tpu_torch.workloads import costmodel as cm

    lead = group_info()["process_id"] == 0
    try:
        recs = fn()
    except Exception as e:  # noqa: BLE001 — per-config isolation
        if lead:
            print(f"# {name}@{n}: {type(e).__name__}: {e}", file=sys.stderr)
        return [cm.config_record(config=name, n_devices=n,
                                 error=f"{type(e).__name__}: {e}")]
    recs = recs if isinstance(recs, list) else [recs]
    for r in recs if lead else ():
        print(f"# {r['config']}@{n}: step={r.get('step_time_s', '-')}s "
              f"mfu={r.get('mfu', '-')}", file=sys.stderr)
    return recs


def child_records(n: int, steps: int, warmup: int, full: bool,
                  device: torch.device, card: str | None = None,
                  ring: dict | None = None) -> list[dict]:
    """Every config of the matrix at world ``n`` (the calling rank's share
    of it), then each measured step into ``ko_train_*``."""
    from kubeoperator_tpu_torch.telemetry.metrics import record_train_step

    records: list[dict] = []
    for name, fn in matrix(n, steps, warmup, full, device, card, ring):
        records += run_config(name, fn, n)
    for r in records:
        if r.get("ok") and r.get("step_time_s"):
            record_train_step(r["config"], r["step_time_s"], r.get("mfu"),
                              r.get("collective_seconds"))
    return records


def _rank_main(rank: int, world: int, out: str, steps: int, warmup: int,
               full: bool, device: str, card: str | None,
               ring: dict | None) -> None:
    """One rank of a measured world: the matrix, rank 0's records to
    ``out``."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    records = child_records(world, steps, warmup, full, dev, card, ring)
    if rank == 0:
        Path(out).write_text(json.dumps(records))


def run_measured(device_counts: list[int], steps: int, warmup: int,
                 full: bool, device: str | None = None,
                 card: str | None = None,
                 ring: dict | None = None) -> list[dict]:
    """The matrix at each world size, one spawn of its ranks each: NCCL
    over the visible cards (``device`` None), gloo for ``device`` "cpu".
    Raises, before running anything, for a world larger than the card
    count."""
    from kubeoperator_tpu_torch.train import launch
    from kubeoperator_tpu_torch.workloads.costmodel import config_record
    from kubeoperator_tpu_torch.workloads.train import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        big = [n for n in device_counts if n > cards]
        if big:
            raise ValueError(f"worlds {big} need that many cards; {cards} "
                             f"visible (one rank a card)")
    records: list[dict] = []
    with tempfile.TemporaryDirectory(prefix="ko-multichip-") as work:
        for n in device_counts:
            print(f"# measuring at {n} device(s) ...", file=sys.stderr)
            out = Path(work, f"world{n}.json")
            try:
                launch.spawn(_rank_main, n, (str(out), steps, warmup, full,
                                             dev.type, card, ring),
                             backend=launch.backend_for(dev.type),
                             store=str(Path(work, f"store{n}").resolve()),
                             timeout_s=600.0, deadline_s=1800.0)
                records += json.loads(out.read_text())
            except Exception as e:          # noqa: BLE001 — the world failed
                records.append(config_record(
                    config="matrix", n_devices=n,
                    error=f"{type(e).__name__}: {e}"))
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeoperator_tpu_torch.bench_multichip",
        description=__doc__.split("\n")[0])
    ap.add_argument("--cost-model", action="store_true",
                    help="price the reference schedules for --card (no "
                         "device needed)")
    ap.add_argument("--card", default=None,
                    help="the card to price, by its device name (default: "
                         "the visible card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device counts (default 1,2,4,8; "
                         "measured on cards: the powers of two up to the "
                         "visible count)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU; default the card")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="measured mode: ring attention at 16k and 32k too")
    ap.add_argument("--out", default=None, help="write the artifact here")
    args = ap.parse_args(argv)

    if args.devices:
        device_counts = sorted({int(x) for x in args.devices.split(",")})
    elif args.cost_model or args.device == "cpu":
        device_counts = [1, 2, 4, 8]
    else:
        cards = torch.cuda.device_count()
        device_counts = [n for n in (1, 2, 4, 8) if n <= max(cards, 1)]
    artifact: dict = {"bench": "multichip",
                      "mode": "cost-model" if args.cost_model else "measured",
                      "devices": device_counts}
    if args.cost_model:
        card = card_name(args.card)
        priced = cost_model_records(device_counts, card)
        artifact.update(card=card, configs=priced["records"],
                        guards=priced["guards"])
    else:
        card = (args.card if args.device == "cpu"
                else card_name(args.card) if torch.cuda.is_available()
                else None)
        artifact.update(card=card, device=args.device or "cuda",
                        configs=run_measured(device_counts, args.steps,
                                             args.warmup, args.full,
                                             args.device, card))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
        print(f"# wrote {args.out} ({len(artifact['configs'])} configs)",
              file=sys.stderr)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
