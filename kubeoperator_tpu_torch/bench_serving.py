"""The serving bench's real-engine arms on the port's ``SlotPoolEngine``:
the counterparts of ``bench_spec_real``, ``bench_scaling_real`` and
``bench_bringup`` of ``scripts/bench_serving.py``. (Its cost-model arms
run the scenario package's fake engines, not a model, and are not here.)

* ``bench_spec_real`` — the speculative engine against its plain twin,
  greedy: the rows, ``bit_identical``, and the drafted and accepted
  counts with their ratio.
* ``bench_scaling_real`` — the pool over each (dp, tp) of
  ``SCALING_SHAPES``, each shape one spawn of its world (NCCL over the
  visible cards, gloo ranks on the CPU); a shape larger than the world is
  marked ``skipped``. New tokens a second over three fenced segments.
* ``bench_bringup`` — cold and warm construction through the port's
  ``aot.CompileCache``, then the reference's autoscale replay (detect
  1 s, schedule 2 s, overload 4 rps, drain 8 rps) with each arm's time.
  The pool launches no port kernel, so both arms build nothing (source
  "none", 0 builds): the cache consults no library for it.

Each takes ``(cfg, model)``: the reference's tiny config and a model
seeded from it by default, on the card unless ``device`` is "cpu".

    python -m kubeoperator_tpu_torch.bench_serving --spec-real
    python -m kubeoperator_tpu_torch.bench_serving --scaling-real \\
        --device cpu --world 2
    python -m kubeoperator_tpu_torch.bench_serving --bringup
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

from kubeoperator_tpu_torch.workloads.transformer import (
    Transformer, TransformerConfig,
)

SCALING_SHAPES = ((1, 1), (2, 1), (2, 2), (4, 2))
SPEC_PROMPTS = ([1, 2, 3, 4, 5, 6], [7, 8, 9, 10], [3, 1, 4, 1, 5, 9, 2, 6])
# the reference's autoscale timeline: one evaluation period to detect the
# breach, the pod's scheduling, then the backlog that accrued at the
# overload rate drained at the spare rate
DETECT_S, SCHEDULE_S, OVERLOAD_RPS, DRAIN_RPS = 1.0, 2.0, 4.0, 8.0


def spec_config() -> TransformerConfig:
    """The reference's spec and bring-up config: f32, dense attention."""
    return TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_seq_len=24,
                             dtype=torch.float32, remat=False,
                             attention="dense")


def scaling_config() -> TransformerConfig:
    """The reference's scaling config (its default dtype)."""
    return TransformerConfig(vocab_size=128, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_seq_len=64)


def seeded_model(cfg: TransformerConfig, device=None,
                 seed: int = 0) -> Transformer:
    from kubeoperator_tpu_torch.workloads.train import resolve_device

    with torch.device(resolve_device(device)):
        return Transformer(cfg).reset_parameters(seed).eval()


def _setup(cfg, model, default_cfg, device):
    cfg = cfg or default_cfg()
    model = model if model is not None else seeded_model(cfg, device)
    return cfg, model, model.embedding.device


def _device_info(dev: torch.device) -> dict:
    return {"device_kind": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spec_drain(eng, prompts, max_tokens: int) -> list[list[int]]:
    """Admit ``prompts`` greedy, one a slot, run segments until every row
    is done (draining the speculative counters after each), and return
    each row's prompt and tokens."""
    eng.admit([(s, p, max_tokens, 0.0, 0) for s, p in enumerate(prompts)])
    for _ in range(16 * max_tokens):
        _, pos = eng.poll()
        if all(pos[s] >= len(p) + max_tokens - 1
               for s, p in enumerate(prompts)):
            break
        eng.run_segment()
        if eng.spec_k:
            eng.poll_spec()
    buf, _ = eng.poll()
    return [buf[s, :len(p) + max_tokens].tolist()
            for s, p in enumerate(prompts)]


def bench_spec_real(cfg: TransformerConfig | None = None, model=None,
                    spec_k: int = 4, draft_layers: int = 1,
                    max_tokens: int = 8, device=None) -> dict:
    """The speculative ``SlotPoolEngine`` (``spec_k``, the first
    ``draft_layers`` as the draft) against its plain twin on the same
    model, greedy: ``bit_identical`` rows and the acceptance counters.
    The speculative pool holds twice the plain one's pages (less its
    extra trash page): each slot mirrors its pages for the draft's KV."""
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine

    cfg, model, dev = _setup(cfg, model, spec_config, device)
    plain = SlotPoolEngine(cfg, model, slots=4, segment=4, device=dev)
    base = spec_drain(plain, SPEC_PROMPTS, max_tokens)
    spec_eng = SlotPoolEngine(cfg, model, slots=4, segment=4,
                              pages=2 * plain.pages - 1, spec_k=spec_k,
                              draft_layers=draft_layers, device=dev)
    spec = spec_drain(spec_eng, SPEC_PROMPTS, max_tokens)
    drafted = int(spec_eng.spec_draft_tokens)
    accepted = int(spec_eng.spec_accepted_tokens)
    return {**_device_info(dev), "spec_k": spec_k,
            "draft_layers": draft_layers, "bit_identical": spec == base,
            "drafted": drafted, "accepted": accepted,
            "acceptance": round(accepted / max(drafted, 1), 3),
            "rows": spec, "plain_rows": base}


def _scaling_point(cfg, model, dp: int, tp: int, dev: torch.device) -> dict:
    """One (dp, tp) shape in this process's world: ``4·dp`` slots, a
    4-token prompt and 24 new tokens each, one segment to warm up, then
    three fenced segments timed."""
    from kubeoperator_tpu_torch.analysis import compile_count_guard
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec

    n = dp * tp
    spec = MeshSpec(dp=dp, tp=tp) if n > 1 else None
    with compile_count_guard() as guard:
        eng = SlotPoolEngine(cfg, model, slots=4 * dp, segment=8,
                             mesh_spec=spec, device=dev)
        eng.admit([(s, [1 + s, 2, 3, 4], 24, 0.0, 0)
                   for s in range(4 * dp)])
        eng.run_segment()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            eng.run_segment()
        _sync(dev)
        wall = time.perf_counter() - t0
    new_tok = 3 * eng.segment * 4 * dp
    return {"n_devices": n, "dp": dp, "tp": tp, "wall_s": round(wall, 4),
            "tok_s": round(new_tok / wall, 1),
            "compile_counts": guard.by_function()}


def _scaling_rank(rank: int, world: int, work: str, cfg, dp: int, tp: int,
                  device: str) -> None:
    """One rank of a scaling shape: the model from ``work``, the point,
    rank 0's result back to ``work``."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    with torch.device(dev):
        model = Transformer(cfg).eval()
    model.load_state_dict(torch.load(Path(work, "model.pt"),
                                     map_location=dev))
    point = _scaling_point(cfg, model, dp, tp, dev)
    if rank == 0:
        Path(work, f"point{dp}x{tp}.json").write_text(json.dumps(point))


def bench_scaling_real(cfg: TransformerConfig | None = None, model=None,
                       shapes=SCALING_SHAPES, device=None,
                       world: int | None = None) -> dict:
    """The pool per (dp, tp) shape: one device in this process, a larger
    world one spawn of its ranks (NCCL over the cards, gloo on the CPU),
    every rank holding ``model``'s weights. ``world`` is the number of
    ranks there are: the visible cards (default) or, on the CPU, as many
    as asked (default 1). Larger shapes are marked ``skipped``."""
    from kubeoperator_tpu_torch.train import launch

    cfg, model, dev = _setup(cfg, model, scaling_config, device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world is not None and world > cards:
            raise ValueError(f"a world of {world} needs that many cards; "
                             f"{cards} visible")
        world = cards if world is None else world
    world = world or 1
    curve = []
    with tempfile.TemporaryDirectory(prefix="ko-scaling-") as work:
        saved = False
        for dp, tp in shapes:
            n = dp * tp
            if n > world:
                curve.append({"n_devices": n, "dp": dp, "tp": tp,
                              "skipped": f"only {world} devices"})
                continue
            if n == 1:
                curve.append(_scaling_point(cfg, model, dp, tp, dev))
                continue
            if not saved:
                torch.save(model.state_dict(), Path(work, "model.pt"))
                saved = True
            launch.spawn(_scaling_rank, n, (work, cfg, dp, tp, dev.type),
                         backend=launch.backend_for(dev.type),
                         store=str(Path(work, f"store{dp}x{tp}").resolve()),
                         timeout_s=300.0, deadline_s=600.0)
            curve.append(json.loads(
                Path(work, f"point{dp}x{tp}.json").read_text()))
    return {**_device_info(dev), "world": world, "curve": curve}


def bench_bringup(cfg: TransformerConfig | None = None, model=None,
                  slots: int = 4, segment: int = 4, device=None) -> dict:
    """Cold then warm construction of the pool through one
    ``CompileCache`` (a fresh directory), each under the compile-count
    guard, and the autoscale replay of each arm's bring-up seconds."""
    from kubeoperator_tpu_torch.analysis import compile_count_guard
    from kubeoperator_tpu_torch.aot import CompileCache
    from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine

    cfg, model, dev = _setup(cfg, model, spec_config, device)
    root = tempfile.mkdtemp(prefix="ko-aot-bench-")

    def bringup() -> dict:
        cache = CompileCache(root)
        _sync(dev)
        with compile_count_guard() as guard:
            t0 = time.perf_counter()
            eng = SlotPoolEngine(cfg, model, slots=slots, segment=segment,
                                 compile_cache=cache, device=dev)
            _sync(dev)
            wall = time.perf_counter() - t0
        return {"seconds": round(wall, 4), "compiles": guard.total(),
                "hit": bool(eng.aot.hit), "source": eng.aot.source,
                "fingerprint": eng.aot.fingerprint}

    try:
        cold = bringup()
        warm = bringup()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def replay(bring_s: float) -> float:
        waiting = DETECT_S + SCHEDULE_S + bring_s
        return round(waiting + OVERLOAD_RPS * waiting / DRAIN_RPS, 4)

    return {**_device_info(dev),
            "bringup_ab": {"cold": cold, "warm": warm,
                           "speedup": round(cold["seconds"]
                                            / max(warm["seconds"], 1e-9),
                                            2)},
            "autoscale_replay": {
                "detect_s": DETECT_S, "schedule_s": SCHEDULE_S,
                "overload_rps": OVERLOAD_RPS, "drain_rps": DRAIN_RPS,
                "cold_breach_close_s": replay(cold["seconds"]),
                "warm_breach_close_s": replay(warm["seconds"])}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeoperator_tpu_torch.bench_serving",
        description="real-engine arms of the serving bench on the port's "
                    "slot pool")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--spec-real", action="store_true",
                      help="speculative engine vs its plain twin, greedy")
    mode.add_argument("--scaling-real", action="store_true",
                      help="the pool per dp×tp shape of SCALING_SHAPES")
    mode.add_argument("--bringup", action="store_true",
                      help="cold vs warm bring-up through the compile "
                           "cache, and the autoscale replay")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (gloo ranks); default the card")
    ap.add_argument("--world", type=int, default=None,
                    help="scaling: ranks available (default: the visible "
                         "cards; 1 on the CPU)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--segment", type=int, default=4)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.spec_real:
        result = bench_spec_real(device=args.device)
    elif args.scaling_real:
        result = bench_scaling_real(device=args.device, world=args.world)
    else:
        result = bench_bringup(slots=args.slots, segment=args.segment,
                               device=args.device)
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
