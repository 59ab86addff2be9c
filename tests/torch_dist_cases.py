"""What each rank runs in the port's multi-rank CPU tests (gloo, spawned
by ``kubeoperator_tpu_torch.train.launch.spawn``). Imports no JAX: the
ranks are new processes that import this module by name. Each group of
cases reads its inputs from ``workdir/inputs.pt`` (written by the test's
parent); rank r writes each case's result to ``workdir/rank{r}.{case}.pt``
as soon as the case returns, and the test files assert on them, one test
per case.

A case that raises, or that a rank's collective gives up on, ends the
spawn: the other ranks would wait on its collectives. ``spawn_group``
then records the failure under that case, with each rank's traceback,
and spawns the ranks again from the next case, so one failing case fails
its own tests and no others. Each rank also writes when each case
started and ended (``{group}.rank{r}.times.jsonl``): how long a group
takes, and how far its ranks drift apart under load."""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
import traceback
from pathlib import Path

import torch

from kubeoperator_tpu_torch.workloads import ring_attention as ra
from kubeoperator_tpu_torch.workloads import sharding
from kubeoperator_tpu_torch.workloads.sharding import MeshSpec

# how long a collective waits for the other ranks, and how long one spawn
# of a group may run
COLLECTIVE_TIMEOUT_S = 60.0
DEADLINE_S = 240.0


class CaseFailed(AssertionError):
    """A case raised on a rank (or its spawn died): the ranks'
    tracebacks."""


class FailedCase:
    """What a failed case leaves in the results: reading anything from it
    raises ``CaseFailed`` with the ranks' tracebacks, so the failure
    shows under the tests of that case only."""

    def __init__(self, case: str, message: str):
        self.case, self.message = case, message

    def _raise(self, *_):
        raise CaseFailed(f"case {self.case!r} failed:\n{self.message}")

    __getitem__ = __iter__ = __len__ = __eq__ = __contains__ = _raise
    __hash__ = object.__hash__

    def __repr__(self):
        return f"FailedCase({self.case!r})"


def run(rank: int, world: int, group: str, workdir: str,
        start: int = 0) -> None:
    """The rank function ``launch.spawn`` calls: every case of ``group``
    from the ``start``-th on, in order, on every rank, each saved as it
    returns."""
    work = Path(workdir)
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    for name, case in GROUPS[group][start:]:
        began = time.time()
        try:
            result = case(rank, inputs)
        except BaseException:
            (work / f"rank{rank}.{name}.err").write_text(
                traceback.format_exc())
            raise
        torch.save(result, work / f"rank{rank}.{name}.tmp")
        (work / f"rank{rank}.{name}.tmp").replace(
            work / f"rank{rank}.{name}.pt")
        with open(work / f"{group}.rank{rank}.times.jsonl", "a") as f:
            f.write(json.dumps({"case": name, "start": began,
                                "end": time.time()}) + "\n")


def spawn_group(group: str, world: int, workdir: Path, inputs: dict) -> list:
    """Write ``inputs``, run ``group`` on ``world`` gloo ranks, and return
    each rank's {case: result} in rank order (called by the test files).
    A case that failed holds a ``FailedCase``; the cases after it ran on
    a new spawn."""
    from kubeoperator_tpu_torch.train import launch

    torch.save(inputs, workdir / "inputs.pt")
    names = [name for name, _ in GROUPS[group]]
    results: list[dict] = [{} for _ in range(world)]
    start = 0
    for attempt in range(len(names)):
        if start == len(names):
            break
        for name in names[start:]:
            for r in range(world):
                for ext in ("pt", "err"):
                    (workdir / f"rank{r}.{name}.{ext}").unlink(missing_ok=True)
        error = None
        try:
            launch.spawn(run, world, (group, str(workdir), start),
                         backend="gloo",
                         store=str(workdir / f"{group}.store{attempt}"),
                         timeout_s=COLLECTIVE_TIMEOUT_S,
                         deadline_s=DEADLINE_S)
        except Exception as e:          # a rank raised, died or overran
            error = f"{type(e).__name__}: {e}"
        for name in names[start:]:
            files = [workdir / f"rank{r}.{name}.pt" for r in range(world)]
            if all(f.exists() for f in files):
                for r, f in enumerate(files):
                    results[r][name] = torch.load(f, weights_only=False)
                start += 1
                continue
            errs = [workdir / f"rank{r}.{name}.err" for r in range(world)]
            message = "\n".join(
                [f"-- rank {r}:\n{e.read_text()}" for r, e in enumerate(errs)
                 if e.exists()] + [f"-- the spawn: {error}"])
            for r in range(world):
                results[r][name] = FailedCase(name, message)
            start += 1
            break
    return results


def coords(mesh) -> dict:
    return {a: sharding.axis_index(mesh, a) for a in sharding.AXES}


# -- ring and Ulysses attention ------------------------------------------------

def _attention(spec: MeshSpec, fn, causal: bool):
    def case(rank, inputs):
        mesh = sharding.build_mesh(spec)
        q, k, v, dout = (sharding.shard_batch(mesh, inputs[n], seq_dim=1)
                         .clone().requires_grad_(n != "dout")
                         for n in ("q", "k", "v", "dout"))
        out = fn(mesh, q, k, v, causal=causal)
        (out * dout).sum().backward()
        return {"coords": coords(mesh), "out": out.detach(),
                "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return case


def _ulysses_refusal(rank, inputs):
    """Three heads over sp 4: the raise, before any collective."""
    mesh = sharding.build_mesh(MeshSpec(sp=4))
    x = torch.zeros(1, 2, 3, 4)
    try:
        ra.ulysses_attention(x, x, x, sharding.axis_group(mesh, "sp"))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


RING = [
    ("ring_dp2_sp2", _attention(MeshSpec(dp=2, sp=2),
                                ra.sharded_ring_attention, True)),
    ("ulysses_dp2_sp2", _attention(MeshSpec(dp=2, sp=2),
                                   ra.sharded_ulysses_attention, True)),
    ("ring_sp4_noncausal", _attention(MeshSpec(sp=4),
                                      ra.sharded_ring_attention, False)),
    ("ulysses_sp4_noncausal", _attention(MeshSpec(sp=4),
                                         ra.sharded_ulysses_attention,
                                         False)),
    ("ulysses_heads_indivisible", _ulysses_refusal),
]


# -- the LM trainer ------------------------------------------------------------

def _lm(spec: MeshSpec, params: str, slices=None, **cfg_kw):
    """One LMTrainer step at ``spec`` (over ``slices``) from
    ``inputs["params"][params]``."""
    def case(rank, inputs):
        from dataclasses import replace

        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        lt = LMTrainer(replace(inputs["cfg"], **cfg_kw), spec, device="cpu",
                       slices=slices)
        state = lt.init_state(params=inputs["params"][params])
        _, metrics = lt.train_step(state, inputs["tokens"])
        return {"loss": float(metrics["loss"]), "aux": float(metrics["aux"]),
                "grads": lt.full_params(state["model"], grads=True),
                "params": lt.full_params(state["model"])}
    return case


def _dtensor_to_kernels(rank, inputs):
    """Each kernel wrapper handed a DTensor: the error it raised."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from kubeoperator_tpu_torch import bitcast_probe
    from kubeoperator_tpu_torch.workloads import (
        bn_fused, conv_vjp, flash_attention as fa,
    )

    mesh = init_device_mesh("cpu", (torch.distributed.get_world_size(),))
    x = distribute_tensor(torch.ones(2, 64, 64), mesh, [Replicate()])
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(x, x, x, 0.125, True, 64),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(x, x, x, x, x, x, 0.125,
                                                True, 64),
        "flash_fwd_packed": lambda: fa.flash_fwd_packed(x, x, x, 1, 0.125,
                                                        True, 64),
        "conv1x1_bwd_dx": lambda: conv_vjp.conv1x1_bwd_dx(x, x),
        "bn_bwd_stats": lambda: bn_fused.bn_bwd_stats(x, x, x, x, x, x,
                                                      True),
        "channel_sum": lambda: bitcast_probe.channel_sum(x),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = None
        except TypeError as e:
            raised[name] = str(e)
    return raised


LM = [
    ("dp2_sp2_ring", _lm(MeshSpec(dp=2, sp=2), "dp2_sp2_ring")),
    # remat on: the collectives run again in the backward's recompute
    ("fsdp2_tp2", _lm(MeshSpec(fsdp=2, tp=2), "fsdp2_tp2", remat=True)),
    ("tp2_sp2_ulysses", _lm(MeshSpec(tp=2, sp=2), "tp2_sp2_ulysses",
                            sp_attention="ulysses")),
    ("dp4", _lm(MeshSpec(dp=4), "dp2_sp2_ring")),
    ("dtensor_to_kernels", _dtensor_to_kernels),
    # dp over two virtual slices of two ranks, tp inside each
    ("dp2_tp2_multislice", _lm(MeshSpec(dp=2, tp=2), "dp2_tp2_multislice",
                               sharding.with_virtual_slices(4, 2))),
]


# -- the MoE LM over ep, with dp, fsdp, tp and sp ------------------------------

def _moe_aux(spec: MeshSpec):
    """The model's aux loss (the global batch's) and this rank's share of
    the objective at ``spec``, forward only."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        lt = LMTrainer(inputs["cfg"], spec, device="cpu")
        model = lt.init_state(params=inputs["params"]["moe"])["model"]
        with torch.no_grad():
            loss, aux = lt.objective(model, inputs["tokens"])
        return {"aux": float(aux), "share": float(loss)}
    return case


def _moe_save(spec: MeshSpec):
    """One step at ``spec``, then its checkpoint under ``moe_ckpt``: the
    whole state (layout-free) it saved."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        tr = LMTrainer(inputs["cfg"], spec, device="cpu")
        state = tr.init_state(params=inputs["params"]["moe"])
        state, _ = tr.train_step(state, inputs["tokens"])
        _checkpointer(f"{inputs['workdir']}/moe_ckpt", tr).save(
            state["step"], state)
        return _layout_free(tr, state)
    return case


def _moe_restore(spec: MeshSpec):
    """The ``moe_ckpt`` checkpoint restored at ``spec`` into a state of
    another seed, whole (layout-free) again."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        tr = LMTrainer(inputs["cfg"], spec, device="cpu")
        state = tr.init_state(seed=5)
        _checkpointer(f"{inputs['workdir']}/moe_ckpt", tr).restore(state)
        return _layout_free(tr, state)
    return case


# one step of the MoE LM at each mesh (the parent holds each against the
# JAX trainer at that mesh), on 2 and on 4 ranks
MOE_MESHES = {"ep2": dict(ep=2), "dp2_ep2": dict(dp=2, ep=2),
              "ep2_tp2": dict(ep=2, tp=2), "fsdp2_ep2": dict(fsdp=2, ep=2),
              "dp2_sp2": dict(dp=2, sp=2)}
MOE2 = [(n, _lm(MeshSpec(**d), n)) for n, d in MOE_MESHES.items()
        if MeshSpec(**d).n_devices == 2] + [
    ("aux_dp2", _moe_aux(MeshSpec(dp=2)))]
MOE4 = [(n, _lm(MeshSpec(**d), n)) for n, d in MOE_MESHES.items()
        if MeshSpec(**d).n_devices == 4] + [
    ("save_ep2_tp2", _moe_save(MeshSpec(ep=2, tp=2))),
    ("restore_dp4", _moe_restore(MeshSpec(dp=4))),
    # the llm job with --experts over 4 ranks (LLM_TINY is defined below;
    # the cases read it when they run)
    *((f"job_{name}", lambda rank, inputs, mesh=mesh: _job(
        "llm", *LLM_TINY, "--experts", "4", "--mesh", mesh)(rank, inputs))
      for name, mesh in (("dp2_ep2", "dp:2,ep:2"), ("ep2_tp2", "ep:2,tp:2")))]


# -- the serving mesh: the slot pool over dp × tp (× ep) ------------------------

# the pool's requests: (slot, prompt, max_tokens, temperature, seed);
# slots 0-1 are dp shard 0's and 2-3 shard 1's at dp 2
POOL_MIXED = [(0, [1, 2, 3, 4, 5], 6, 0.0, 0),
              (1, [7, 8, 9, 10, 11, 12, 13, 14], 5, 0.0, 0),
              (2, [42], 9, 0.0, 0),
              (3, [3, 1, 4, 1, 5, 9, 2], 12, 0.0, 0)]
POOL_SAMPLED = [(0, [2, 4, 6, 8], 8, 0.9, 123),
                (2, [1, 1, 1, 1, 1], 10, 0.0, 0)]
POOL_MOE = [(0, [1, 2, 3, 4, 5, 6, 7, 8], 6, 0.0, 0),
            (2, [9, 10, 11, 12], 8, 0.0, 0)]


def _drain(eng, entries, mid_flight=None) -> list:
    """Admit ``entries``, run segments until each is done (admitting
    ``mid_flight`` after the first), and return each request's row."""
    pos = eng.admit(entries)
    track = {slot: [pos[slot], len(pr) + mt - 1]
             for slot, pr, mt, _t, _s in entries}
    later = list(mid_flight or [])
    for _ in range(200):
        if all(p >= last for p, last in track.values()) and not later:
            break
        eng.run_segment()
        for t in track.values():
            t[0] = min(t[0] + eng.segment, t[1])
        if later:
            pos = eng.admit(later)
            track.update({slot: [pos[slot], len(pr) + mt - 1]
                          for slot, pr, mt, _t, _s in later})
            entries, later = list(entries) + later, []
    buf, _ = eng.poll()
    return [buf[slot][:len(pr) + mt].tolist()
            for slot, pr, mt, _t, _s in entries]


# the prefix-cache and spill script's prompts (tests/test_torch_prefix_cache)
SPILL_PRE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
SPILL_B = [(3 * i + 5) % 60 + 1 for i in range(16)]
SPILL_C = [(3 * i + 7) % 60 + 1 for i in range(20)]
SPILL_D = [(11 * i + 13) % 60 + 1 for i in range(20)]
SPILL_COUNTERS = ("prefix_hits", "prefix_pages_reused", "cow_copies",
                  "demotions", "promoted_hits")


def prefix_spill_script(eng) -> dict:
    """Waves of prefix-sharing prompts on both dp shards of a small pool
    with a host spill tier (any engine with the reference's host API, so
    the JAX engine runs it too): shared prefixes hit, LRU eviction demotes
    to the host tier and a later hit promotes back. After every wave the
    host state (counters, each shard's page accounting and spill pages,
    the wave's plans, the block tables), and at the end every slot's
    rows."""
    states, rows = [], {}

    def snap():
        states.append({
            "counters": {k: int(getattr(eng, k)) for k in SPILL_COUNTERS},
            "shards": [(eng.free_pages(i), eng.evictable_pages(i),
                        eng.pages_in_use(i), eng.spill_pages_used(i))
                       for i in range(eng.dp)],
            "plans": {int(k): v for k, v in eng.last_plans.items()},
            "bt": [list(map(int, r)) for r in eng._bt_np]})

    def wave(entries):
        pos = eng.admit(entries)
        snap()
        left = {slot: [pos[slot], len(pr) + mt - 1]
                for slot, pr, mt, _t, _s in entries}
        while any(p < last for p, last in left.values()):
            eng.run_segment()
            for t in left.values():
                t[0] = min(t[0] + eng.segment, t[1])
        buf, _ = eng.poll()
        for slot, pr, mt, _t, _s in entries:
            rows.setdefault(slot, []).append(
                list(map(int, buf[slot][:len(pr) + mt])))
        eng.release([slot for slot, *_ in entries])
        snap()

    wave([(0, SPILL_PRE, 4, 0.0, 0), (2, SPILL_PRE, 4, 0.0, 0)])
    wave([(1, SPILL_B, 4, 0.0, 0), (3, SPILL_C, 4, 0.0, 0)])
    wave([(0, SPILL_C, 4, 0.0, 0), (2, SPILL_D, 4, 0.0, 0)])
    wave([(1, SPILL_PRE[:8] + [9, 9, 9], 4, 0.0, 0),
          (3, SPILL_PRE + [7], 3, 0.0, 0)])
    return {"states": states, "rows": rows}


def _prefix_spill(spec: MeshSpec):
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads.decode_loop import (
            SlotPoolEngine,
        )

        cfg, model = _pool_model(inputs, "dense")
        return prefix_spill_script(SlotPoolEngine(
            cfg, model, slots=4, segment=4, page=8, pages=12,
            spill_pages=2, mesh_spec=spec, device="cpu"))
    return case


def _pool_model(inputs, key: str):
    from kubeoperator_tpu_torch.workloads.transformer import Transformer

    cfg = inputs[key]["cfg"]
    model = Transformer(cfg)
    model.load_state_dict(inputs[key]["params"])
    return cfg, model.eval()


def _pool(spec: MeshSpec, key: str = "dense", runs=("mixed", "mid",
                                                   "sampled", "spec")):
    """The slot pool at ``spec``, every rank making the same engine calls
    (SPMD, no leader): each run's rows, every rank's copy of them."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads.decode_loop import (
            SlotPoolEngine,
        )

        cfg, model = _pool_model(inputs, key)

        def engine(**kw):
            return SlotPoolEngine(cfg, model, slots=4, mesh_spec=spec,
                                  device="cpu", **kw)

        out = {}
        if "mixed" in runs:
            eng = engine(segment=3)
            out["mixed"] = _drain(eng, POOL_MIXED)
            out["dp"], out["pages"] = eng.dp, eng.pages
        if "mid" in runs:
            out["mid"] = _drain(engine(segment=2),
                                [(0, [5, 6, 7, 8, 9, 10], 10, 0.0, 3)],
                                [(2, [11, 12, 13], 8, 0.0, 4)])
        if "sampled" in runs:
            out["sampled"] = _drain(engine(segment=3), POOL_SAMPLED)
        if "moe" in runs:
            eng = engine(segment=2)
            out["moe"] = _drain(eng, POOL_MOE)
            out["expert_load"] = eng.expert_load()
        if "spec" in runs:
            out["spec"] = _drain_spec(engine(segment=1, spec_k=2,
                                             draft_layers=1, pages=40),
                                      POOL_MIXED)
        return out
    return case


def _drain_spec(eng, entries) -> list:
    """``_drain`` for a speculative engine: a round moves each row 1..K
    tokens, so the positions come back with ``poll_spec`` after each."""
    eng.admit(entries)
    last = {slot: len(pr) + mt - 1 for slot, pr, mt, _t, _s in entries}
    for _ in range(200):
        eng.run_segment()
        pos, _, _ = eng.poll_spec()
        if all(pos[s] >= stop for s, stop in last.items()):
            break
    buf, _ = eng.poll()
    return [buf[slot][:len(pr) + mt].tolist()
            for slot, pr, mt, _t, _s in entries]


def _batcher(spec: MeshSpec, key: str = "dense"):
    """``ContinuousBatcher`` on rank 0 over an ``EngineLeader``, the other
    ranks following: the replies of concurrent submits, the stats and the
    engine's per-shard page accounting (rank 0's)."""
    def case(rank, inputs):
        import threading

        from kubeoperator_tpu_torch.workloads import decode_loop as tdl
        from kubeoperator_tpu_torch.workloads.serving import (
            ContinuousBatcher,
        )

        cfg, model = _pool_model(inputs, key)
        eng = tdl.SlotPoolEngine(cfg, model, slots=4, segment=2, page=8,
                                 pages=8, mesh_spec=spec, device="cpu")
        if rank:
            tdl.follow(eng)
            return {}
        leader = tdl.EngineLeader(eng)
        cb = ContinuousBatcher(leader)
        replies: dict = {}

        def ask(i, prompt, mt):
            replies[i] = cb.submit(prompt, mt)

        asks = [threading.Thread(target=ask, args=(i, pr, mt))
                for i, (_s, pr, mt, _t, _d) in enumerate(POOL_MIXED)]
        for t in asks:
            t.start()
        for t in asks:
            t.join()
        shards = [{"free": eng.free_pages(i), "used": eng.pages_in_use(i)}
                  for i in range(eng.dp)]
        leader.stop()
        return {"replies": [replies[i] for i in range(len(asks))],
                "prometheus": cb.stats.prometheus(), "shards": shards,
                "batcher_dp": cb._dp}
    return case


def _serve_job(*flags):
    """``jobs.build_server`` with ``flags`` on every rank: rank 0 serves
    HTTP on a free port and answers ``POOL_MIXED``'s prompts (greedy),
    then shuts down and stops the followers, which return from
    ``build_server`` with no server."""
    def case(rank, inputs):
        import threading
        import urllib.request

        from kubeoperator_tpu_torch.train import jobs

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            server, batcher = jobs.build_server(jobs.build_parser().parse_args(
                ["serve", *flags, "--port", "0", "--host", "127.0.0.1"]))
        if server is None:
            return {"server": None}
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = "http://127.0.0.1:%d/generate" % server.server_address[1]
        replies = []
        for _slot, prompt, mt, _t, _s in POOL_MIXED:
            req = urllib.request.Request(url, data=json.dumps(
                {"prompt_ids": prompt, "max_tokens": mt}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                replies.append(json.loads(r.read())["tokens"])
        server.shutdown()
        server.server_close()
        batcher.engine.stop()
        return {"server": True, "replies": replies,
                "records": [json.loads(x) for x in
                            out.getvalue().splitlines()]}
    return case


# the handoff cases' prompt: two whole pages (page 8) and a tail
HANDOFF_PROMPT = SPILL_PRE + [11, 12]


def pool_host_state(eng) -> dict:
    """An engine's host state: counters, each shard's page accounting and
    prefix-cache entries (their tokens and pages), the block tables."""
    return {"counters": {k: int(getattr(eng, k)) for k in SPILL_COUNTERS},
            "shards": [(eng.free_pages(i), eng.evictable_pages(i),
                        eng.pages_in_use(i),
                        sorted(eng._shards[i].prefix.values()))
                       for i in range(eng.dp)],
            "bt": [list(map(int, r)) for r in eng._bt_np]}


def _handoff(spec: MeshSpec, shard: int):
    """The prefill→decode handoff over the pool at ``spec``, the slot on
    dp shard ``shard``: (1) a ``PrefillWorker`` on the mesh (every rank
    calling it) exports the prompt's two pages, which rank 0 lands in a
    one-device engine and decodes over; (2) rank 0's one-device export is
    imported into the mesh (the other ranks pass no payload) and decoded
    there, the import repeated (a no-op); (3) over an ``EngineLeader``,
    the worker exports from one meshed engine and the batcher's
    ``handoff`` lands the pages in another, which then serves the prompt
    (the batcher's other shards drained, so it admits on ``shard``). The
    rows, pages and every rank's host state."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.cluster import PrefillWorker
        from kubeoperator_tpu_torch.workloads import decode_loop as tdl
        from kubeoperator_tpu_torch.workloads.serving import (
            ContinuousBatcher,
        )

        cfg, model = _pool_model(inputs, "dense")

        def engine(meshed=True):
            return tdl.SlotPoolEngine(cfg, model, slots=4, segment=3,
                                      mesh_spec=spec if meshed else None,
                                      device="cpu")

        slot = shard * (4 // spec.dp) + (spec.dp == 1)
        entry = [(slot, HANDOFF_PROMPT, 6, 0.0, 0)]
        out = {}
        mesh = engine()
        payload = PrefillWorker(mesh, slot=slot).prefill(SPILL_PRE)
        out["export_state"] = pool_host_state(mesh)
        if rank == 0:
            one = engine(meshed=False)
            out["export_payload"] = [(tuple(k.shape), tuple(v.shape),
                                      str(k.dtype), k.device.type)
                                     for k, v in payload["layers"]]
            out["export_pages"] = one.import_prefix(payload["tokens"],
                                                    payload["layers"])
            out["export_rows"] = _drain(one, [(0, HANDOFF_PROMPT, 6, 0.0,
                                               0)])
            out["export_hits"] = one.prefix_hits
        else:
            out["export_payload"] = payload["layers"]
        src = PrefillWorker(engine(meshed=False)).prefill(SPILL_PRE)
        layers = src["layers"] if rank == 0 else None
        mesh = engine()
        out["import_pages"] = [mesh.import_prefix(src["tokens"], layers,
                                                  shard=shard)
                               for _ in range(2)]
        out["import_rows"] = _drain(mesh, entry)
        out["import_state"] = pool_host_state(mesh)
        prefill, decode = engine(), engine()
        if rank:
            tdl.follow(prefill)
            tdl.follow(decode)
            out["decode_state"] = pool_host_state(decode)
            return out
        # what the control group carries: every command object the leader
        # broadcasts, searched for tensors
        sent, broadcast = [], tdl.dist.broadcast_object_list

        def spy(objs, *a, **kw):
            sent.extend(objs)
            return broadcast(objs, *a, **kw)

        tdl.dist.broadcast_object_list = spy
        try:
            lead = tdl.EngineLeader(prefill)
            shipped = PrefillWorker(lead, slot=slot).prefill(SPILL_PRE)
            lead.stop()
            lead = tdl.EngineLeader(decode)
            cb = ContinuousBatcher(lead)
            out["leader_pages"] = cb.handoff(shipped["tokens"],
                                             shipped["layers"], shard=shard)
            # the other shards fenced, so the request admits where the
            # pages landed
            cb.drain(set(range(spec.dp)) - {shard})
            out["leader_reply"] = cb.submit(HANDOFF_PROMPT, 6)
            lead.stop()
        finally:
            tdl.dist.broadcast_object_list = broadcast
        out["commands"] = [c[0] for c in sent]
        out["command_tensors"] = _count_tensors(sent)
        out["decode_state"] = pool_host_state(decode)
        return out
    return case


def _count_tensors(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return 1
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_count_tensors(x) for x in obj)
    return 0


# the traced batcher's requests (prompt, max_tokens), greedy
TRACE_REQS = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 4),
              ([3, 1, 4, 1, 5, 9, 2], 8), ([2, 2, 2], 5)]


def gated_submits(cb, engine, reqs, wait_s: float = 120.0) -> list:
    """``reqs`` through ``cb`` (a ``ContinuousBatcher`` of either package
    over ``engine``), one client thread each, in order, with the engine's
    admissions held until every request is queued or admitted: the first
    wave admits the first request alone, the next all the others, so the
    slots and waves do not depend on the threads' timing. The replies in
    order."""
    admitted: list = []
    admit = engine.admit

    def wait(n: int, queued: bool) -> None:
        deadline = time.monotonic() + wait_s
        while len(admitted) + (len(cb._queue) if queued else 0) < n:
            if time.monotonic() > deadline:
                raise TimeoutError("requests never reached the batcher")
            time.sleep(0.001)

    def held(entries):
        admitted.extend(entries)
        wait(len(reqs), True)
        return admit(entries)

    engine.admit = held
    replies: dict = {}
    threads = []
    for i, (prompt, mt) in enumerate(reqs):
        t = threading.Thread(target=lambda i=i, p=prompt, mt=mt:
                             replies.__setitem__(i, cb.submit(
                                 p, mt, timeout=wait_s)))
        t.start()
        threads.append(t)
        wait(i + 1, i > 0)
    for t in threads:
        t.join(wait_s)
    engine.admit = admit
    return [replies[i] for i in range(len(reqs))]


def _trace(spec: MeshSpec):
    """A traced ``ContinuousBatcher`` on rank 0 over an ``EngineLeader``,
    the other ranks following: ``TRACE_REQS`` through ``gated_submits``;
    the replies, the rendered trees, the ring's evictions and the stats'
    exposition."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.telemetry.serve_trace import (
            ServeTracer, ServeTraceStore, render_record,
        )
        from kubeoperator_tpu_torch.workloads import decode_loop as tdl
        from kubeoperator_tpu_torch.workloads.serving import (
            ContinuousBatcher,
        )

        cfg, model = _pool_model(inputs, "dense")
        eng = tdl.SlotPoolEngine(cfg, model, slots=4, segment=3,
                                 mesh_spec=spec, device="cpu")
        if rank:
            tdl.follow(eng)
            return {}
        lead = tdl.EngineLeader(eng)
        store = ServeTraceStore()
        cb = ContinuousBatcher(lead, tracer=ServeTracer(store))
        replies = gated_submits(cb, lead, TRACE_REQS)
        lead.stop()
        return {"replies": replies,
                "records": [render_record(r) for r in store.records()],
                "evicted": store.evicted,
                "prometheus": cb.stats.prometheus()}
    return case


SERVE_TINY = ("--device", "cpu", "--vocab", "64", "--d-model", "32",
              "--heads", "4", "--layers", "2", "--max-seq-len", "24",
              "--no-bf16", "--engine", "continuous", "--slots", "4",
              "--segment", "2")
SERVE2 = [
    ("pool_dp2", _pool(MeshSpec(dp=2))),
    ("pool_tp2", _pool(MeshSpec(tp=2))),
    ("batcher_dp2", _batcher(MeshSpec(dp=2))),
    ("prefix_spill_dp2", _prefix_spill(MeshSpec(dp=2))),
    ("job_dp2", _serve_job(*SERVE_TINY, "--mesh", "dp:2")),
    ("handoff_dp2", _handoff(MeshSpec(dp=2), shard=1)),
    ("handoff_tp2", _handoff(MeshSpec(tp=2), shard=0)),
]
TRACE2 = [("trace_dp2", _trace(MeshSpec(dp=2)))]
SERVE4 = [
    ("moe_dp2_ep2", _pool(MeshSpec(dp=2, ep=2), "moe", ("moe",))),
    ("pool_dp2_tp2", _pool(MeshSpec(dp=2, tp=2), runs=("mixed",))),
    ("job_moe_dp2_ep2", _serve_job(*SERVE_TINY, "--moe", "4", "--mesh",
                                   "dp:2,ep:2")),
]


# -- the ResNet over dp×fsdp: BatchNorm, FusedConvBN (K8), the trainer --------

def _norm_unit(name: str, function: bool = False):
    """The BatchNorm or FusedConvBN (with a ``kernel``) of
    ``inputs["units"][name]`` in training mode at dp 2 on this rank's
    rows: its out and dx rows, its parameters' gradient shares and its
    running statistics. With ``function`` the BatchNorm's step is
    ``batch_norm.BatchNormTrain`` (the card's route, here on its plain
    versions) with the module's parameters, buffers and data groups."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads.batch_norm import BatchNormTrain
        from kubeoperator_tpu_torch.workloads.bn_fused import FusedConvBN
        from kubeoperator_tpu_torch.workloads.resnet import BatchNorm

        p = inputs["units"][name]
        mesh = sharding.build_mesh(MeshSpec(dp=2))
        if "kernel" in p:
            ci, co = p["kernel"].shape[2:]
            m = FusedConvBN(ci, co, relu=p["relu"], dtype=torch.float32)
        else:
            m = BatchNorm(p["scale"].shape[0], dtype=torch.float32)
        m.load_state_dict({k: p[k] for k in m.state_dict()})
        sharding.set_data_groups(m, mesh)
        x = sharding.shard_batch(mesh, p["x"]).clone().requires_grad_()
        if function:
            out = BatchNormTrain.apply(x, m.scale, m.bias, (m.mean, m.var),
                                       m.momentum, m.eps, False, True,
                                       tuple(m.stat_groups))
        else:
            out = m(x)
        (out * sharding.shard_batch(mesh, p["g"])).sum().backward()
        return {"out": out.detach(), "dx": x.grad,
                "rows": x.shape[0] * x.shape[1] * x.shape[2],
                **{f"d{n}": q.grad for n, q in m.named_parameters()},
                "mean": m.mean.clone(), "var": m.var.clone()}
    return case


def _resnet_steps(spec: MeshSpec, steps: int = 3, slices=None,
                  key: str = "trainer"):
    """``steps`` Trainer steps (over ``slices``) from the bridged JAX
    start ``inputs[key]`` on this rank's block of the global batch: the
    losses, the whole params and the buffers (the BatchNorm running
    statistics)."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads import train as ttrain

        p = inputs[key]
        tr = ttrain.Trainer(p["cfg"], spec, device="cpu", slices=slices)
        state = tr.init_state(params=p["params"])
        x = sharding.shard_batch(tr.mesh, p["x"])
        y = sharding.shard_batch(tr.mesh, p["y"])
        losses = []
        for _ in range(steps):
            state, metrics = tr.train_step(state, x, y)
            losses.append(float(metrics["loss"]))
        return {"coords": coords(tr.mesh), "losses": losses,
                "step": state["step"], "placements": tr.placements,
                "params": tr.full_params(state["model"]),
                "buffers": {n: b.clone() for n, b in
                            state["model"].named_buffers()}}
    return case


RESNET = [
    # fused_n128_split: 64 rows a rank take the autograd fallback, the
    # whole batch's 128 the kernel
    *((name, _norm_unit(name)) for name in (
        "fused_n256", "fused_n128_split", "fused_n256_norelu", "bn_dp2")),
    ("bn_function_dp2", _norm_unit("bn_dp2", function=True)),
    ("trainer_dp2", _resnet_steps(MeshSpec(dp=2))),
    ("trainer_fsdp2", _resnet_steps(MeshSpec(fsdp=2))),
]


# -- the ViT over dp×fsdp×tp×sp -----------------------------------------------

def _vit_step(name: str, spec: MeshSpec):
    """One ViTTrainer step at ``spec`` from ``inputs["params"][name]``."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads.vit import ViTTrainer

        vt = ViTTrainer(inputs["cfg"], spec, device="cpu")
        state = vt.init_state(params=inputs["params"][name])
        x = sharding.shard_batch(vt.mesh, inputs["x"])
        y = sharding.shard_batch(vt.mesh, inputs["y"])
        _, metrics = vt.train_step(state, x, y)
        return {"loss": float(metrics["loss"]),
                "grads": vt.full_params(state["model"], grads=True),
                "params": vt.full_params(state["model"])}
    return case


def _vit_refusal(rank, inputs):
    from kubeoperator_tpu_torch.workloads.vit import ViTTrainer

    try:
        ViTTrainer(inputs["cfg"], MeshSpec(dp=2, pp=2), device="cpu")
    except NotImplementedError as e:
        return {"error": str(e)}
    return {"error": None}


# the ViT's meshes by name, on 2 and on 4 ranks
VIT_MESHES = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2), "tp2": dict(tp=2),
              "sp2": dict(sp=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}
VIT2 = [(n, _vit_step(n, MeshSpec(**d))) for n, d in VIT_MESHES.items()
        if MeshSpec(**d).n_devices == 2]
VIT4 = [(n, _vit_step(n, MeshSpec(**d))) for n, d in VIT_MESHES.items()
        if MeshSpec(**d).n_devices == 4] + [("pp_refused", _vit_refusal)]


# -- checkpoints under a mesh -------------------------------------------------

def _lm_trainer(spec: MeshSpec, inputs):
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer

    return LMTrainer(inputs["lm_cfg"], spec, device="cpu")


def _checkpointer(directory: str, tr):
    from kubeoperator_tpu_torch.workloads.checkpoint import (
        WorkloadCheckpointer,
    )

    return WorkloadCheckpointer(directory, mesh=tr.mesh,
                                placements=tr.placements)


def _layout_free(tr, state):
    from kubeoperator_tpu_torch.workloads import checkpoint

    return checkpoint.layout_free(state["step"], state, tr.placements,
                                  tr.mesh)


def _resume(make_trainer, init, step_args, save_dir: str):
    """4 uninterrupted steps, saving after 2, against 2 steps from that
    checkpoint restored into a fresh state of another seed: losses and
    whole states (layout-free) of both."""
    def case(rank, inputs):
        tr = make_trainer(inputs)
        state = init(tr, inputs, 0)
        args = step_args(tr, inputs)
        ckpt = _checkpointer(f"{inputs['workdir']}/{save_dir}", tr)
        whole, losses = [], []
        for step in range(4):
            state, metrics = tr.train_step(state, *args)
            whole.append(float(metrics["loss"]))
            if step == 1:
                ckpt.save(state["step"], state)
        back = ckpt.restore(init(tr, inputs, 9))
        for _ in range(2):
            back, metrics = tr.train_step(back, *args)
            losses.append(float(metrics["loss"]))
        return {"losses": whole, "resumed_losses": losses,
                "state": _layout_free(tr, state),
                "resumed_state": _layout_free(tr, back)}
    return case


def _lm_init(tr, inputs, seed):
    return tr.init_state(params=inputs["lm_params"] if seed == 0 else None,
                         seed=seed)


def _resnet_trainer(inputs):
    from kubeoperator_tpu_torch.workloads import train as ttrain

    return ttrain.Trainer(inputs["resnet_cfg"], MeshSpec(dp=2, fsdp=2),
                          device="cpu")


def _resnet_batch(tr, inputs):
    return (sharding.shard_batch(tr.mesh, inputs["x"]),
            sharding.shard_batch(tr.mesh, inputs["y"]))


def _restore_lm(spec: MeshSpec):
    """The (fsdp 2, tp 2) checkpoint restored at ``spec`` into a state of
    another seed, whole (layout-free) again."""
    def case(rank, inputs):
        tr = _lm_trainer(spec, inputs)
        state = tr.init_state(seed=5)
        _checkpointer(f"{inputs['workdir']}/lm", tr).restore(state)
        return _layout_free(tr, state)
    return case


CHECKPOINT = [
    ("lm_fsdp2_tp2_resume", _resume(
        lambda inputs: _lm_trainer(MeshSpec(fsdp=2, tp=2), inputs), _lm_init,
        lambda tr, inputs: (inputs["tokens"],), "lm")),
    ("lm_restore_dp4", _restore_lm(MeshSpec(dp=4))),
    ("resnet_dp2_fsdp2_resume", _resume(
        _resnet_trainer, lambda tr, inputs, seed: tr.init_state(seed=seed),
        _resnet_batch, "resnet")),
]


# -- GPipe ---------------------------------------------------------------------

def _fns():
    return dict(
        embed_fn=lambda p, x: p[x],
        stage_fn=lambda p, h: torch.tanh(h @ p["w"]) + h,
        head_fn=lambda p, h: h @ p,
        loss_fn=lambda out, y: -torch.log_softmax(out, -1)[
            torch.arange(y.shape[0]), y])


def _gpipe(spec: MeshSpec, n_micro: int, problem: str):
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads import pipeline as pipe

        p = inputs[problem]
        mesh = sharding.build_mesh(spec)
        stage = sharding.axis_index(mesh, "pp")
        params = {"embed": p["embed"].clone().requires_grad_(),
                  "stages": {"w": p["w"][stage].clone().requires_grad_()},
                  "head": p["head"].clone().requires_grad_()}
        loss_fn = pipe.gpipe_loss_fn(mesh, n_micro=n_micro, **_fns())
        try:
            loss = loss_fn(params, p["x"], p["y"])
        except ValueError as e:
            return {"error": str(e)}
        g_embed, g_w, g_head = torch.autograd.grad(
            loss, [params["embed"], params["stages"]["w"], params["head"]])
        return {"coords": coords(mesh), "loss": float(loss),
                "embed": g_embed, "w": g_w, "head": g_head}
    return case


PIPELINE = [
    ("gpipe_dp2_pp2", _gpipe(MeshSpec(dp=2, pp=2), 4, "pp2")),
    ("gpipe_pp4_uneven", _gpipe(MeshSpec(pp=4), 2, "pp4")),
    ("gpipe_indivisible", _gpipe(MeshSpec(pp=4), 3, "pp4")),
]


# -- sharding: meshes and the overlapped ZeRO-3 step ---------------------------

def _overlap(spec: MeshSpec, prefetch: bool):
    def case(rank, inputs):
        p = inputs["overlap"]
        mesh = sharding.build_mesh(spec)
        stacked, unpack = sharding.pack_stages(p["stages"],
                                               multiple=spec.fsdp)
        shd = sharding.fsdp_overlapped_shardings(mesh)
        params = {"embed": p["embed"].clone().requires_grad_(),
                  "stages": sharding.shard_tensor(
                      stacked, shd["stages"], mesh).requires_grad_(),
                  "head": p["head"].clone().requires_grad_()}
        lf = sharding.fsdp_overlapped_loss_fn(
            mesh, embed_fn=lambda e, x: x @ e,
            stage_fn=lambda q, h: torch.tanh(h @ q["w1"]) @ q["w2"] + h,
            head_fn=lambda e, h: h @ e,
            loss_fn=lambda out, y: ((out - y) ** 2).mean(-1),
            unpack=unpack, remat=True, prefetch=prefetch)
        loss = lf(params, p["x"], p["y"])
        g = torch.autograd.grad(loss, [params["embed"], params["stages"],
                                       params["head"]])
        stages = sharding.unshard_tensor(g[1], shd["stages"], mesh)
        return {"loss": float(loss), "embed": g[0], "head": g[2],
                "stages": [unpack(s) for s in stages]}
    return case


def _mesh_layouts(rank, inputs):
    """Axis names of built meshes, each rank's batch block, and the raise
    on a spec whose device count is not the world's."""
    out = {}
    for spec in (MeshSpec(dp=2, tp=2), MeshSpec(fsdp=2, sp=2),
                 MeshSpec(pp=4), MeshSpec(dp=4)):
        mesh = sharding.build_mesh(spec)
        out[str(spec)] = {"names": tuple(mesh.mesh_dim_names),
                          "coords": coords(mesh),
                          "rows": sharding.shard_batch(
                              mesh, torch.arange(8)).tolist()}
    try:
        sharding.build_mesh(MeshSpec(dp=2))
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def _multislice_psum(slices):
    """A tp psum over a dp 2 × tp 2 mesh over ``slices``: each rank's
    coordinates, the mesh's ranks, its tp group's sum of rank + 1 and its
    rows of an 8-row batch."""
    def case(rank, inputs):
        import torch.distributed as dist

        mesh = sharding.build_mesh(MeshSpec(dp=2, tp=2), slices=slices)
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x, group=sharding.axis_group(mesh, "tp"))
        return {"coords": coords(mesh), "mesh": mesh.mesh.tolist(),
                "tp_sum": float(x),
                "rows": sharding.shard_batch(mesh, torch.arange(8)).tolist()}
    return case


def _node_slices(rank, inputs):
    """``torchrun``'s environment of two nodes whose ranks interleave
    (``GROUP_RANK`` = rank % 2): the gathered slices, and the default
    mesh built over them."""
    import os

    saved = {k: os.environ.get(k) for k in ("GROUP_RANK",
                                            "LOCAL_WORLD_SIZE")}
    os.environ.update({"GROUP_RANK": str(rank % 2),
                       "LOCAL_WORLD_SIZE": "2"})
    try:
        slices = sharding.node_slices()
        mesh = sharding.build_mesh(MeshSpec(dp=2, tp=2))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"slices": slices, "mesh": mesh.mesh.tolist()}


def _multislice_refusals(rank, inputs):
    """The layouts the reference refuses over two slices, built on rank 0
    alone: a raise that made a process group first would wait for the
    other ranks, so each returns before any collective. Then every rank
    meets in a barrier."""
    import torch.distributed as dist

    out = {}
    if rank == 0:
        for name, spec, slices in inputs["refusals"]:
            try:
                sharding.build_mesh(spec, slices=slices)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    dist.barrier()
    return out


SHARDING = [
    ("fsdp4_prefetch", _overlap(MeshSpec(fsdp=4), True)),
    ("fsdp4_serial", _overlap(MeshSpec(fsdp=4), False)),
    ("dp2_fsdp2_prefetch", _overlap(MeshSpec(dp=2, fsdp=2), True)),
    ("dp2_fsdp2_serial", _overlap(MeshSpec(dp=2, fsdp=2), False)),
    ("mesh_layouts", _mesh_layouts),
    # two slices: contiguous (with_virtual_slices) and interleaved ids
    ("multislice_psum", _multislice_psum(sharding.with_virtual_slices(4,
                                                                      2))),
    ("multislice_psum_interleaved", _multislice_psum([1, 0, 1, 0])),
    ("multislice_refusals", _multislice_refusals),
    ("node_slices", _node_slices),
    # ResNet-18 at dp 2 × fsdp 2 over two interleaved slices: dp across
    # them, fsdp inside each
    ("resnet_multislice", _resnet_steps(MeshSpec(dp=2, fsdp=2), steps=2,
                                        slices=[0, 1, 0, 1],
                                        key="resnet_multislice")),
]


# -- the harness itself: a failing case fails alone ----------------------------

def _psum_rank(rank, inputs):
    import torch.distributed as dist

    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    return {"sum": float(x)}


def _raise_on_rank1(rank, inputs):
    """Rank 1 raises while rank 0 waits in a collective it never joins."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return {}


HARNESS = [("before", _psum_rank), ("fails", _raise_on_rank1),
           ("after", _psum_rank)]


# -- the job entry points ------------------------------------------------------

def _run_job(argv: list) -> dict:
    from kubeoperator_tpu_torch.train import jobs

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jobs.main(argv)
    return {"rc": rc, "records": [json.loads(line) for line in
                                  out.getvalue().splitlines()]}


def _job(*argv):
    """The job's records; ``{workdir}`` in an argument is the group's
    working directory."""
    def case(rank, inputs):
        return _run_job([a.format(workdir=inputs.get("workdir", ""))
                         for a in argv])
    return case


def _jobs(*runs):
    """Several runs of jobs in a row (a run, then its resumed rerun)."""
    def case(rank, inputs):
        return [_job(*argv)(rank, inputs) for argv in runs]
    return case


LLM_TINY = ("--device", "cpu", "--steps", "2", "--d-model", "32", "--heads",
            "4", "--layers", "2", "--d-ff", "64", "--seq-len", "16",
            "--vocab", "64", "--batch", "2", "--no-bf16")
MLP_TINY = ("--device", "cpu", "--d-model", "16", "--vocab", "32")
RESNET_TINY = ("--device", "cpu", "--batch-per-chip", "2", "--image-size",
               "32", "--depth", "18", "--steps", "3")
VIT_TINY = ("--device", "cpu", "--batch-per-chip", "2", "--image-size", "32",
            "--patch", "8", "--d-model", "32", "--heads", "4", "--layers",
            "2", "--classes", "10", "--steps", "3")

# the job entry points in three groups, each its own spawn
JOBS_LLM = [
    ("smoke", _job("smoke", "--device", "cpu")),
    ("llm_dp2", _job("llm", *LLM_TINY, "--mesh", "dp:auto")),
    ("llm_sp2_ulysses", _job("llm", *LLM_TINY, "--mesh", "sp:2",
                             "--sp-attention", "ulysses")),
    ("llm_tp2_sample", _job("llm", *LLM_TINY, "--mesh", "tp:2", "--sample",
                            "3")),
    ("llm_moe_ep2", _job("llm", *LLM_TINY, "--experts", "4", "--mesh",
                         "ep:auto", "--sample", "3")),
    # saved at every step under dp 2, then resumed for a third step
    ("llm_ckpt_under_mesh", _jobs(
        ("llm", *LLM_TINY, "--mesh", "dp:2", "--ckpt-every", "1",
         "--ckpt-dir", "{workdir}/llm_ckpt"),
        ("llm", *LLM_TINY, "--steps", "3", "--mesh", "dp:2", "--ckpt-dir",
         "{workdir}/llm_ckpt"))),
]
JOBS_VISION = [
    # 2 steps saved, then resumed to 3, over dp and over fsdp
    *((f"resnet50_{axis}2_ckpt", _jobs(
        ("resnet50", *RESNET_TINY, "--mesh", f"{axis}:auto", "--ckpt-dir",
         f"{{workdir}}/resnet_{axis}", "--steps", "2"),
        ("resnet50", *RESNET_TINY, "--mesh", f"{axis}:auto", "--ckpt-dir",
         f"{{workdir}}/resnet_{axis}"))) for axis in ("dp", "fsdp")),
    ("vit_dp2", _job("vit", *VIT_TINY, "--mesh", "dp:2")),
    ("vit_tp2", _job("vit", *VIT_TINY, "--mesh", "tp:2")),
]
JOBS_MLP = [
    ("fsdp", _job("fsdp", *MLP_TINY, "--mesh", "fsdp:2", "--steps", "3",
                  "--warmup", "1", "--layers", "3")),
    ("fsdp_aot_cache", _job("fsdp", *MLP_TINY, "--mesh", "fsdp:2", "--steps",
                            "1", "--warmup", "0", "--layers", "2",
                            "--aot-cache", "{workdir}/aot")),
    ("fsdp_no_overlap", _job("fsdp", *MLP_TINY, "--mesh", "fsdp:2",
                             "--steps", "3", "--warmup", "1", "--layers",
                             "3", "--no-overlap")),
    ("pipeline", _job("pipeline", *MLP_TINY, "--mesh", "pp:2", "--steps",
                      "3")),
]



# -- the multi-device bench and the dry run --------------------------------------

# bench_multichip's matrix at world 2, the ring at a short sequence
BENCH_SEQ = 1024
BENCH2_CONFIGS = ("resnet", "transformer", "vit", "fsdp-overlap", "gpipe",
                  f"ring-attention-{BENCH_SEQ // 1024}k")


def _bench(config: str):
    """One config of ``bench_multichip.matrix`` at this world, one step
    after one warm-up step, priced for ``inputs["card"]``: its records.
    The ring runs ``_measure_ring`` at ``BENCH_SEQ`` (the matrix's T 8k
    is the card's length)."""
    def case(rank, inputs):
        import torch.distributed as dist

        from kubeoperator_tpu_torch import bench_multichip as bm

        n, cpu = dist.get_world_size(), torch.device("cpu")
        if config.startswith("ring-attention"):
            # the matrix's ring steps: max(2, steps // 2)
            return bm.run_config(config, lambda: bm._measure_ring(
                n, BENCH_SEQ, 2, 1, cpu, inputs["card"]), n)
        fns = dict(bm.matrix(n, 1, 1, False, cpu, inputs["card"]))
        return bm.run_config(config, fns[config], n)
    return case


def _dryrun(rank, inputs):
    """``dryrun._dryrun_multichip_impl`` at this world on the CPU: each
    rank's OK lines (rank 0's only) and records; rank 0 writes the
    artifact that ``KO_DRYRUN_ARTIFACT`` names."""
    import os

    import torch.distributed as dist

    from kubeoperator_tpu_torch import dryrun

    n = dist.get_world_size()
    os.environ["KO_DRYRUN_ARTIFACT"] = inputs["artifact"][n]
    lines: list[str] = []
    records = dryrun._dryrun_multichip_impl(n, "cpu", lines.append)
    return {"lines": lines if rank == 0 else [], "records": records}


BENCH2 = [(name, _bench(name)) for name in BENCH2_CONFIGS]
DRYRUN = [("dryrun", _dryrun)]

GROUPS = {"ring": RING, "lm": LM, "pipeline": PIPELINE,
          "sharding": SHARDING, "jobs_llm": JOBS_LLM,
          "jobs_vision": JOBS_VISION, "jobs_mlp": JOBS_MLP, "resnet": RESNET,
          "vit2": VIT2, "vit4": VIT4, "checkpoint": CHECKPOINT,
          "moe2": MOE2, "moe4": MOE4, "serve2": SERVE2, "serve4": SERVE4,
          "trace2": TRACE2,
          "harness": HARNESS, "bench2": BENCH2, "dryrun4": DRYRUN,
          "dryrun8": DRYRUN}
