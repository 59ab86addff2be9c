"""What each rank runs in the port's multi-rank CPU tests (gloo, spawned
by ``kubeoperator_tpu_torch.train.launch.spawn``). Imports no JAX: the
ranks are new processes that import this module by name. Each group of
cases reads its inputs from ``workdir/inputs.pt`` (written by the test's
parent) and rank r writes its results to ``workdir/rank{r}.pt``; the test
files assert on them, one test per case."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

import torch

from kubeoperator_tpu_torch.workloads import ring_attention as ra
from kubeoperator_tpu_torch.workloads import sharding
from kubeoperator_tpu_torch.workloads.sharding import MeshSpec


def run(rank: int, world: int, group: str, workdir: str) -> None:
    """The rank function ``launch.spawn`` calls: every case of ``group``,
    in order, on every rank."""
    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    results = {name: case(rank, inputs) for name, case in GROUPS[group]}
    torch.save(results, Path(workdir) / f"rank{rank}.pt")


def spawn_group(group: str, world: int, workdir: Path, inputs: dict) -> list:
    """Write ``inputs``, run ``group`` on ``world`` gloo ranks, and return
    each rank's results in rank order (called by the test files)."""
    from kubeoperator_tpu_torch.train import launch

    torch.save(inputs, workdir / "inputs.pt")
    launch.spawn(run, world, (group, str(workdir)), backend="gloo",
                 store=str(workdir / "store"), timeout_s=60.0,
                 deadline_s=240.0)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


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

def _lm(spec: MeshSpec, params: str, **cfg_kw):
    """One LMTrainer step at ``spec`` from ``inputs["params"][params]``."""
    def case(rank, inputs):
        from dataclasses import replace

        from kubeoperator_tpu_torch.workloads.lm import LMTrainer

        lt = LMTrainer(replace(inputs["cfg"], **cfg_kw), spec, device="cpu")
        state = lt.init_state(params=inputs["params"][params])
        _, metrics = lt.train_step(state, inputs["tokens"])
        return {"loss": float(metrics["loss"]),
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


SHARDING = [
    ("fsdp4_prefetch", _overlap(MeshSpec(fsdp=4), True)),
    ("fsdp4_serial", _overlap(MeshSpec(fsdp=4), False)),
    ("dp2_fsdp2_prefetch", _overlap(MeshSpec(dp=2, fsdp=2), True)),
    ("dp2_fsdp2_serial", _overlap(MeshSpec(dp=2, fsdp=2), False)),
    ("mesh_layouts", _mesh_layouts),
]


# -- the job entry points ------------------------------------------------------

def _job(*argv):
    def case(rank, inputs):
        from kubeoperator_tpu_torch.train import jobs

        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = jobs.main(list(argv))
        except NotImplementedError as e:
            return {"raised": str(e)}
        return {"rc": rc, "records": [json.loads(line) for line in
                                      out.getvalue().splitlines()]}
    return case


LLM_TINY = ("--device", "cpu", "--steps", "2", "--d-model", "32", "--heads",
            "4", "--layers", "2", "--d-ff", "64", "--seq-len", "16",
            "--vocab", "64", "--batch", "2", "--no-bf16")
MLP_TINY = ("--device", "cpu", "--d-model", "16", "--vocab", "32")

JOBS = [
    ("smoke", _job("smoke", "--device", "cpu")),
    ("llm_dp2", _job("llm", *LLM_TINY, "--mesh", "dp:auto")),
    ("llm_sp2_ulysses", _job("llm", *LLM_TINY, "--mesh", "sp:2",
                             "--sp-attention", "ulysses")),
    ("llm_tp2_sample", _job("llm", *LLM_TINY, "--mesh", "tp:2", "--sample",
                            "3")),
    ("llm_ckpt_under_mesh", _job("llm", *LLM_TINY, "--mesh", "dp:2",
                                 "--ckpt-dir", "unused")),
    ("fsdp", _job("fsdp", *MLP_TINY, "--mesh", "fsdp:2", "--steps", "3",
                  "--warmup", "1", "--layers", "3")),
    ("fsdp_no_overlap", _job("fsdp", *MLP_TINY, "--mesh", "fsdp:2",
                             "--steps", "3", "--warmup", "1", "--layers",
                             "3", "--no-overlap")),
    ("pipeline", _job("pipeline", *MLP_TINY, "--mesh", "pp:2", "--steps",
                      "3")),
]

GROUPS = {"ring": RING, "lm": LM, "pipeline": PIPELINE,
          "sharding": SHARDING, "jobs": JOBS}
