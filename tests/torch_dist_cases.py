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


# -- the ResNet over dp×fsdp: BatchNorm, FusedConvBN (K8), the trainer --------

def _norm_unit(name: str):
    """The BatchNorm or FusedConvBN (with a ``kernel``) of
    ``inputs["units"][name]`` in training mode at dp 2 on this rank's
    rows: its out and dx rows, its parameters' gradient shares and its
    running statistics."""
    def case(rank, inputs):
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
        out = m(x)
        (out * sharding.shard_batch(mesh, p["g"])).sum().backward()
        return {"out": out.detach(), "dx": x.grad,
                "rows": x.shape[0] * x.shape[1] * x.shape[2],
                **{f"d{n}": q.grad for n, q in m.named_parameters()},
                "mean": m.mean.clone(), "var": m.var.clone()}
    return case


def _resnet_steps(spec: MeshSpec, steps: int = 3):
    """``steps`` Trainer steps from the bridged JAX start on this rank's
    block of the global batch: the losses, the whole params and the
    buffers (the BatchNorm running statistics)."""
    def case(rank, inputs):
        from kubeoperator_tpu_torch.workloads import train as ttrain

        p = inputs["trainer"]
        tr = ttrain.Trainer(p["cfg"], spec, device="cpu")
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


SHARDING = [
    ("fsdp4_prefetch", _overlap(MeshSpec(fsdp=4), True)),
    ("fsdp4_serial", _overlap(MeshSpec(fsdp=4), False)),
    ("dp2_fsdp2_prefetch", _overlap(MeshSpec(dp=2, fsdp=2), True)),
    ("dp2_fsdp2_serial", _overlap(MeshSpec(dp=2, fsdp=2), False)),
    ("mesh_layouts", _mesh_layouts),
]


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

JOBS = [
    ("smoke", _job("smoke", "--device", "cpu")),
    ("llm_dp2", _job("llm", *LLM_TINY, "--mesh", "dp:auto")),
    ("llm_sp2_ulysses", _job("llm", *LLM_TINY, "--mesh", "sp:2",
                             "--sp-attention", "ulysses")),
    ("llm_tp2_sample", _job("llm", *LLM_TINY, "--mesh", "tp:2", "--sample",
                            "3")),
    # saved at every step under dp 2, then resumed for a third step
    ("llm_ckpt_under_mesh", _jobs(
        ("llm", *LLM_TINY, "--mesh", "dp:2", "--ckpt-every", "1",
         "--ckpt-dir", "{workdir}/llm_ckpt"),
        ("llm", *LLM_TINY, "--steps", "3", "--mesh", "dp:2", "--ckpt-dir",
         "{workdir}/llm_ckpt"))),
    # 2 steps saved, then resumed to 3, over dp and over fsdp
    *((f"resnet50_{axis}2_ckpt", _jobs(
        ("resnet50", *RESNET_TINY, "--mesh", f"{axis}:auto", "--ckpt-dir",
         f"{{workdir}}/resnet_{axis}", "--steps", "2"),
        ("resnet50", *RESNET_TINY, "--mesh", f"{axis}:auto", "--ckpt-dir",
         f"{{workdir}}/resnet_{axis}"))) for axis in ("dp", "fsdp")),
    ("vit_dp2", _job("vit", *VIT_TINY, "--mesh", "dp:2")),
    ("vit_tp2", _job("vit", *VIT_TINY, "--mesh", "tp:2")),
    ("fsdp", _job("fsdp", *MLP_TINY, "--mesh", "fsdp:2", "--steps", "3",
                  "--warmup", "1", "--layers", "3")),
    ("fsdp_no_overlap", _job("fsdp", *MLP_TINY, "--mesh", "fsdp:2",
                             "--steps", "3", "--warmup", "1", "--layers",
                             "3", "--no-overlap")),
    ("pipeline", _job("pipeline", *MLP_TINY, "--mesh", "pp:2", "--steps",
                      "3")),
]

GROUPS = {"ring": RING, "lm": LM, "pipeline": PIPELINE,
          "sharding": SHARDING, "jobs": JOBS, "resnet": RESNET,
          "vit2": VIT2, "vit4": VIT4, "checkpoint": CHECKPOINT}
