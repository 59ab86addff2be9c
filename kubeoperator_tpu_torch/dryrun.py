"""Dry-run entry points of the port: the counterpart of
``__graft_entry__.py``.

``entry()`` — ResNet-50 at 1000 classes with every parameter and
statistic zero and a zero batch of 8 images at 224², and its eval
forward: ``forward, (model, images) = entry()``, on the card unless
``device`` is "cpu".

``dryrun_multichip(n)`` — one train step of every config of the
reference's matrix over ``n`` ranks (NCCL over ``n`` visible cards, or
gloo ranks with ``device="cpu"``): resnet, transformer, vit,
multislice and resnet-multislice (n % 8 == 0), pipeline-stance,
fsdp-overlap, gpipe and moe (n % 8 == 0), each at the reference's mesh.
Rank 0 prints the reference's ``dryrun_multichip(n): <config> mesh=…
loss=… OK`` line per config, and with ``KO_DRYRUN_ARTIFACT=<path>``
writes ``{"n_devices", "configs"}`` of ``costmodel.config_record``\\ s.

    python -m kubeoperator_tpu_torch.dryrun [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from pathlib import Path

import torch


def entry(device=None):
    """(forward, (model, images)): the eval forward of an all-zero
    ResNet-50 on a zero batch [8, 224, 224, 3]."""
    from kubeoperator_tpu_torch.workloads import resnet
    from kubeoperator_tpu_torch.workloads.train import resolve_device

    dev = resolve_device(device)
    with torch.device(dev):
        model = resnet.ResNet(num_classes=1000, depth=50,
                              dtype=torch.bfloat16)
        images = torch.zeros(8, 224, 224, 3)
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.zero_()

    def forward(model, images):
        model.eval()
        with torch.no_grad():
            return model(images)

    return forward, (model, images)


def _stage(d_model: int, seed: int, device: torch.device) -> dict:
    """One residual MLP stage {w1, w2} [d, d], N(0, 0.05²) from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    w = (torch.randn(2, d_model, d_model, generator=gen) * 0.05).to(device)
    return {"w1": w[0].clone(), "w2": w[1].clone()}


def _normal(shape, seed: int, device: torch.device,
            scale: float = 0.1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=gen) * scale).to(device)


def _dryrun_multichip_impl(n_devices: int, device=None,
                           emit=None) -> list[dict]:
    """The config matrix on this rank of a world of ``n_devices``: every
    config appends its ``config_record`` and hands its OK line to
    ``emit`` (default: printed by rank 0), and rank 0 writes the artifact
    that ``KO_DRYRUN_ARTIFACT`` names. Returns the records."""
    from kubeoperator_tpu_torch.train.jobs import sgd_step
    from kubeoperator_tpu_torch.train.launch import group_info
    from kubeoperator_tpu_torch.workloads import pipeline as pipe
    from kubeoperator_tpu_torch.workloads.pipeline import MLP_FNS
    from kubeoperator_tpu_torch.workloads.costmodel import config_record
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.sharding import (
        MeshSpec, axis_group, axis_index, build_mesh, fsdp_overlapped_loss_fn,
        fsdp_overlapped_shardings, pack_stages, shard_batch,
        shard_params_fsdp, shard_tensor, with_virtual_slices,
    )
    from kubeoperator_tpu_torch.workloads import collectives as cl
    from kubeoperator_tpu_torch.workloads.train import (
        TrainConfig, Trainer, resolve_device,
    )
    from kubeoperator_tpu_torch.workloads.transformer import (
        TransformerConfig,
    )
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer

    n = n_devices
    dev = resolve_device(device)
    lead = group_info()["process_id"] == 0
    if emit is None:
        emit = ((lambda line: print(line, flush=True)) if lead
                else (lambda line: None))
    records: list[dict] = []

    def ok(config: str, spec: MeshSpec, loss: float, label: str = "",
           extra: str = "", **fields) -> None:
        if not math.isfinite(loss):
            raise AssertionError(f"{config}: non-finite loss {loss}")
        emit(f"dryrun_multichip({n}): {label or config} "
             f"mesh={dict(spec.sizes())} {extra}loss={loss:.4f} OK")
        records.append(config_record(config=config, n_devices=n,
                                     mesh=dict(spec.sizes()),
                                     loss=round(loss, 4), **fields))

    def trainer_step(tr, *inputs) -> float:
        state = tr.init_state()
        state, metrics = tr.train_step(state, *inputs)
        if state["step"] != 1:
            raise AssertionError(f"{type(tr).__name__}: the step did not "
                                 f"advance")
        return float(metrics["loss"])

    # dp × fsdp data plane (ZeRO-3)
    dp = 2 if n % 2 == 0 and n > 2 else 1
    spec = MeshSpec(dp=dp, fsdp=n // dp)
    tr = Trainer(TrainConfig(batch_size=2 * n, image_size=32, num_classes=16,
                             depth=18, warmup_steps=1, total_steps=4), spec,
                 device=dev, workload="resnet")
    ok("resnet", spec, trainer_step(tr, *tr.synthetic_batch()))

    # the transformer over tp × sp (+ dp)
    if n % 4 == 0:
        lm_spec = MeshSpec(dp=n // 4, tp=2, sp=2)
    elif n % 2 == 0:
        lm_spec = MeshSpec(dp=n // 2, sp=2)
    else:
        lm_spec = MeshSpec(dp=n)
    lm_cfg = TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_seq_len=64,
                               dtype=torch.float32, remat=True)
    lt = LMTrainer(lm_cfg, lm_spec, device=dev, workload="transformer")
    ok("transformer", lm_spec, trainer_step(lt, lt.synthetic_batch(
        max(2, lm_spec.dp * lm_spec.fsdp), 32)))

    # ViT over dp × fsdp
    vit_spec = MeshSpec(dp=dp, fsdp=n // dp)
    vcfg = ViTConfig(num_classes=16, image_size=32, patch=8,
                     encoder=TransformerConfig(d_model=64, n_heads=4,
                                               n_layers=2, d_ff=128,
                                               causal=False, max_seq_len=16,
                                               dtype=torch.float32,
                                               remat=True))
    vt = ViTTrainer(vcfg, vit_spec, device=dev)
    vx = _normal((2 * n, 32, 32, 3), 0, dev, 1.0)
    vy = (torch.arange(2 * n) % 16).to(dev)
    ok("vit", vit_spec, trainer_step(vt, shard_batch(vt.mesh, vx),
                                     shard_batch(vt.mesh, vy)))

    # two virtual slices: dp across them, tp × sp inside each
    inner = n // 2
    ms_tp = 2 if inner % 2 == 0 else 1
    ms_sp = inner // ms_tp
    if (n % 8 == 0 and ms_sp & (ms_sp - 1) == 0 and ms_sp <= 32
            and 4 % ms_tp == 0):
        slices = with_virtual_slices(n, 2)
        ms_spec = MeshSpec(dp=2, tp=ms_tp, sp=ms_sp)
        mst = LMTrainer(lm_cfg, ms_spec, device=dev, slices=slices,
                        workload="multislice")
        ok("multislice", ms_spec, trainer_step(mst, mst.synthetic_batch(
            2, 32)), extra="slices=2 ", slices=2)
        rs_spec = MeshSpec(dp=2, fsdp=inner)
        rst = Trainer(TrainConfig(batch_size=2 * n, image_size=32,
                                  num_classes=8, dtype=torch.float32),
                      rs_spec, device=dev, slices=slices,
                      workload="resnet-multislice")
        ok("resnet-multislice", rs_spec,
           trainer_step(rst, *rst.synthetic_batch()), extra="slices=2 ",
           slices=2)

    # the pipeline stance: stacked stages under remat, their params split
    # over fsdp and gathered whole on every rank (each computes the same
    # batch, so a gradient comes back as its block, not a sum)
    pp_spec = MeshSpec(fsdp=n)
    pp_mesh = build_mesh(pp_spec, dev.type)
    d_model, n_stages, vocab = 32, 4, 64
    stacked = pipe.stack_stages([_stage(d_model, i + 1, dev)
                                 for i in range(n_stages)])
    placed = shard_params_fsdp(stacked, pp_spec, min_size=64)
    fsdp = axis_group(pp_mesh, "fsdp")
    params = {"embed": _normal((vocab, d_model), 0, dev).requires_grad_(),
              "stages": {k: shard_tensor(v, placed[k], pp_mesh)
                         .requires_grad_() for k, v in stacked.items()},
              "head": _normal((d_model, vocab), 9, dev).requires_grad_()}
    tokens = (torch.arange(4 * 8) % vocab).reshape(4, 8).to(dev)

    def whole(k, v):
        dims = placed[k]
        return (cl.gather_alike(v, fsdp, dims.index("fsdp"))
                if "fsdp" in dims else v)

    def pp_loss(p):
        full = {**p, "stages": {k: whole(k, v)
                                for k, v in p["stages"].items()}}
        logits = pipe.pipeline_forward(MLP_FNS["embed_fn"],
                                       MLP_FNS["stage_fn"],
                                       MLP_FNS["head_fn"], full, tokens)
        onehot = torch.nn.functional.one_hot(tokens, vocab)
        return -(torch.log_softmax(logits, -1) * onehot).sum(-1).mean()

    ok("pipeline-stance", pp_spec,
       float(sgd_step(lambda p, x, y: pp_loss(p), params, None, None, 0.1)),
       label="pipeline-stance (fsdp scan)", extra=f"stages={n_stages} ",
       stages=n_stages)

    # the latency-hiding ZeRO-3 step: per-layer chunks over fsdp, the
    # gather of layer i+1 in flight under layer i
    ol_stacked, ol_unpack = pack_stages(
        [_stage(d_model, 60 + i, dev) for i in range(n_stages)],
        multiple=n)
    shd = fsdp_overlapped_shardings(pp_mesh)
    ol_params = {"embed": _normal((vocab, d_model), 0, dev).requires_grad_(),
                 "stages": shard_tensor(ol_stacked, shd["stages"], pp_mesh)
                 .requires_grad_(),
                 "head": _normal((d_model, vocab), 61, dev).requires_grad_()}
    ol_loss_fn = fsdp_overlapped_loss_fn(pp_mesh, unpack=ol_unpack,
                                         **MLP_FNS)
    ol_x = (torch.arange(2 * n) % vocab).to(dev)
    ol_y = ((torch.arange(2 * n) * 5) % vocab).to(dev)
    ok("fsdp-overlap", pp_spec,
       float(sgd_step(ol_loss_fn, ol_params, ol_x, ol_y, 0.1)),
       label="fsdp-overlap (chunked zero-3)", extra=f"layers={n_stages} ",
       layers=n_stages)

    # GPipe over pp (with dp): microbatches hop stage to stage
    gp_spec = MeshSpec(dp=max(1, n // 4), pp=min(4, n))
    gp_mesh = build_mesh(gp_spec, dev.type)
    s = gp_spec.pp
    gp_params = {"embed": _normal((vocab, d_model), 0, dev).requires_grad_(),
                 "stages": {k: v.requires_grad_() for k, v in _stage(
                     d_model, 40 + axis_index(gp_mesh, "pp"), dev).items()},
                 "head": _normal((d_model, vocab), 41, dev).requires_grad_()}
    gp_x = (torch.arange(8 * gp_spec.dp) % vocab).to(dev)
    gp_y = ((torch.arange(8 * gp_spec.dp) * 7) % vocab).to(dev)
    gp_loss_fn = pipe.gpipe_loss_fn(gp_mesh, n_micro=4, **MLP_FNS)
    ok("gpipe", gp_spec,
       float(sgd_step(gp_loss_fn, gp_params, gp_x, gp_y, 0.1)),
       label="pipeline-pp (gpipe ppermute)",
       extra=f"stages={s} microbatches=4 ", stages=s, microbatches=4,
       bubble_fraction=round(pipe.bubble_fraction(s, 4), 4))

    # MoE over dp × ep × tp
    if n % 8 == 0:
        moe_spec = MeshSpec(dp=n // 4, ep=2, tp=2)
        moe_cfg = TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                                    n_layers=2, d_ff=128, max_seq_len=64,
                                    dtype=torch.float32, remat=True,
                                    moe_experts=4)
        mt = LMTrainer(moe_cfg, moe_spec, device=dev, workload="moe")
        ok("moe", moe_spec, trainer_step(mt, mt.synthetic_batch(
            max(2, moe_spec.dp), 32)))

    out_path = os.environ.get("KO_DRYRUN_ARTIFACT")
    if out_path and lead:
        Path(out_path).write_text(json.dumps(
            {"n_devices": n, "configs": records}, indent=1) + "\n")
    return records


def _rank_main(rank: int, world: int, device: str, out: str) -> None:
    """One rank of the dry run: rank 0 prints and writes the records."""
    records = _dryrun_multichip_impl(world, None if device == "cuda"
                                     else device)
    if rank == 0:
        Path(out).write_text(json.dumps(records))


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """The matrix over ``n_devices`` new ranks (``launch.spawn``): NCCL,
    one a card, or gloo with ``device="cpu"``. A world larger than the
    visible cards raises. Returns rank 0's records."""
    from kubeoperator_tpu_torch.train import launch
    from kubeoperator_tpu_torch.workloads.train import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) needs that many "
                         f"cards; {torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="ko-dryrun-") as work:
        out = Path(work, "records.json")
        launch.spawn(_rank_main, n_devices, (dev.type, str(out)),
                     backend=launch.backend_for(dev.type),
                     store=str(Path(work, "store").resolve()),
                     timeout_s=300.0, deadline_s=900.0)
        return json.loads(out.read_text())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeoperator_tpu_torch.dryrun",
        description="dry runs of the port: the config matrix over n ranks, "
                    "or with no n the zero ResNet-50's eval forward")
    ap.add_argument("n", type=int, nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU; default the card")
    args = ap.parse_args(argv)
    if args.n is not None:
        dryrun_multichip(args.n, args.device)
        return 0
    forward, inputs = entry(args.device)
    out = forward(*inputs)
    print(f"entry: ResNet-50 eval forward {tuple(inputs[1].shape)} -> "
          f"{tuple(out.shape)} {out.dtype} on {out.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
