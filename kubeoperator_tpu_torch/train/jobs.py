"""Job entry points of the PyTorch port: ``smoke`` (a matmul on the
card and a psum over the ranks), ``mnist`` (a small ResNet on one
MNIST-shaped batch), ``llm`` (train the transformer LM over a
dp×fsdp×tp×sp mesh, then optionally sample from it), ``fsdp`` (the
chunked ZeRO-3 MLP LM with gather/compute overlap), ``pipeline`` (the
MLP LM pipelined over a pp axis), ``resnet50`` (train a ResNet on a
synthetic image stream or an ``.npy`` dataset), ``vit`` (train the Vision
Transformer classifier on a synthetic image stream) and ``serve`` (the
token-generation HTTP endpoint). The counterparts of the ``cmd_*``
functions in ``kubeoperator_tpu/train/jobs.py``, with the same flags plus
``--device``. ``llm`` and ``resnet50`` checkpoint to ``--ckpt-dir`` and
resume from its latest checkpoint, on one device or under a mesh, of the
same shape or another; ``serve --ckpt-dir`` serves the llm job's weights,
saved on one device or under a mesh; ``--metrics-port`` (``llm``,
``resnet50``, ``vit``, ``fsdp``, ``pipeline``) serves the process
registry on ``/metrics``, where the trainers' step phases
(``ko_train_phase_*``) show where a step's time goes and every training
job observes its mean step in ``ko_train_step_seconds``.

A multi-device job is one process per device: ``torchrun
--nproc-per-node N -m kubeoperator_tpu_torch.train.jobs ...`` (NCCL on N
cards; gloo with ``--device cpu``). ``--mesh`` names the degrees
(``dp:auto,tp:2``; ``auto`` takes the ranks the others leave). Only rank
0 prints the records. ``resnet50`` and ``vit`` train a global batch of
``--batch-per-chip`` × the world's ranks, and each rank makes or reads only
its block of it: the synthetic stream seeded by the block's index, the
``.npy`` dataset's shard of that index. ``llm --experts N`` takes ep
too (experts over ep, batch over dp and fsdp); ``serve --mesh`` (the
continuous engine) splits slots and pages over dp, heads over tp and
experts over ep, and only rank 0 serves HTTP.

    python -m kubeoperator_tpu_torch.train.jobs smoke
    torchrun --nproc-per-node 4 -m kubeoperator_tpu_torch.train.jobs llm \\
        --device cpu --mesh dp:2,sp:2 --steps 2 --d-model 64 --heads 4 \\
        --layers 2 --d-ff 128 --seq-len 32 --vocab 256 --batch 2
    torchrun --nproc-per-node 4 -m kubeoperator_tpu_torch.train.jobs llm \\
        --device cpu --experts 4 --mesh dp:2,ep:2 --steps 2 --d-model 64 \\
        --heads 4 --layers 2 --d-ff 128 --seq-len 32 --vocab 256 --batch 2
    torchrun --nproc-per-node 2 -m kubeoperator_tpu_torch.train.jobs serve \\
        --device cpu --engine continuous --mesh dp:2 --vocab 128 \\
        --d-model 32 --heads 2 --layers 1 --max-seq-len 64 --no-bf16 \\
        --slots 4 --port 8199
    torchrun --nproc-per-node 2 -m kubeoperator_tpu_torch.train.jobs fsdp \\
        --device cpu --mesh fsdp:2 [--no-overlap]
    torchrun --nproc-per-node 2 -m kubeoperator_tpu_torch.train.jobs \\
        pipeline --device cpu --mesh pp:2
    torchrun --nproc-per-node 2 -m kubeoperator_tpu_torch.train.jobs \\
        resnet50 --device cpu --mesh fsdp:2 --steps 2 --batch-per-chip 2 \\
        --image-size 32 --depth 18 [--ckpt-dir DIR]
    torchrun --nproc-per-node 2 -m kubeoperator_tpu_torch.train.jobs vit \\
        --device cpu --mesh tp:2 --steps 2 --batch-per-chip 2 \\
        --image-size 32 --patch 8 --d-model 64 --heads 4 --layers 2 \\
        --classes 10
    python -m kubeoperator_tpu_torch.train.jobs mnist [--device cpu --steps 6 \\
        --batch 16]
    python -m kubeoperator_tpu_torch.train.jobs llm --steps 10 --sample 16 \\
        [--ckpt-dir DIR --ckpt-every 50] [--metrics-port 8080]
    python -m kubeoperator_tpu_torch.train.jobs llm --device cpu --steps 2 \\
        --d-model 64 --heads 4 --layers 2 --d-ff 128 --seq-len 32 --vocab 256 \\
        [--experts 4 --sample 4]
    python -m kubeoperator_tpu_torch.train.jobs resnet50 --steps 2
    python -m kubeoperator_tpu_torch.train.jobs resnet50 --device cpu \\
        --steps 2 --batch-per-chip 2 --image-size 32 --depth 18
    python -m kubeoperator_tpu_torch.train.jobs vit --steps 2
    python -m kubeoperator_tpu_torch.train.jobs vit --device cpu --steps 2 \\
        --batch-per-chip 2 --image-size 32 --patch 8 --d-model 64 --heads 4 \\
        --layers 2 --classes 10
    python -m kubeoperator_tpu_torch.train.jobs serve --engine continuous
    python -m kubeoperator_tpu_torch.train.jobs serve --device cpu \\
        --vocab 128 --d-model 32 --heads 2 --layers 1 --max-seq-len 64 \\
        --no-bf16 --port 8199 [--engine continuous \\
        [--kv-dtype int8] [--spill-pages 8] \\
        [--spec-k 2 --draft-layers 1 | --moe 4]]

Each record is one JSON line on stdout. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from kubeoperator_tpu_torch.train.launch import maybe_initialize_distributed

def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def aot_record(aot) -> dict | None:
    """The reference's ``aot`` record of a compile-cache consult."""
    if aot is None:
        return None
    return {"hit": aot.hit, "fingerprint": aot.fingerprint,
            "seconds": round(aot.seconds, 4)}


def parse_mesh(arg: str | None, n_devices: int):
    """``dp:auto,tp:4,sp:2`` → MeshSpec; ``auto`` (at most one axis)
    absorbs whatever devices the explicit axes leave over. No ``--mesh``
    is dp over every device."""
    from kubeoperator_tpu_torch.workloads.sharding import AXES, MeshSpec

    if not arg:
        return MeshSpec(dp=n_devices) if n_devices > 1 else MeshSpec()
    sizes: dict[str, int] = {}
    auto_axis = None
    for part in arg.split(","):
        name, _, val = part.strip().partition(":")
        if name not in AXES:
            raise SystemExit(
                f"unknown mesh axis {name!r} (want dp/fsdp/pp/ep/tp/sp)")
        if val == "auto":
            if auto_axis:
                raise SystemExit("only one mesh axis may be 'auto'")
            auto_axis = name
        else:
            sizes[name] = int(val)
    fixed = 1
    for v in sizes.values():
        fixed *= v
    if auto_axis:
        if n_devices % fixed:
            raise SystemExit(f"{n_devices} devices not divisible by fixed "
                             f"axes ({fixed})")
        sizes[auto_axis] = n_devices // fixed
    return MeshSpec(**sizes)


def maybe_start_metrics_server(port: int):
    """Serve the process registry (``telemetry.metrics.REGISTRY``: the
    ``ko_train_*`` and ``ko_serve_*`` families) as Prometheus text on
    ``/metrics``, 404 elsewhere, from a daemon thread, so the job's exit
    never waits on it. ``port <= 0`` disables it. Returns the server, or
    None."""
    if port <= 0:
        return None
    import http.server
    import threading

    from kubeoperator_tpu_torch.telemetry.metrics import REGISTRY

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # noqa: D102 — scrape noise
            pass

    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def settle_phases(trainer, mfu: float | None = None) -> None:
    """After a training loop: wait for the card, count the device seconds
    of the steps' phases that were still in flight, and observe the mean
    step of the phase counters once in the reference's
    ``ko_train_step_seconds`` (``record_train_step``, with ``mfu``), as the
    fsdp and pipeline jobs observe theirs."""
    from kubeoperator_tpu_torch.telemetry.metrics import record_train_step
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    ph = trainer.phases
    ph.flush()
    step_s = ph.mean_step_seconds()
    if step_s is not None:
        record_train_step(ph.workload, step_s, mfu)


def open_checkpoint(args: argparse.Namespace, state: dict, job: str,
                    trainer, lead: bool):
    """The job's ``WorkloadCheckpointer`` under ``--ckpt-dir`` (None
    without one) for the trainer's layout, with ``state`` restored in
    place from its latest checkpoint, if any, announced by ``lead`` as
    ``{"job", "resumed_at"}``."""
    if not args.ckpt_dir:
        return None
    from kubeoperator_tpu_torch.workloads.checkpoint import (
        WorkloadCheckpointer,
    )

    ckpt = WorkloadCheckpointer(args.ckpt_dir, max_to_keep=args.ckpt_keep,
                                mesh=trainer.mesh,
                                placements=trainer.placements)
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        if lead:
            emit({"job": job, "resumed_at": state["step"]})
    return ckpt


def finish_checkpoint(ckpt, state: dict) -> None:
    """Save the last step unless the loop saved it, then close."""
    if ckpt:
        if ckpt.latest_step() != state["step"]:
            ckpt.save(state["step"], state)
        ckpt.close()


def cmd_smoke(args: argparse.Namespace) -> int:
    """Device and collective sanity: a 256×256 bf16 matmul of ones whose
    sum must be 256³ on every rank, and a psum of ones over the ranks
    that must equal their number. Under ``torchrun`` the ranks are the
    group's; a lone process is a world of one."""
    import torch.distributed as dist

    from kubeoperator_tpu_torch.workloads.train import resolve_device

    dist_info = maybe_initialize_distributed(args.device)
    dev = resolve_device(args.device)
    n = dist_info["num_processes"]
    x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
    y = float((x @ x).sum())
    one = torch.ones((), dtype=torch.float32, device=dev)
    if dist.is_initialized():
        dist.all_reduce(one)
    psum = float(one)
    ok = y == 256.0 * 256 * 256 and psum == float(n)
    if dist_info["process_id"] == 0:
        emit({"job": "smoke", "devices": n,
              "device_kind": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else dev.type),
              "platform": "gpu" if dev.type == "cuda" else dev.type,
              "matmul_sum": y, "psum": psum, **dist_info, "ok": ok})
    return 0 if ok else 1


def cmd_mnist(args: argparse.Namespace) -> int:
    """A depth-18 ResNet in f32 on one MNIST-shaped synthetic batch (28²,
    10 classes): the reference's stand-in for the TF-MNIST chart. Exits 1
    unless the last loss is below the first."""
    from kubeoperator_tpu_torch.workloads.train import TrainConfig, Trainer

    args.steps = max(1, args.steps)
    cfg = TrainConfig(batch_size=args.batch, image_size=28, num_classes=10,
                      depth=18, learning_rate=0.05, warmup_steps=5,
                      total_steps=max(args.steps, 6), dtype=torch.float32,
                      stem="conv")
    tr = Trainer(cfg, device=args.device, workload="mnist")
    state = tr.init_state()
    images, labels = tr.synthetic_batch()
    first_loss = None
    for step in range(args.steps):
        state, metrics = tr.train_step(state, images, labels)
        loss = float(metrics["loss"])
        first_loss = first_loss if first_loss is not None else loss
        if step % max(1, args.steps // 10) == 0:
            emit({"job": "mnist", "step": step, "loss": round(loss, 4)})
    settle_phases(tr)
    emit({"job": "mnist", "done": True, "steps": args.steps,
          "first_loss": round(first_loss, 4), "last_loss": round(loss, 4),
          "improved": bool(loss < first_loss)})
    return 0 if loss < first_loss else 1


def cmd_llm(args: argparse.Namespace) -> int:
    """Train the transformer LM (``--experts`` > 0: MoE FFNs) over the
    ``--mesh`` of the ranks (ring or Ulysses attention when sp > 1,
    ``--sp-attention``) for ``--steps`` on a synthetic global batch,
    checkpointing to ``--ckpt-dir`` and resuming from it, then sample
    ``--sample`` tokens from the trained model. The done record carries
    the median step ms after the first step and, on a card, MFU against
    the world's peak."""
    dist_info = maybe_initialize_distributed(args.device)
    lead = dist_info["process_id"] == 0
    if lead:
        maybe_start_metrics_server(args.metrics_port)
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.train import peak_flops_per_chip
    from kubeoperator_tpu_torch.workloads.transformer import (
        Transformer, TransformerConfig, flops_per_token,
    )

    world = dist_info["num_processes"]
    spec = parse_mesh(args.mesh, world)
    cfg = TransformerConfig(vocab_size=args.vocab, d_model=args.d_model,
                            n_heads=args.heads, n_layers=args.layers,
                            d_ff=args.d_ff or int(args.d_model * 8 / 3 / 32) * 32,
                            max_seq_len=args.seq_len,
                            moe_experts=args.experts,
                            sp_attention=args.sp_attention,
                            dtype=torch.bfloat16 if args.bf16 else torch.float32)
    lt = LMTrainer(cfg, spec, device=args.device)
    state = lt.init_state()
    ckpt = open_checkpoint(args, state, "llm", lt, lead)
    batch = args.batch or max(1, spec.dp * spec.fsdp)
    tokens = lt.synthetic_batch(batch, args.seq_len)
    times = []
    while state["step"] < args.steps:
        t0 = time.perf_counter()
        state, metrics = lt.train_step(state, tokens)
        loss = float(metrics["loss"])          # fences the step
        times.append(time.perf_counter() - t0)
        step = state["step"]
        if ckpt and args.ckpt_every and step % args.ckpt_every == 0:
            ckpt.save(step, state)
        if lead and (step % max(1, args.steps // 10) == 0
                     or step == args.steps):
            emit({"job": "llm", "step": step, "loss": round(loss, 4)})
    step_s = statistics.median(times[1:] or times) if times else None
    mfu = None
    if step_s and lt.device.type == "cuda":
        mfu = (3 * flops_per_token(cfg, args.seq_len) * batch * args.seq_len
               / step_s / (peak_flops_per_chip(lt.device) * world))
    settle_phases(lt, mfu)
    finish_checkpoint(ckpt, state)
    model = state["model"]
    if args.sample > 0 and spec.n_devices > 1:
        # every rank gathers the shards; rank 0 samples on one device
        whole = lt.full_params(model)
        with torch.device(lt.device):
            model = Transformer(cfg)
        model.load_state_dict(whole)
    if args.sample > 0 and lead:
        # decode path smoke: KV-cached generation from the trained params
        sampled = generate(cfg, model, tokens[:1, :4],
                           max_new_tokens=min(args.sample, cfg.max_seq_len - 4),
                           temperature=0.8, device=lt.device)
        emit({"job": "llm", "sampled_tokens": sampled[0].tolist()})
    if lead:
        emit({"job": "llm", "done": True, "steps": state["step"],
              "chips": world, "mesh": dict(spec.sizes()),
              "device": str(lt.device), "seq_len": args.seq_len,
              "batch": batch,
              "step_time_ms": step_s * 1e3 if step_s else None,
              "mfu": mfu, **dist_info})
    return 0


def cmd_resnet50(args: argparse.Namespace) -> int:
    """Distributed ResNet classification (dp×fsdp over ``--mesh``) for
    ``--steps`` on the synthetic image stream or ``--data-dir``, each rank
    its block of the global batch, copied to the device with prefetch,
    checkpointing to ``--ckpt-dir`` and resuming from it (step count and
    data stream continue). The config is the JAX job's: ``TrainConfig``
    defaults (so no K7/K8 backward), the s2d stem for even images of at
    least 64, warmup min(100, steps)."""
    dist_info = maybe_initialize_distributed(args.device)
    lead = dist_info["process_id"] == 0
    if lead:
        maybe_start_metrics_server(args.metrics_port)
    from kubeoperator_tpu_torch.workloads import data as data_pipe
    from kubeoperator_tpu_torch.workloads.sharding import batch_index
    from kubeoperator_tpu_torch.workloads.train import TrainConfig, Trainer

    world = dist_info["num_processes"]
    spec = parse_mesh(args.mesh, world)
    s2d_ok = args.image_size >= 64 and args.image_size % 2 == 0
    cfg = TrainConfig(batch_size=args.batch_per_chip * world,
                      image_size=args.image_size, depth=args.depth,
                      total_steps=args.steps,
                      warmup_steps=min(100, args.steps),
                      stem="space_to_depth" if s2d_ok else "conv")
    tr = Trainer(cfg, spec, device=args.device)
    state = tr.init_state()
    ckpt = open_checkpoint(args, state, "resnet50", tr, lead)
    start = state["step"]
    block, blocks = batch_index(tr.mesh)
    local = cfg.batch_size // blocks
    if args.data_dir:
        source = data_pipe.NpyDataset(args.data_dir).batches(
            local, seed=0, shard_id=block, num_shards=blocks,
            skip_batches=start)
    else:
        source = data_pipe.synthetic_image_batches(
            local, cfg.image_size, cfg.num_classes, seed=block,
            steps=args.steps - start, start=start)
    t0 = time.perf_counter()
    for images, labels in data_pipe.prefetch_to_device(source, tr.device):
        if state["step"] >= args.steps:
            break
        state, metrics = tr.train_step(state, images, labels)
        step = state["step"]
        if ckpt and args.ckpt_every and step % args.ckpt_every == 0:
            ckpt.save(step, state)
        if lead and (step % max(1, args.steps // 10) == 0
                     or step == args.steps):
            emit({"job": "resnet50", "step": step,
                  "loss": round(float(metrics["loss"]), 4)})
    dt = time.perf_counter() - t0
    img_s = cfg.batch_size * (state["step"] - start) / dt if dt > 0 else 0.0
    settle_phases(tr)
    finish_checkpoint(ckpt, state)
    if lead:
        emit({"job": "resnet50", "done": True, "steps": state["step"],
              "chips": world, "mesh": dict(spec.sizes()),
              "device": str(tr.device), "img_per_sec": round(img_s, 1),
              "img_per_sec_per_chip": round(img_s / world, 1), **dist_info})
    return 0


def cmd_vit(args: argparse.Namespace) -> int:
    """Vision Transformer classification over ``--mesh`` for ``--steps``
    on the synthetic image stream, each rank its block of the global batch
    (tp and sp ranks of one block the same rows), copied to the device
    with prefetch. The encoder is built as the JAX job builds it:
    ``TransformerConfig`` defaults (attention ``auto``, remat ``dots``)
    with d_ff = 4·d_model, non-causal; at 196 patches ``auto`` takes the
    dense attention path."""
    dist_info = maybe_initialize_distributed(args.device)
    lead = dist_info["process_id"] == 0
    if lead:
        maybe_start_metrics_server(args.metrics_port)
    from kubeoperator_tpu_torch.workloads.data import (
        prefetch_to_device, synthetic_image_batches,
    )
    from kubeoperator_tpu_torch.workloads.sharding import batch_index
    from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer

    enc = TransformerConfig(
        d_model=args.d_model, n_heads=args.heads, n_layers=args.layers,
        d_ff=args.d_model * 4, causal=False,
        max_seq_len=(args.image_size // args.patch) ** 2)
    cfg = ViTConfig(num_classes=args.classes, image_size=args.image_size,
                    patch=args.patch, encoder=enc)
    world = dist_info["num_processes"]
    spec = parse_mesh(args.mesh, world)
    tr = ViTTrainer(cfg, spec, device=args.device)
    state = tr.init_state()
    batch = args.batch_per_chip * world
    block, blocks = batch_index(tr.mesh)
    source = synthetic_image_batches(batch // blocks, args.image_size,
                                     args.classes, seed=block,
                                     steps=args.steps)
    t0 = time.perf_counter()
    for images, labels in prefetch_to_device(source, tr.device):
        state, metrics = tr.train_step(state, images, labels)
        step = state["step"]
        if lead and (step % max(1, args.steps // 5) == 0
                     or step == args.steps):
            emit({"job": "vit", "step": step,
                  "loss": round(float(metrics["loss"]), 4)})
    dt = time.perf_counter() - t0
    img_s = batch * args.steps / dt
    settle_phases(tr)
    if lead:
        emit({"job": "vit", "done": True, "steps": args.steps,
              "chips": world, "mesh": dict(spec.sizes()),
              "device": str(tr.device), "img_per_sec": round(img_s, 1),
              "img_per_sec_per_chip": round(img_s / world, 1), **dist_info})
    return 0


def build_server(args: argparse.Namespace):
    """The serve job up to the point where it listens: the model (the llm
    job's latest checkpoint under ``--ckpt-dir``, else fresh weights from
    ``--seed``), the engine and its batcher (its stats on the process
    ``REGISTRY``), warm-up, and a
    ``ThreadingHTTPServer`` bound to ``--host``/``--port`` (port 0 takes a
    free one). Returns ``(server, batcher)``; the caller runs
    ``server.serve_forever()`` and ends it with ``server.shutdown()``.

    Routes: ``GET /healthz``, ``GET /stats`` (``BatcherStats.snapshot``),
    ``GET /metrics`` (Prometheus text) and ``POST /generate``
    ``{"prompt_ids": [...], "max_tokens": N, "temperature": T, "seed": S}``
    -> ``{"tokens": [...], "new_tokens": [...]}``; a bad body answers 400,
    a timeout 503 and an engine failure 500.

    The continuous engine's batcher traces every request into the
    process ring ``telemetry.serve_trace.SERVE_TRACES`` (span cap
    ``KO_TRACE_MAX_SPANS``, default 4,000); no route serves the ring.

    ``--mesh`` (``--engine continuous`` only) serves from the ranks of a
    ``torchrun`` group: every rank builds the model and the engine over
    the mesh; rank 0 drives it through an ``EngineLeader`` and serves
    HTTP, and every other rank runs ``follow`` here, returning
    ``(None, None)`` when rank 0's leader stops."""
    import http.server

    from kubeoperator_tpu_torch.telemetry.metrics import REGISTRY
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.serving import (
        BatcherStats, ContinuousBatcher, DynamicBatcher, _pow2_at_least,
        plan_bucket,
    )
    from kubeoperator_tpu_torch.workloads.train import resolve_device
    from kubeoperator_tpu_torch.workloads.transformer import (
        Transformer, TransformerConfig,
    )

    spec, lead = None, True
    if args.mesh:
        if args.engine != "continuous":
            raise SystemExit("--mesh requires --engine continuous (the "
                             "dynamic engine is single-device)")
        dist_info = maybe_initialize_distributed(args.device)
        spec = parse_mesh(args.mesh, dist_info["num_processes"])
        lead = dist_info["process_id"] == 0
    dev = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers,
        # the llm job's SwiGLU recipe, so a trained model's shapes match
        d_ff=args.d_ff or int(args.d_model * 8 / 3 / 32) * 32,
        max_seq_len=args.max_seq_len, moe_experts=args.moe,
        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    with torch.device(dev):
        model = Transformer(cfg)
    weights = "fresh-init (no checkpoint)"
    if args.ckpt_dir:
        from kubeoperator_tpu_torch.workloads.checkpoint import (
            WorkloadCheckpointer,
        )

        # the llm job wrote its full trainer state: only the model's
        # weights are read, the AdamW moments stay on disk
        ckpt = WorkloadCheckpointer(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            weights = f"checkpoint step {ckpt.restore_model(model)}"
        ckpt.close()
    if weights.startswith("fresh"):
        model.reset_parameters(args.seed)
    model.eval()
    if lead:
        emit({"job": "serve", "weights": weights, "device": str(dev)})
    # both engines report into the process registry: one /metrics scrape
    # covers the serve plane and the train plane
    stats = BatcherStats(registry=REGISTRY)

    if args.engine == "continuous":
        from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine

        from kubeoperator_tpu_torch.workloads.decode_loop import (
            EngineLeader, follow,
        )

        # --aot-cache: bring-up consults the compile cache, as the
        # reference's engine does (the pool builds no kernel library)
        compile_cache = None
        if args.aot_cache:
            from kubeoperator_tpu_torch.aot import CompileCache

            compile_cache = CompileCache(args.aot_cache)
        try:
            engine = SlotPoolEngine(cfg, model, slots=args.slots,
                                    segment=args.segment, page=args.page,
                                    pages=args.pages,
                                    kv_dtype=args.kv_dtype,
                                    spill_pages=args.spill_pages,
                                    spec_k=args.spec_k,
                                    draft_layers=args.draft_layers,
                                    mesh_spec=spec,
                                    compile_cache=compile_cache, device=dev)
        except ValueError as e:
            raise SystemExit(f"serve: {e}") from e
        if engine.control is not None:
            if not lead:
                follow(engine)
                return None, None
            engine = EngineLeader(engine)
        # per-request span trees into the process ring, as the reference's
        # serve job wires them; the span cap is the reference's config key
        # trace_max_spans, read from KO_TRACE_MAX_SPANS alone (the
        # reference also layers a KO_CONFIG YAML file under the
        # environment; the port reads no YAML)
        from kubeoperator_tpu_torch.telemetry.serve_trace import ServeTracer

        tracer = ServeTracer(max_spans=int(os.environ.get(
            "KO_TRACE_MAX_SPANS", 4000)))
        batcher = ContinuousBatcher(engine, stats=stats, tracer=tracer)
        emit({"job": "serve", "engine": "continuous", "slots": args.slots,
              "segment": args.segment, "page": engine.page,
              "pages": engine.pages, "kv_dtype": engine.kv_dtype,
              "spill_pages": engine.spill_pages, "spec_k": engine.spec_k,
              "draft_layers": engine.draft_layers, "moe": cfg.moe_experts,
              "mesh": (dict(engine.spec.sizes())
                       if engine.spec is not None else None),
              "aot": aot_record(engine.aot)})
        # every request shape shares the one segment path, so an
        # empty-pool segment is the whole warm-up; --warm is moot here
        engine.run_segment()
    else:
        def run_batch(prompts, lens, max_new, temp, prefill, seed):
            b = _pow2_at_least(len(prompts))
            # pad the batch to its bucket with duplicate rows (the batcher
            # never reads them)
            rows = prompts + [prompts[0]] * (b - len(prompts))
            row_lens = lens + [lens[0]] * (b - len(lens))
            return generate(cfg, model, rows, max_new, temperature=temp,
                            seed=seed, prompt_lens=row_lens,
                            prefill_len=prefill, device=dev).cpu().numpy()

        batcher = DynamicBatcher(run_batch, max_batch=args.max_batch,
                                 window_ms=args.batch_window_ms,
                                 max_seq_len=cfg.max_seq_len, stats=stats)
        emit({"job": "serve", "engine": "dynamic"})
        run_batch([[0] * 8], [8], 4, 0.0, 8, 0)
        # run each expected bucket once before readiness, bucketed exactly
        # as the batcher buckets real traffic (plan_bucket)
        for spec in (args.warm.split(",") if args.warm else []):
            b, p_raw, n_raw = parse_warm(spec)
            b = _pow2_at_least(b)
            p, n, prefill = plan_bucket([p_raw] * b, [n_raw] * b,
                                        cfg.max_seq_len)
            emit({"job": "serve",
                  "warming": f"{b}x{p}x{n} prefill={prefill}"})
            run_batch([[0] * p] * b, [p_raw] * b, n, 0.0, prefill, 0)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # noqa: N802 — quiet access log
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict) -> None:
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "model": {
                    "d_model": cfg.d_model, "layers": cfg.n_layers,
                    "vocab": cfg.vocab_size, "max_seq_len": cfg.max_seq_len}})
            elif self.path == "/metrics":
                self._send(200, batcher.stats.prometheus().encode(),
                           "text/plain; version=0.0.4")
            elif self.path == "/stats":
                self._json(200, batcher.stats.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/generate":
                return self._json(404, {"error": "not found"})
            try:
                req = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                prompt_ids = [int(t) for t in req["prompt_ids"]]
                if not all(0 <= t < cfg.vocab_size for t in prompt_ids):
                    raise ValueError(f"prompt_ids must lie in "
                                     f"[0, {cfg.vocab_size})")
                # concurrent requests share the device through the
                # batcher; this thread blocks until its row is ready
                tokens = batcher.submit(
                    prompt_ids, int(req.get("max_tokens", 16)),
                    temperature=float(req.get("temperature", 0.0)),
                    seed=int(req.get("seed", 0)))
                self._json(200, {"tokens": tokens,
                                 "new_tokens": tokens[len(prompt_ids):]})
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
            except TimeoutError as e:
                self._json(503, {"error": f"generation timed out: {e}"})
            except Exception as e:  # noqa: BLE001 — worker errors -> JSON
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    # threading server: /healthz must answer while a long /generate waits
    server = http.server.ThreadingHTTPServer((args.host, args.port), Handler)
    return server, batcher


def parse_warm(spec: str) -> tuple[int, int, int]:
    """One ``--warm`` element, ``BxPxN`` (batch, prompt length, new
    tokens, each a positive integer). Anything else exits naming the
    element: the reference's unpacking raised a bare ``ValueError``."""
    parts = [p.strip() for p in spec.lower().split("x")]
    if len(parts) != 3 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise SystemExit(f"serve: --warm element {spec!r} is not BxPxN "
                         f"(batch x prompt length x new tokens, e.g. "
                         f"'8x128x64')")
    b, p, n = (int(x) for x in parts)
    return b, p, n


def cmd_serve(args: argparse.Namespace) -> int:
    """Token-generation HTTP endpoint (the jax-serve chart's entry point):
    ``build_server``, then serve until interrupted; on a serving mesh,
    rank 0 then stops the other ranks, which return once it has."""
    server, batcher = build_server(args)
    if server is None:              # a follower of the serving mesh
        return 0
    host, port = server.server_address[:2]
    emit({"job": "serve", "listening": f"{host}:{port}"})
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if hasattr(batcher.engine, "stop"):
            batcher.engine.stop()
    return 0


def mlp_lm(args: argparse.Namespace, n_stages: int, dev: torch.device):
    """The fsdp and pipeline jobs' MLP LM from ``--seed``: embedding [V, d]
    and head [d, V], and ``n_stages`` residual tanh MLPs {w1, w2} [d, d],
    all N(0, 0.1²) from one CPU generator, so every rank draws the same
    weights. Returns (embed, stages, head, ``pipeline.MLP_FNS``)."""
    d, vocab = args.d_model, args.vocab
    gen = torch.Generator().manual_seed(args.seed)

    def draw(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).to(dev)

    embed = draw(vocab, d)
    stages = [{"w1": draw(d, d), "w2": draw(d, d)} for _ in range(n_stages)]
    head = draw(d, vocab)
    from kubeoperator_tpu_torch.workloads.pipeline import MLP_FNS

    return embed, stages, head, MLP_FNS


def synthetic_ids(batch: int, vocab: int, seed: int,
                  dev: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (batch,), generator=gen).to(dev)


def sgd_step(loss_fn, params: dict, x, y, lr: float) -> torch.Tensor:
    """loss and one plain SGD step on every leaf of ``params`` in place."""
    leaves = [v for v in params.values() if isinstance(v, torch.Tensor)] + [
        w for v in params.values() if isinstance(v, dict)
        for w in v.values()]
    loss = loss_fn(params, x, y)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(lr * g)
    return loss.detach()


def cmd_fsdp(args: argparse.Namespace) -> int:
    """Chunked ZeRO-3 MLP LM over an fsdp (or dp×fsdp) mesh with the
    latency-hiding schedule (``sharding.fsdp_overlapped_loss_fn``): the
    gather of layer i+1's chunk is issued before layer i's compute.
    ``--no-overlap`` gathers each chunk in the tick that uses it. On a
    card the done record carries MFU and a collective-time attribution:
    the cost model's shares (``costmodel.fsdp_step_model`` with the card's
    NVLink) scaled onto the measured step, or the NCCL kernels' device
    time from the profiler when it traces any. Records ``ko_train_*``."""
    dist_info = maybe_initialize_distributed(args.device)
    lead = dist_info["process_id"] == 0
    if lead:
        maybe_start_metrics_server(args.metrics_port)
    from kubeoperator_tpu_torch.telemetry.metrics import record_train_step
    from kubeoperator_tpu_torch.workloads import costmodel
    from kubeoperator_tpu_torch.workloads.sharding import (
        build_mesh, fsdp_overlapped_loss_fn, fsdp_overlapped_shardings,
        pack_stages, shard_tensor,
    )
    from kubeoperator_tpu_torch.workloads.train import (
        peak_flops_per_chip, resolve_device,
    )

    world = dist_info["num_processes"]
    spec = parse_mesh(args.mesh or f"fsdp:{world}", world)
    if spec.fsdp < 2:
        raise SystemExit("the fsdp job needs an fsdp axis >= 2 "
                         "(e.g. --mesh dp:2,fsdp:4)")
    dev = resolve_device(args.device)
    mesh = build_mesh(spec, dev.type)
    d, vocab = args.d_model, args.vocab
    embed, stages, head, fns = mlp_lm(args, args.layers, dev)
    stacked, unpack = pack_stages(stages, multiple=spec.fsdp)
    shd = fsdp_overlapped_shardings(mesh)
    params = {"embed": embed.requires_grad_(),
              "stages": shard_tensor(stacked, shd["stages"],
                                     mesh).requires_grad_(),
              "head": head.requires_grad_()}
    loss_fn = fsdp_overlapped_loss_fn(mesh, unpack=unpack,
                                      prefetch=not args.no_overlap, **fns)
    batch = args.batch or 8 * max(1, spec.dp * spec.fsdp)
    x = synthetic_ids(batch, vocab, 1, dev)
    y = synthetic_ids(batch, vocab, 2, dev)
    # --aot-cache: the step consults the compile cache, as the reference's
    # does; the MLP launches no kernel library, so nothing is built
    if args.aot_cache:
        from kubeoperator_tpu_torch.aot import CompileCache

        aot = CompileCache(args.aot_cache).consult("step_fn", [],
                                                   mesh_spec=spec)
        if lead:
            emit({"job": "fsdp", "aot": aot_record(aot)})
    times: list[float] = []
    total = args.warmup + args.steps
    for i in range(total):
        t0 = time.perf_counter()
        loss = float(sgd_step(loss_fn, params, x, y, args.lr))
        if i >= args.warmup:
            times.append(time.perf_counter() - t0)
        if lead and (i + 1) % max(1, total // 5) == 0:
            emit({"job": "fsdp", "step": i + 1, "loss": round(loss, 4)})
    step_s = sum(times) / len(times)
    record = {"job": "fsdp", "done": True, "mesh": dict(spec.sizes()),
              "layers": args.layers, "overlap": not args.no_overlap,
              "step_time_s": round(step_s, 6), "loss": round(loss, 4)}
    if dev.type == "cuda":
        peak = peak_flops_per_chip(dev)
        local_batch = batch // (spec.dp * spec.fsdp)
        model = costmodel.fsdp_step_model(
            n_layers=args.layers, layer_param_bytes=4.0 * stacked.shape[1],
            fwd_flops_per_layer=4.0 * local_batch * d * d,
            n_fsdp=spec.fsdp, peak_flops=peak,
            link=costmodel.link_for(torch.cuda.get_device_name(dev)),
            overlap=not args.no_overlap)
        att = costmodel.attribute(step_s, model)
        prof = costmodel.profiled_collective_seconds(loss_fn, params, x, y)
        if prof is not None:
            att.collective_s, att.source = prof, "profiler"
        mfu = 3 * (args.layers * 4 * batch * d * d
                   + 2 * batch * d * vocab) / (peak * world * step_s)
        record |= {"mfu": round(mfu, 6), **att.as_dict()}
        record_train_step("fsdp", step_s, mfu, att.collective_s)
    else:
        # the CPU has no device time or peak to attribute against
        record |= {"mfu": None, "attribution_source": None}
        record_train_step("fsdp", step_s)
    if lead:
        emit({**record, **dist_info})
    return 0


def cmd_pipeline(args: argparse.Namespace) -> int:
    """Device-pipelined MLP LM over a ``pp`` mesh axis (GPipe fill/drain,
    ``pipeline.gpipe_loss_fn``), composing with dp: ``--mesh dp:2,pp:4``.
    Each rank holds its stage. Records ``ko_train_*``."""
    dist_info = maybe_initialize_distributed(args.device)
    lead = dist_info["process_id"] == 0
    if lead:
        maybe_start_metrics_server(args.metrics_port)
    from kubeoperator_tpu_torch.telemetry.metrics import record_train_step
    from kubeoperator_tpu_torch.workloads import pipeline as pipe
    from kubeoperator_tpu_torch.workloads.sharding import (
        axis_index, build_mesh,
    )
    from kubeoperator_tpu_torch.workloads.train import resolve_device

    world = dist_info["num_processes"]
    spec = parse_mesh(args.mesh or f"pp:{world}", world)
    if spec.pp < 2:
        raise SystemExit("the pipeline job needs a pp axis >= 2 "
                         "(e.g. --mesh dp:2,pp:4); for the scan-over-"
                         "stages stance use the llm job instead")
    dev = resolve_device(args.device)
    mesh = build_mesh(spec, dev.type)
    embed, stages, head, fns = mlp_lm(args, spec.pp, dev)
    mine = stages[axis_index(mesh, "pp")]
    params = {"embed": embed.requires_grad_(),
              "stages": {k: v.requires_grad_() for k, v in mine.items()},
              "head": head.requires_grad_()}
    loss_fn = pipe.gpipe_loss_fn(mesh, n_micro=args.microbatches, **fns)
    batch = args.batch or args.microbatches * max(1, spec.dp * spec.fsdp)
    x = synthetic_ids(batch, args.vocab, 1, dev)
    y = synthetic_ids(batch, args.vocab, 2, dev)
    times = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss = float(sgd_step(loss_fn, params, x, y, args.lr))
        times.append(time.perf_counter() - t0)
        if lead and (i + 1) % max(1, args.steps // 5) == 0:
            emit({"job": "pipeline", "step": i + 1, "loss": round(loss, 4)})
    # drop the first steps (allocator and NCCL set-up) when there are
    # enough to spare
    measured = times[min(2, len(times) - 1):]
    step_s = sum(measured) / len(measured)
    record_train_step("pipeline", step_s)
    if lead:
        emit({"job": "pipeline", "done": True, "mesh": dict(spec.sizes()),
              "stages": spec.pp, "microbatches": args.microbatches,
              "step_time_s": round(step_s, 6), "loss": round(loss, 4),
              "bubble_fraction": round(
                  pipe.bubble_fraction(spec.pp, args.microbatches), 3),
              **dist_info})
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubeoperator_tpu_torch.train.jobs",
                                description="PyTorch port workload jobs")
    sub = p.add_subparsers(dest="cmd", required=True)
    sm = sub.add_parser("smoke", help="device + collective sanity check")
    sm.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")

    mn = sub.add_parser("mnist", help="small convnet on synthetic MNIST "
                                      "shapes")
    mn.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    mn.add_argument("--steps", type=int, default=30)
    mn.add_argument("--batch", type=int, default=128)

    lm = sub.add_parser("llm", help="transformer LM (ring or Ulysses "
                                    "attention for long context)")
    lm.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    lm.add_argument("--metrics-port", type=int, default=0,
                    help=">0: serve ko_train_* prometheus text on this port")
    lm.add_argument("--steps", type=int, default=100)
    lm.add_argument("--seq-len", type=int, default=2048)
    lm.add_argument("--batch", type=int, default=None)
    lm.add_argument("--vocab", type=int, default=32_000)
    lm.add_argument("--d-model", type=int, default=512)
    lm.add_argument("--heads", type=int, default=8)
    lm.add_argument("--layers", type=int, default=4)
    lm.add_argument("--d-ff", type=int, default=None)
    lm.add_argument("--experts", type=int, default=0,
                    help=">0 enables MoE FFNs of that many experts (top-2, "
                         "capacity factor 1.25)")
    lm.add_argument("--sample", type=int, default=0,
                    help=">0: generate this many tokens after training "
                         "(KV-cached decode smoke)")
    lm.add_argument("--sp-attention", choices=("ring", "ulysses"),
                    default="ring",
                    help="sequence-parallel attention: ring (ppermute K/V) "
                         "or ulysses (all-to-all seq<->heads)")
    lm.add_argument("--bf16", action="store_true", default=True)
    lm.add_argument("--no-bf16", dest="bf16", action="store_false")
    lm.add_argument("--mesh", type=str, default=None,
                    help="e.g. dp:auto,tp:2 or dp:2,tp:2,sp:2 (default dp "
                         "over every rank)")
    lm.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint here every --ckpt-every steps and at "
                         "the end; resume from the latest on restart (any "
                         "mesh)")
    lm.add_argument("--ckpt-every", type=int, default=50)
    lm.add_argument("--ckpt-keep", type=int, default=3)

    rn = sub.add_parser("resnet50", help="ResNet classification over a "
                                         "dp×fsdp mesh")
    rn.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    rn.add_argument("--metrics-port", type=int, default=0,
                    help=">0: serve ko_train_* prometheus text on this port")
    rn.add_argument("--steps", type=int, default=200)
    rn.add_argument("--batch-per-chip", type=int, default=256)
    rn.add_argument("--image-size", type=int, default=224)
    rn.add_argument("--depth", type=int, default=50,
                    help="ResNet depth (18/34/50/101/152)")
    rn.add_argument("--mesh", type=str, default=None,
                    help="dp and fsdp, e.g. fsdp:auto or dp:2,fsdp:4 "
                         "(default dp over every rank)")
    rn.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint here every --ckpt-every steps and at "
                         "the end; resume from the latest on restart (any "
                         "mesh)")
    rn.add_argument("--ckpt-every", type=int, default=50)
    rn.add_argument("--ckpt-keep", type=int, default=3)
    rn.add_argument("--data-dir", type=str, default=None,
                    help="npy dataset dir (images.npy+labels.npy); "
                         "default: synthetic stream")

    vt = sub.add_parser("vit", help="Vision Transformer classification "
                                    "over a dp×fsdp×tp×sp mesh")
    vt.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    vt.add_argument("--metrics-port", type=int, default=0,
                    help=">0: serve ko_train_* prometheus text on this port")
    vt.add_argument("--steps", type=int, default=50)
    vt.add_argument("--batch-per-chip", type=int, default=64)
    vt.add_argument("--image-size", type=int, default=224)
    vt.add_argument("--patch", type=int, default=16)
    vt.add_argument("--d-model", type=int, default=768)
    vt.add_argument("--heads", type=int, default=12)
    vt.add_argument("--layers", type=int, default=12)
    vt.add_argument("--classes", type=int, default=1000)
    vt.add_argument("--mesh", type=str, default=None,
                    help="e.g. dp:auto,tp:2 (default dp over every rank)")

    sv = sub.add_parser("serve", help="KV-cached generation HTTP endpoint "
                                      "(one device)")
    sv.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=8080)
    sv.add_argument("--vocab", type=int, default=32_000)
    sv.add_argument("--d-model", type=int, default=512)
    sv.add_argument("--heads", type=int, default=8)
    sv.add_argument("--layers", type=int, default=4)
    sv.add_argument("--d-ff", type=int, default=None)
    sv.add_argument("--max-seq-len", type=int, default=2048)
    sv.add_argument("--ckpt-dir", type=str, default=None,
                    help="serve the llm job's latest checkpoint here "
                         "(fresh weights from --seed without one)")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--bf16", action="store_true", default=True)
    sv.add_argument("--no-bf16", dest="bf16", action="store_false")
    sv.add_argument("--warm", default="",
                    help="dynamic engine: run these decode buckets once "
                         "before serving, comma-separated BxPxN triples "
                         "(e.g. '8x128x64,32x128x64')")
    sv.add_argument("--max-batch", type=int, default=32,
                    help="dynamic batcher: max fused requests per step")
    sv.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="dynamic batcher: wait after first request")
    sv.add_argument("--engine", choices=("dynamic", "continuous"),
                    default="dynamic",
                    help="batching engine: run-to-completion fusion "
                         "(dynamic) or slot-pool continuous batching")
    sv.add_argument("--slots", type=int, default=16,
                    help="continuous engine: persistent decode slots")
    sv.add_argument("--segment", type=int, default=8,
                    help="continuous engine: tokens per segment")
    sv.add_argument("--mesh", type=str, default=None,
                    help="continuous engine under torchrun: slots and "
                         "pages over dp, heads over tp, MoE experts over "
                         "ep (e.g. dp:auto or dp:2,tp:2 or dp:2,ep:2)")
    sv.add_argument("--page", type=int, default=None,
                    help="continuous engine: tokens per KV-cache page "
                         "(power of two dividing max_seq_len; default "
                         "min(16, max_seq_len) rounded down)")
    sv.add_argument("--pages", type=int, default=None,
                    help="continuous engine: total KV pages, the admission "
                         "limiter (default slots * max_seq_len/page + one "
                         "trash page a dp shard)")
    sv.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                    help="continuous engine: KV page-pool element type — "
                         "int8 stores quantized codes with per-(page, "
                         "offset, head) scales (~2x pages at equal memory; "
                         "greedy logits within 0.25 of bf16)")
    sv.add_argument("--spec-k", type=int, default=0,
                    help="continuous engine: speculative decoding — draft K "
                         "tokens a dispatch with the model's own first "
                         "--draft-layers layers, verify them in one K-wide "
                         "pass (0 disables)")
    sv.add_argument("--draft-layers", type=int, default=0,
                    help="continuous engine with --spec-k: how many leading "
                         "layers form the draft (>= 1, < --layers)")
    sv.add_argument("--moe", type=int, default=0,
                    help="serve a mixture-of-experts model: experts per "
                         "layer (0 = dense FFN); not with --spec-k")
    sv.add_argument("--spill-pages", type=int, default=0,
                    help="continuous engine: host-RAM prefix-cache spill "
                         "tier bound, in KV pages — cold prefix entries "
                         "demote here at LRU eviction and a later hit "
                         "promotes them back instead of recomputing "
                         "(0 disables)")
    sv.add_argument("--aot-cache", type=str, default=None,
                    help="continuous engine: compile-cache directory "
                         "consulted at bring-up (python -m "
                         "kubeoperator_tpu_torch.aot warm pre-builds it)")

    fs = sub.add_parser("fsdp", help="chunked ZeRO-3 training with "
                                     "gather/compute overlap")
    fs.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    fs.add_argument("--mesh", help="e.g. fsdp:8 or dp:2,fsdp:4 "
                                   "(default fsdp:<all ranks>)")
    fs.add_argument("--steps", type=int, default=10,
                    help="measured steps (after --warmup)")
    fs.add_argument("--warmup", type=int, default=2)
    fs.add_argument("--batch", type=int, default=0)
    fs.add_argument("--layers", type=int, default=4)
    fs.add_argument("--d-model", type=int, default=64)
    fs.add_argument("--vocab", type=int, default=256)
    fs.add_argument("--lr", type=float, default=0.1)
    fs.add_argument("--seed", type=int, default=0)
    fs.add_argument("--metrics-port", type=int, default=0,
                    help=">0: serve ko_train_* prometheus text on this port")
    fs.add_argument("--no-overlap", action="store_true",
                    help="gather each layer chunk in the tick that uses it "
                         "(the A/B baseline schedule)")
    fs.add_argument("--aot-cache", type=str, default=None,
                    help="compile-cache directory consulted before the "
                         "first step")

    pp = sub.add_parser("pipeline",
                        help="device-pipelined training over a pp mesh axis")
    pp.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    pp.add_argument("--mesh", help="e.g. dp:2,pp:4 (default pp:<all ranks>)")
    pp.add_argument("--steps", type=int, default=10)
    pp.add_argument("--batch", type=int, default=0)
    pp.add_argument("--microbatches", type=int, default=4)
    pp.add_argument("--d-model", type=int, default=64)
    pp.add_argument("--vocab", type=int, default=256)
    pp.add_argument("--lr", type=float, default=0.1)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--metrics-port", type=int, default=0,
                    help=">0: serve ko_train_* prometheus text on this port")
    return p


COMMANDS = {"smoke": cmd_smoke, "mnist": cmd_mnist, "llm": cmd_llm,
            "resnet50": cmd_resnet50, "vit": cmd_vit, "serve": cmd_serve,
            "fsdp": cmd_fsdp, "pipeline": cmd_pipeline}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
