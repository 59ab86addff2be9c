"""Job entry points of the PyTorch port: ``llm`` (train the transformer
LM, then optionally sample from it), ``resnet50`` (train a ResNet on a
synthetic image stream or an ``.npy`` dataset), ``vit`` (train the
Vision Transformer classifier on a synthetic image stream) and ``serve``
(the token-generation HTTP endpoint). The counterparts of ``cmd_llm``,
``cmd_resnet50``, ``cmd_vit`` and ``cmd_serve`` in
``kubeoperator_tpu/train/jobs.py``, with the same flags plus ``--device``.

    python -m kubeoperator_tpu_torch.train.jobs llm --steps 10 --sample 16
    python -m kubeoperator_tpu_torch.train.jobs llm --device cpu --steps 2 \\
        --d-model 64 --heads 4 --layers 2 --d-ff 128 --seq-len 32 --vocab 256
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
        --no-bf16 --port 8199 [--engine continuous]

Each record is one JSON line on stdout. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# flags of the JAX command whose non-default values need a part of the
# system this port does not have yet, and where the ROADMAP queues it
NOT_PORTED = {
    "mesh": (None, "multi-device meshes (ROADMAP queue 1, multi-device)"),
    "experts": (0, "MoE FFNs (ROADMAP queue 1, MoE)"),
    "sp_attention": ("ring", "sequence-parallel attention (ROADMAP queue 1, "
                             "multi-device)"),
    "ckpt_dir": (None, "checkpointing (ROADMAP queue 1, checkpoint)"),
    "metrics_port": (0, "the ko_train_* metrics server (ROADMAP queue 1, "
                        "serving and jobs)"),
    "kv_dtype": ("bf16", "quantized KV pages (ROADMAP queue 1, item 7)"),
    "spill_pages": (0, "the host spill tier (ROADMAP queue 1, item 7)"),
    "spec_k": (0, "speculative decoding (ROADMAP queue 1, item 9)"),
    "draft_layers": (0, "speculative decoding (ROADMAP queue 1, item 9)"),
    "moe": (0, "MoE serving (ROADMAP queue 1, item 9)"),
    "aot_cache": (None, "the AOT compile cache (ROADMAP queue 1, item 15)"),
}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise for a flag of ``NOT_PORTED`` that the command has and that is
    set away from its default."""
    for flag, (default, what) in NOT_PORTED.items():
        if getattr(args, flag, default) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: {what}")


def cmd_llm(args: argparse.Namespace) -> int:
    """Train the transformer LM for ``--steps`` on a synthetic batch, then
    sample ``--sample`` tokens from the trained model."""
    refuse_unported(args)
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig

    cfg = TransformerConfig(vocab_size=args.vocab, d_model=args.d_model,
                            n_heads=args.heads, n_layers=args.layers,
                            d_ff=args.d_ff or int(args.d_model * 8 / 3 / 32) * 32,
                            max_seq_len=args.seq_len,
                            dtype=torch.bfloat16 if args.bf16 else torch.float32)
    lt = LMTrainer(cfg, device=args.device)
    state = lt.init_state()
    tokens = lt.synthetic_batch(args.batch or 1, args.seq_len)
    while state["step"] < args.steps:
        state, metrics = lt.train_step(state, tokens)
        step = state["step"]
        if step % max(1, args.steps // 10) == 0 or step == args.steps:
            emit({"job": "llm", "step": step,
                  "loss": round(float(metrics["loss"]), 4)})
    if args.sample > 0:
        # decode path smoke: KV-cached generation from the trained params
        sampled = generate(cfg, state["model"], tokens[:1, :4],
                           max_new_tokens=min(args.sample, cfg.max_seq_len - 4),
                           temperature=0.8, device=lt.device)
        emit({"job": "llm", "sampled_tokens": sampled[0].tolist()})
    emit({"job": "llm", "done": True, "steps": state["step"], "chips": 1,
          "device": str(lt.device), "seq_len": args.seq_len})
    return 0


def cmd_resnet50(args: argparse.Namespace) -> int:
    """ResNet classification for ``--steps`` on the synthetic image stream
    or ``--data-dir``, copied to the device with prefetch. The config is
    the JAX job's: ``TrainConfig`` defaults (so no K7/K8 backward), the
    s2d stem for even images of at least 64, warmup min(100, steps)."""
    refuse_unported(args)
    from kubeoperator_tpu_torch.workloads import data as data_pipe
    from kubeoperator_tpu_torch.workloads.train import TrainConfig, Trainer

    s2d_ok = args.image_size >= 64 and args.image_size % 2 == 0
    cfg = TrainConfig(batch_size=args.batch_per_chip,
                      image_size=args.image_size, depth=args.depth,
                      total_steps=args.steps,
                      warmup_steps=min(100, args.steps),
                      stem="space_to_depth" if s2d_ok else "conv")
    tr = Trainer(cfg, device=args.device)
    state = tr.init_state()
    if args.data_dir:
        source = data_pipe.NpyDataset(args.data_dir).batches(
            cfg.batch_size, seed=0)
    else:
        source = data_pipe.synthetic_image_batches(
            cfg.batch_size, cfg.image_size, cfg.num_classes, seed=0,
            steps=args.steps)
    t0 = time.perf_counter()
    for images, labels in data_pipe.prefetch_to_device(source, tr.device):
        if state["step"] >= args.steps:
            break
        state, metrics = tr.train_step(state, images, labels)
        step = state["step"]
        if step % max(1, args.steps // 10) == 0 or step == args.steps:
            emit({"job": "resnet50", "step": step,
                  "loss": round(float(metrics["loss"]), 4)})
    dt = time.perf_counter() - t0
    img_s = cfg.batch_size * state["step"] / dt if dt > 0 else 0.0
    emit({"job": "resnet50", "done": True, "steps": state["step"],
          "chips": 1, "device": str(tr.device), "img_per_sec": round(img_s, 1),
          "img_per_sec_per_chip": round(img_s, 1)})
    return 0


def cmd_vit(args: argparse.Namespace) -> int:
    """Vision Transformer classification for ``--steps`` on the synthetic
    image stream, copied to the device with prefetch. The encoder is built
    as the JAX job builds it: ``TransformerConfig`` defaults (attention
    ``auto``, remat ``dots``) with d_ff = 4·d_model, non-causal; at 196
    patches ``auto`` takes the dense attention path."""
    refuse_unported(args)
    from kubeoperator_tpu_torch.workloads.data import (
        prefetch_to_device, synthetic_image_batches,
    )
    from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer

    enc = TransformerConfig(
        d_model=args.d_model, n_heads=args.heads, n_layers=args.layers,
        d_ff=args.d_model * 4, causal=False,
        max_seq_len=(args.image_size // args.patch) ** 2)
    cfg = ViTConfig(num_classes=args.classes, image_size=args.image_size,
                    patch=args.patch, encoder=enc)
    tr = ViTTrainer(cfg, device=args.device)
    state = tr.init_state()
    batch = args.batch_per_chip
    source = synthetic_image_batches(batch, args.image_size, args.classes,
                                     seed=0, steps=args.steps)
    t0 = time.perf_counter()
    for images, labels in prefetch_to_device(source, tr.device):
        state, metrics = tr.train_step(state, images, labels)
        step = state["step"]
        if step % max(1, args.steps // 5) == 0 or step == args.steps:
            emit({"job": "vit", "step": step,
                  "loss": round(float(metrics["loss"]), 4)})
    dt = time.perf_counter() - t0
    emit({"job": "vit", "done": True, "steps": args.steps, "chips": 1,
          "device": str(tr.device),
          "img_per_sec": round(batch * args.steps / dt, 1)})
    return 0


def build_server(args: argparse.Namespace):
    """The serve job up to the point where it listens: the model (fresh
    weights from ``--seed``), the engine and its batcher, warm-up, and a
    ``ThreadingHTTPServer`` bound to ``--host``/``--port`` (port 0 takes a
    free one). Returns ``(server, batcher)``; the caller runs
    ``server.serve_forever()`` and ends it with ``server.shutdown()``.

    Routes: ``GET /healthz``, ``GET /stats`` (``BatcherStats.snapshot``),
    ``GET /metrics`` (Prometheus text) and ``POST /generate``
    ``{"prompt_ids": [...], "max_tokens": N, "temperature": T, "seed": S}``
    -> ``{"tokens": [...], "new_tokens": [...]}``; a bad body answers 400,
    a timeout 503 and an engine failure 500."""
    refuse_unported(args)
    import http.server

    from kubeoperator_tpu_torch.telemetry.metrics import Registry
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.serving import (
        BatcherStats, ContinuousBatcher, DynamicBatcher, _pow2_at_least,
        plan_bucket,
    )
    from kubeoperator_tpu_torch.workloads.train import resolve_device
    from kubeoperator_tpu_torch.workloads.transformer import (
        Transformer, TransformerConfig,
    )

    dev = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers,
        # the llm job's SwiGLU recipe, so a trained model's shapes match
        d_ff=args.d_ff or int(args.d_model * 8 / 3 / 32) * 32,
        max_seq_len=args.max_seq_len,
        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    with torch.device(dev):
        model = Transformer(cfg)
    model.reset_parameters(args.seed).eval()
    emit({"job": "serve", "weights": "fresh-init (no checkpoint)",
          "device": str(dev)})
    # one registry for the process: /metrics is one scrape
    stats = BatcherStats(registry=Registry())

    if args.engine == "continuous":
        from kubeoperator_tpu_torch.workloads.decode_loop import SlotPoolEngine

        try:
            engine = SlotPoolEngine(cfg, model, slots=args.slots,
                                    segment=args.segment, page=args.page,
                                    pages=args.pages, device=dev)
        except ValueError as e:
            raise SystemExit(f"serve: {e}") from e
        batcher = ContinuousBatcher(engine, stats=stats)
        emit({"job": "serve", "engine": "continuous", "slots": args.slots,
              "segment": args.segment, "page": engine.page,
              "pages": engine.pages, "kv_dtype": engine.kv_dtype})
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
            b, p_raw, n_raw = (int(x) for x in spec.lower().split("x"))
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


def cmd_serve(args: argparse.Namespace) -> int:
    """Token-generation HTTP endpoint (the jax-serve chart's entry point):
    ``build_server``, then serve until interrupted."""
    server, _ = build_server(args)
    host, port = server.server_address[:2]
    emit({"job": "serve", "listening": f"{host}:{port}"})
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubeoperator_tpu_torch.train.jobs",
                                description="PyTorch port workload jobs")
    sub = p.add_subparsers(dest="cmd", required=True)
    lm = sub.add_parser("llm", help="transformer LM (one device)")
    lm.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    lm.add_argument("--metrics-port", type=int, default=0,
                    help="not ported: must stay 0")
    lm.add_argument("--steps", type=int, default=100)
    lm.add_argument("--seq-len", type=int, default=2048)
    lm.add_argument("--batch", type=int, default=None)
    lm.add_argument("--vocab", type=int, default=32_000)
    lm.add_argument("--d-model", type=int, default=512)
    lm.add_argument("--heads", type=int, default=8)
    lm.add_argument("--layers", type=int, default=4)
    lm.add_argument("--d-ff", type=int, default=None)
    lm.add_argument("--experts", type=int, default=0,
                    help="not ported: must stay 0")
    lm.add_argument("--sample", type=int, default=0,
                    help=">0: generate this many tokens after training "
                         "(KV-cached decode smoke)")
    lm.add_argument("--sp-attention", choices=("ring", "ulysses"),
                    default="ring", help="not ported: must stay ring")
    lm.add_argument("--bf16", action="store_true", default=True)
    lm.add_argument("--no-bf16", dest="bf16", action="store_false")
    lm.add_argument("--mesh", type=str, default=None,
                    help="not ported: must stay unset")
    lm.add_argument("--ckpt-dir", type=str, default=None,
                    help="not ported: must stay unset")
    lm.add_argument("--ckpt-every", type=int, default=50)
    lm.add_argument("--ckpt-keep", type=int, default=3)

    rn = sub.add_parser("resnet50", help="ResNet classification (one "
                                         "device)")
    rn.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    rn.add_argument("--steps", type=int, default=200)
    rn.add_argument("--batch-per-chip", type=int, default=256)
    rn.add_argument("--image-size", type=int, default=224)
    rn.add_argument("--depth", type=int, default=50,
                    help="ResNet depth (18/34/50/101/152)")
    rn.add_argument("--mesh", type=str, default=None,
                    help="not ported: must stay unset")
    rn.add_argument("--ckpt-dir", type=str, default=None,
                    help="not ported: must stay unset")
    rn.add_argument("--ckpt-every", type=int, default=50)
    rn.add_argument("--ckpt-keep", type=int, default=3)
    rn.add_argument("--data-dir", type=str, default=None,
                    help="npy dataset dir (images.npy+labels.npy); "
                         "default: synthetic stream")

    vt = sub.add_parser("vit", help="Vision Transformer classification "
                                    "(one device)")
    vt.add_argument("--device", type=str, default=None,
                    help="torch device; default cuda (raises without a card)")
    vt.add_argument("--steps", type=int, default=50)
    vt.add_argument("--batch-per-chip", type=int, default=64)
    vt.add_argument("--image-size", type=int, default=224)
    vt.add_argument("--patch", type=int, default=16)
    vt.add_argument("--d-model", type=int, default=768)
    vt.add_argument("--heads", type=int, default=12)
    vt.add_argument("--layers", type=int, default=12)
    vt.add_argument("--classes", type=int, default=1000)
    vt.add_argument("--mesh", type=str, default=None,
                    help="not ported: must stay unset")

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
                    help="not ported: must stay unset")
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
                    help="not ported: must stay unset")
    sv.add_argument("--page", type=int, default=None,
                    help="continuous engine: tokens per KV-cache page "
                         "(power of two dividing max_seq_len; default "
                         "min(16, max_seq_len) rounded down)")
    sv.add_argument("--pages", type=int, default=None,
                    help="continuous engine: total KV pages, the admission "
                         "limiter (default slots * max_seq_len/page + 1)")
    sv.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                    help="not ported: must stay bf16")
    sv.add_argument("--spec-k", type=int, default=0,
                    help="not ported: must stay 0")
    sv.add_argument("--draft-layers", type=int, default=0,
                    help="not ported: must stay 0")
    sv.add_argument("--moe", type=int, default=0,
                    help="not ported: must stay 0")
    sv.add_argument("--spill-pages", type=int, default=0,
                    help="not ported: must stay 0")
    sv.add_argument("--aot-cache", type=str, default=None,
                    help="not ported: must stay unset")
    return p


COMMANDS = {"llm": cmd_llm, "resnet50": cmd_resnet50, "vit": cmd_vit,
            "serve": cmd_serve}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
