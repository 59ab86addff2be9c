"""Job entry points of the PyTorch port: ``llm`` (train the transformer
LM, then optionally sample from it), ``resnet50`` (train a ResNet on a
synthetic image stream or an ``.npy`` dataset) and ``vit`` (train the
Vision Transformer classifier on a synthetic image stream). The
counterparts of ``cmd_llm``, ``cmd_resnet50`` and ``cmd_vit`` in
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
    return p


COMMANDS = {"llm": cmd_llm, "resnet50": cmd_resnet50, "vit": cmd_vit}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
