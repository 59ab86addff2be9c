"""ViT-B/16 on the port: the trainer built from the benchmark's weights,
the frozen forward-FLOP count, and the bound of the attention kernels'
work. The configuration's one path, ``flash``, is ``ViTConfig()``'s:
the packed flash kernels (K4-K6 and Δ) at block 256, remat ``dots+attn``.
"""

from __future__ import annotations

import math

import torch

from benchmark.configs import vit_b16_reference as reference_model
from benchmark.harness import weights
from benchmark.harness.peaks import bound_s
from benchmark.harness.subject import Subject

# the attention kernels' layer: the attention op's forward and its
# backward (Δ, dQ, dK/dV), whatever kernels run inside
OP_RANGES = {"flash": ("flash_attention_packed",)}


def leaves(config: dict) -> list[tuple]:
    return reference_model.leaves(config)


def make_params(config: dict, seed: int, device) -> dict:
    return weights.make(leaves(config), seed, device)


def seq_len(config: dict) -> int:
    return (config["image_size"] // config["patch_size"]) ** 2


def vit_config(config: dict, traffic: dict):
    """The port's ``ViTConfig`` for this configuration and path."""
    from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig
    r = config["recipe"]
    if (config["norm"], config["mlp"], config["position_embedding"],
            config["pooling"], r["optimizer"], r["schedule"],
            r["label_smoothing"], config["head_dim"] * config[
                "num_attention_heads"]) != (
            "rmsnorm", "swiglu", "rope_1d", "mean", "adamw", "constant", 0.0,
            config["hidden_size"]):
        raise ValueError("the port's ViT is RMSNorm, SwiGLU, 1-D rope, mean "
                         "pooling, AdamW at a constant rate, no smoothing")
    enc = TransformerConfig(
        d_model=config["hidden_size"], n_heads=config["num_attention_heads"],
        n_layers=config["num_hidden_layers"],
        d_ff=config["intermediate_size"], causal=False,
        max_seq_len=seq_len(config), dtype=getattr(torch, r["dtype"]),
        scan_layers=False, **config["paths"][traffic["path"]])
    return ViTConfig(num_classes=config["num_classes"],
                     image_size=config["image_size"],
                     patch=config["patch_size"], encoder=enc)


def build(config: dict, traffic: dict, params: dict, device,
          world: int) -> Subject:
    """The port's ``ViTTrainer`` (dp over ``world`` ranks) with its model
    loaded from ``params``; its AdamW is held to the recipe."""
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
    from kubeoperator_tpu_torch.workloads.vit import (
        ViTTrainer, VisionTransformer,
    )
    vc = vit_config(config, traffic)
    with torch.device("meta"):
        model = VisionTransformer(vc)
    named = list(model.named_parameters())
    sd = weights.map_by_order(params, [n for n, _ in named],
                              [p.shape for _, p in named])
    r = config["recipe"]
    trainer = ViTTrainer(vc, MeshSpec(dp=world) if world > 1 else None,
                         device=device, learning_rate=r["learning_rate"])
    subject = Subject(trainer, trainer.init_state(params=sd))
    d = subject.opt.defaults
    if (tuple(d["betas"]), d["eps"], d["weight_decay"]) != (
            (r["b1"], r["b2"]), r["eps"], r["weight_decay"]):
        raise ValueError(f"the trainer's AdamW {d} is not the recipe's {r}")
    return subject


def raw_grads(subject: Subject) -> list:
    """AdamW's first moment after one step is (1 − β1) times the
    gradient."""
    opt = subject.opt
    b1 = opt.defaults["betas"][0]
    return [opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state
            else torch.zeros_like(p) for p in subject.params()]


def reference(config: dict, traffic: dict, params: dict, batches: list,
              world: int, precision: str = "f32") -> dict:
    return reference_model.first_steps(params, batches, config, precision)


def flops_per_image(config: dict) -> float:
    """Forward FLOPs of one image (a multiply-add is 2), the port's
    ``vit.flops_per_image`` frozen here: the patch embedding, per position
    and layer the four d×d projections and the three d×ff products of the
    SwiGLU, qkᵀ and pv over the 196 real positions, the head."""
    d, f = config["hidden_size"], config["intermediate_size"]
    t, p = seq_len(config), config["patch_size"]
    patch = 2 * (p * p * config["channels"]) * d * t
    per_layer = 2 * 4 * d * d + 2 * 3 * d * f
    attn = 2 * 2 * t * d
    return patch + t * config["num_hidden_layers"] * (per_layer + attn) \
        + 2 * d * config["num_classes"]


def attention_work(bh: int, t: int, d: int) -> list[tuple]:
    """(FLOPs, bytes) of the attention op at ``bh`` heads of ``t`` real
    positions and width ``d``, not causal, as the op needs them whatever
    kernels split it: the forward reads Q, K, V once and writes O and its
    log-sum-exp row; the backward reads Q, K, V, O, dO and the row once
    and writes dQ, dK, dV (Δ = rowsum(dO ∘ O) from the O and dO it reads).
    FLOPs: QKᵀ and PV forward; the backward's recomputed QKᵀ, dV, dP, dQ
    and dK."""
    pairs = t * t
    blk, row = bh * t * d * 2, bh * t * 4
    return [(4 * pairs * d * bh, 4 * blk + row),
            (10 * pairs * d * bh, 8 * blk + row)]


def layer_bounds(config: dict, traffic: dict, peak_flops: float,
                 peak_bytes: float) -> dict:
    """{"flash": seconds} a step on one card: every layer's attention,
    forward once (remat saves its output) and backward once."""
    bh = traffic["batch_per_chip"] * config["num_attention_heads"]
    per_layer = math.fsum(
        bound_s(flops, nbytes, peak_flops, peak_bytes)
        for flops, nbytes in attention_work(
            bh, seq_len(config), config["head_dim"]))
    return {"flash": per_layer * config["num_hidden_layers"]}
