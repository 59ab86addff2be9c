"""ResNet-50 v1.5 on the port: the trainer built from the benchmark's
weights, the frozen forward-FLOP count, and the bound of the conv
backward kernels' work.

The configuration's ``paths`` are the port's two ways to run it: ``k7k8``
(every 1×1 conv through ``conv_vjp.make_conv``, K7 on the stride-1 ones,
and the (1×1 conv, BatchNorm, relu) units of the 56×56 blocks fused, K8
in their backward) and ``job`` (the resnet50 job's defaults: library
convs and BatchNorm under autograd, no kernel of the port).
"""

from __future__ import annotations

import math

import torch

from benchmark.configs import resnet50_reference as reference_model
from benchmark.harness import weights
from benchmark.harness.peaks import bound_s
from benchmark.harness.subject import Subject

# the conv backward kernels' layer: the backward of every conv that takes
# make_conv's backward (every 1×1 conv on the k7k8 path) and of every
# fused conv+BatchNorm unit, whatever kernels run inside
OP_RANGES = {"conv_bwd": ("_ConvBackward", "_FusedTrainBackward")}
FUSED_MIN_HW = 3136     # blocks whose input has at least 56×56 positions
                        # fuse their 1×1 conv+BN units (the port's rule)


def leaves(config: dict) -> list[tuple]:
    return reference_model.leaves(config)


def make_params(config: dict, seed: int, device) -> dict:
    return weights.make(leaves(config), seed, device)


def train_config(config: dict, traffic: dict, world: int):
    """The port's ``TrainConfig`` for this configuration and path."""
    from kubeoperator_tpu_torch.workloads.train import TrainConfig
    r = config["recipe"]
    if (r["optimizer"], r["schedule"], r["bn_dtype"], config["width"],
            r["learning_rate_per"]) != ("nesterov_sgd", "warmup_cosine",
                                        "float32", 64, 256):
        raise ValueError("the port's Trainer runs Nesterov SGD on a warmup "
                         "cosine, f32 BatchNorm, width 64, lr per 256")
    return TrainConfig(
        batch_size=traffic["batch_per_chip"] * world,
        image_size=config["image_size"], num_classes=config["num_classes"],
        depth=config["depth"], learning_rate=r["learning_rate"],
        momentum=r["momentum"], weight_decay=r["weight_decay"],
        label_smoothing=r["label_smoothing"],
        warmup_steps=r["warmup_steps"], total_steps=r["total_steps"],
        dtype=getattr(torch, r["dtype"]), stem=config["stem"],
        **config["paths"][traffic["path"]])


def build(config: dict, traffic: dict, params: dict, device,
          world: int) -> Subject:
    """The port's ``Trainer`` (dp over ``world`` ranks) with its state
    loaded from ``params``; the BatchNorm running statistics start at 0
    and 1."""
    from kubeoperator_tpu_torch.workloads import resnet
    from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
    from kubeoperator_tpu_torch.workloads.train import Trainer
    tc = train_config(config, traffic, world)
    with torch.device("meta"):
        model = resnet.ResNet(
            num_classes=tc.num_classes, depth=tc.depth, dtype=tc.dtype,
            stem=tc.stem, dw_dot_max_k=tc.dw_dot_max_k,
            conv_bwd=tc.conv_bwd, fused_bn=tc.fused_bn,
            image_size=tc.image_size)
    named = list(model.named_parameters())
    sd = weights.map_by_order(params, [n for n, _ in named],
                              [p.shape for _, p in named])
    for name, buf in model.named_buffers():
        fill = torch.zeros if name.endswith(".mean") else torch.ones
        sd[name] = fill(buf.shape, device=device)
    trainer = Trainer(tc, MeshSpec(dp=world) if world > 1 else None,
                      device=device)
    return Subject(trainer, trainer.init_state(params=sd))


def raw_grads(subject: Subject) -> list:
    """Nesterov SGD's first momentum is the gradient plus the weight
    decay of its group times the (still unmoved: the schedule's first
    rate is 0) parameter."""
    opt = subject.opt
    decay = {id(p): g["weight_decay"] for g in opt.param_groups
             for p in g["params"]}
    out = []
    for p in subject.params():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        out.append(torch.zeros_like(p) if buf is None
                   else buf - decay[id(p)] * p.detach())
    return out


def reference(config: dict, traffic: dict, params: dict, batches: list,
              world: int, precision: str = "f32") -> dict:
    return reference_model.first_steps(
        params, batches, config, traffic["batch_per_chip"] * world, precision)


def flops_per_image(config: dict) -> float:
    """Forward FLOPs of one image (a multiply-add is 2), the analytic count
    of the port's ``resnet.flops_per_image`` frozen here: the s2d stem's
    4×4×12 conv at 112², the blocks' convs and projections at their
    output sizes, the head."""
    width, hw = config["width"], config["image_size"] / 2
    flops = 2 * (4 * 4 * 4 * config["channels"]) * width * hw * hw
    hw /= 2
    for _, cin, c, cout, stride, project in reference_model.blocks(config):
        out = hw / stride
        flops += 2 * cin * c * hw * hw
        flops += 2 * 9 * c * c * out * out
        flops += 2 * c * cout * out * out
        if project:
            flops += 2 * cin * cout * out * out
        hw = out
    return flops + 2 * reference_model.blocks(config)[-1][3] \
        * config["num_classes"]


def conv_bwd_sites(config: dict, batch: int) -> list[tuple]:
    """The backward work of the conv backward layer on the k7k8 path, a
    step on one card: ("k7", n, ci, co) for a stride-1 1×1 conv over n
    rows, ("k8", n, ci, co) for a fused unit, ("strided", n_in, n_out, ci,
    co) for a stride-2 1×1 projection."""
    hw = -(-config["image_size"] // 2)
    hw = -(-hw // 2)                                  # the max pool
    sites = []
    for _, cin, c, cout, stride, project in reference_model.blocks(config):
        fused = hw * hw >= FUSED_MIN_HW
        out = -(-hw // stride)
        n_in, n_out = batch * hw * hw, batch * out * out
        kind = "k8" if fused else "k7"
        sites += [(kind, n_in, cin, c), (kind, n_out, c, cout)]
        if project and stride == 1:
            sites.append((kind, n_in, cin, cout))
        elif project:
            sites.append(("strided", n_in, n_out, cin, cout))
        hw = out
    return sites


def site_work(site: tuple) -> tuple[float, float]:
    """(FLOPs, bytes) of one site's backward: dx and dW, each a product of
    2·rows·ci·co FLOPs; each input read once, each output written once
    (x, w, dx bf16; g and the saved conv output y bf16; dW f32; per-channel
    vectors f32), as ``chip_smoke.conv_bounds`` counts K7 and K8."""
    if site[0] == "strided":
        _, n_in, n_out, ci, co = site
        return (4 * n_out * ci * co,
                2 * n_out * ci + 2 * n_out * co + 2 * ci * co
                + 2 * n_in * ci + 4 * ci * co)
    kind, n, ci, co = site
    x, g, w, dw, vec = 2 * n * ci, 2 * n * co, 2 * ci * co, 4 * ci * co, 4 * co
    if kind == "k7":
        return 4 * n * ci * co, x + g + w + x + dw
    return 4 * n * ci * co, x + 2 * g + w + 4 * vec + x + dw + 2 * vec


def layer_bounds(config: dict, traffic: dict, peak_flops: float,
                 peak_bytes: float) -> dict:
    """{"conv_bwd": seconds} a step on one card, on the k7k8 path only
    (the job path runs no kernel of the layer)."""
    if config["paths"][traffic["path"]]["conv_bwd"] != "pallas":
        return {}
    return {"conv_bwd": math.fsum(
        bound_s(*site_work(s), peak_flops, peak_bytes)
        for s in conv_bwd_sites(config, traffic["batch_per_chip"]))}
