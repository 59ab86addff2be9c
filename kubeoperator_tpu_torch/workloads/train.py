"""The ResNet classifier's trainer, and the measurement helpers every
trainer of the port shares: counterparts of ``kubeoperator_tpu/workloads/
train.py`` (``TrainConfig``, ``lr_schedule``, ``make_optimizer``,
``cross_entropy``, ``Trainer``, ``peak_flops_per_chip``, ``timed_steps``,
``step_stats``). The ResNet trainer runs over a dp×fsdp mesh of
``torch.distributed`` ranks, or on one device, as the reference's
``Trainer`` does: every parameter placed by its shape
(``sharding.place_by_shape``; SGD's momentum follows its parameter's
shard), the batch split over dp×fsdp, and BatchNorm's statistics those of
the global batch. Each rank takes its block of the global batch; its loss
is its share of the global mean (its rows' mean times its share of the
rows), and the gradients are summed over the ranks, never averaged: fsdp
by the parameter gathers' reduce-scatter, dp after the backward
(``sharding.reduce_grads``). ``MeshSpec`` is ``sharding.py``'s,
re-exported here.
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.telemetry.tracing import StepPhases
from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads import resnet, sharding
from kubeoperator_tpu_torch.workloads.sharding import MeshSpec

# Peak dense bf16 FLOP/s and HBM bytes/s by device-name substring (NVIDIA's
# data sheets). Order matters: the first match wins.
PEAKS = (
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 sxm", 989e12, 3.35e12),
    ("h100 80gb hbm3", 989e12, 3.35e12),    # the SXM part's device name
    ("h200", 989e12, 4.8e12),
)


def refuse_axes(spec: MeshSpec, allowed: tuple, what: str) -> None:
    """Raise for an axis above 1 that is not ``allowed``: ``what`` says
    why the model gives it no meaning."""
    for axis, size in spec.sizes():
        if size > 1 and axis not in allowed:
            raise NotImplementedError(f"mesh axis {axis}={size}: {what}")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on the card unless asked for the CPU:
    ``None`` means ``"cuda"``, and CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless "
                           "the caller passes device='cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def peaks_for(name: str) -> tuple[float, float]:
    """(bf16 dense FLOP/s, HBM bytes/s) of the card named ``name`` (as
    ``torch.cuda.get_device_name`` gives it), from ``PEAKS``: what the
    cost models price a named card with, no card present. Raises for a
    name the table does not know rather than guessing."""
    low = name.lower()
    for key, flops, hbm in PEAKS:
        if key in low:
            return flops, hbm
    raise ValueError(f"unknown card {low!r}: add its bf16 dense peak and "
                     f"HBM rate to PEAKS")


def _peaks(device) -> tuple[float, float]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no published peak for device type {dev.type!r}")
    return peaks_for(torch.cuda.get_device_name(dev))


def peak_flops_per_chip(device: str | torch.device | None = None) -> float:
    """bf16 dense peak of the card, from its name. Raises for a device this
    table does not know rather than guessing."""
    return _peaks(device)[0]


def peak_hbm_bytes_per_chip(device: str | torch.device | None = None) -> float:
    """HBM bytes/s of the card, from its name; raises like
    ``peak_flops_per_chip``."""
    return _peaks(device)[1]


def cuda_ms(fn: Callable, n: int = 5, repeats: int = 3) -> float:
    """A call's device time on the card: the median over ``repeats`` of
    the mean time of ``n`` back-to-back calls, by CUDA events, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _fence(metrics: dict) -> None:
    if any(isinstance(v, torch.Tensor) and v.is_cuda for v in metrics.values()):
        torch.cuda.synchronize()
    float(next(iter(metrics.values())))


def timed_steps(step_fn: Callable, state: Any, inputs: tuple, steps: int,
                warmup: int, repeats: int = 3) -> tuple[Any, list[float]]:
    """``warmup`` steps, then ``repeats`` blocks of ``steps`` calls with one
    fence per block (``torch.cuda.synchronize`` plus a host read of the
    first metric). Returns (state, per-repeat seconds per step)."""
    warmup = max(1, warmup)
    for _ in range(warmup):
        state, metrics = step_fn(state, *inputs)
    _fence(metrics)
    times: list[float] = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step_fn(state, *inputs)
        _fence(metrics)
        times.append((time.perf_counter() - t0) / steps)
    return state, times


def step_stats(times: list[float], steps_per_call: int = 1) -> dict:
    """min/median/max/mean per-step milliseconds from per-repeat seconds;
    ``suspect`` when the slowest repeat is over twice the median."""
    ts = sorted(t / steps_per_call * 1e3 for t in times)
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    return {"min_ms": ts[0], "median_ms": med, "max_ms": ts[-1],
            "mean_ms": sum(ts) / n, "n_repeats": n,
            "suspect": bool(ts[-1] > 2.0 * med)}


# ---------------------------------------------------------------------------
# the ResNet classifier
# ---------------------------------------------------------------------------

@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field; ``dtype`` is a
    torch dtype."""
    batch_size: int = 256            # global
    image_size: int = 224
    num_classes: int = 1000
    depth: int = 50
    learning_rate: float = 0.1       # per 256 batch; scaled linearly
    momentum: float = 0.9
    weight_decay: float = 1e-4
    label_smoothing: float = 0.1
    warmup_steps: int = 500
    total_steps: int = 50_000
    dtype: Any = torch.bfloat16
    stem: str = "conv"               # or "space_to_depth"
    dw_dot_max_k: int = 0            # custom-backward convs up to this size
    conv_bwd: str = "dot"            # "dot" | "pallas" (kernel K7) | "dot2"
    pad_min_channels: int = 0        # widen narrow widths, masked back
    fused_bn: bool = False           # 1×1 conv+BN(+relu) units (kernel K8)


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, base, warmup, total)`` at
    base = lr · batch / 256, as a function of the step: linear from 0 over
    the warmup, then a cosine to 0 over the remaining steps."""
    base = cfg.learning_rate * cfg.batch_size / 256.0
    warmup = cfg.warmup_steps
    decay = max(cfg.total_steps, warmup + 1) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return base * step / warmup
        count = min(step - warmup, decay)
        return base * 0.5 * (1 + math.cos(math.pi * count / decay))

    return schedule


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.SGD:
    """optax's ``chain(add_decayed_weights(wd, mask=ndim > 1), sgd(lr,
    momentum, nesterov=True))``: Nesterov SGD without dampening, weight
    decay added to the gradients of the kernels only (one param group
    each). The learning rate is set per step from ``lr_schedule``."""
    params = list(params)
    return torch.optim.SGD(
        [{"params": [p for p in params if p.ndim > 1],
          "weight_decay": cfg.weight_decay},
         {"params": [p for p in params if p.ndim <= 1], "weight_decay": 0.0}],
        lr=0.0, momentum=cfg.momentum, dampening=0.0, nesterov=True)


def local_share(mean: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from the mean
    over its block of the rows (the blocks are equal): summed over the
    data ranks it is the global mean (on one device, the mean itself)."""
    return mean / sharding.batch_index(mesh)[1]


def data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A detached metric summed over the data axes (dp, fsdp)."""
    return cl.sum_over(x.detach(), sharding.data_groups(mesh))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float) -> torch.Tensor:
    """Mean softmax cross-entropy against one-hot labels smoothed to
    (1 − s)·onehot + s/classes."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.cross_entropy(logits, labels.long(), label_smoothing=smoothing)


class Trainer:
    """ResNet classification over a dp×fsdp mesh (default: dp over the
    world) or on one device. The step is eager PyTorch: forward in training
    mode (batch statistics, running ones updated in place), label-smoothed
    cross-entropy, backward, and Nesterov SGD at the step's learning rate,
    updating model and optimizer state in place. ``cfg.batch_size`` is the
    global batch. ``slices`` (one id a rank) places the mesh over slices
    (``sharding.build_mesh``); ``compile_cache`` (an ``aot.CompileCache``)
    is consulted at construction, into ``self.aot``. Other mesh axes raise: the reference places its state by
    shape over fsdp and splits the batch over dp×fsdp, so they have no
    meaning for it. ``workload`` labels the step phases' counters
    (``self.phases``): the job's name."""

    def __init__(self, cfg: TrainConfig | None = None,
                 spec: MeshSpec | None = None,
                 device: str | torch.device | None = None,
                 slices: list[int] | None = None,
                 compile_cache: Any = None, workload: str = "resnet50"):
        self.device = resolve_device(device)
        self.spec = spec or MeshSpec(dp=sharding.world_size())
        refuse_axes(self.spec, ("dp", "fsdp"),
                    "the ResNet trainer places its state by shape over fsdp "
                    "and splits the batch over dp×fsdp, as the reference's; "
                    "no other axis has a meaning for it")
        self.mesh = sharding.build_mesh(self.spec, self.device.type, slices)
        self.cfg = cfg or TrainConfig()
        # the compile cache brings up the libraries the step launches here,
        # at construction, on the card: conv_bwd (K7-K9) when the kernel
        # modes are on, batch_norm when the model is bf16; the reference
        # consults at its first step, when its executable's example
        # arguments exist
        self.aot = None
        if compile_cache is not None:
            card = self.device.type == "cuda"
            libs = (["conv_bwd"] if card and (self.cfg.conv_bwd == "pallas"
                                              or self.cfg.fused_bn) else [])
            if card and self.cfg.dtype == torch.bfloat16:
                libs.append("batch_norm")
            self.aot = compile_cache.consult("Trainer", libs,
                                             mesh_spec=self.spec)
        self.schedule = lr_schedule(self.cfg)
        self.placements: dict = {}
        self.last_metrics: dict = {}
        self.phases = StepPhases(workload, self.device)

    def init_state(self, params: dict | None = None, seed: int = 0) -> dict:
        """{"step", "model", "opt"}: the model, built on the trainer's
        device, from ``params`` (a state dict of params and batch stats,
        e.g. ``bridge.resnet_params_from_jax``) or the seeded init, and its
        optimizer. Under a mesh the model is then placed by shape (each
        rank keeps its shards) and its BatchNorms take the data groups."""
        cfg = self.cfg
        with torch.device(self.device):
            model = resnet.ResNet(
                num_classes=cfg.num_classes, depth=cfg.depth, dtype=cfg.dtype,
                stem=cfg.stem, dw_dot_max_k=cfg.dw_dot_max_k,
                conv_bwd=cfg.conv_bwd, fused_bn=cfg.fused_bn,
                pad_min_channels=cfg.pad_min_channels,
                image_size=cfg.image_size)
        if params is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(params)
        if self.spec.n_devices > 1:
            self.placements = sharding.parallelize(model, self.mesh,
                                                   self.spec)
            sharding.set_data_groups(model, self.mesh)
        return {"step": 0, "model": model,
                "opt": make_optimizer(self.cfg, model.parameters())}

    def full_params(self, model: resnet.ResNet, grads: bool = False) -> dict:
        """The whole parameters (or their gradients) on every rank, from
        the shards (a collective under a mesh)."""
        return sharding.full_state(model, self.placements, self.mesh, grads)

    def train_step(self, state: dict, images: torch.Tensor,
                   labels: torch.Tensor):
        """One step on this rank's block of the global batch: images
        [b, S, S, 3] and integer labels [b]; updates ``state`` in place and
        returns it with {"loss", "accuracy"} of the global batch as 0-d
        tensors. Its phases go to ``self.phases`` (``tracing.StepPhases``:
        the learning rate, ``zero_grad`` and ``opt.step()`` are the
        optimizer's)."""
        model, opt, ph = state["model"], state["opt"], self.phases
        with ph.step():
            model.train()
            with ph.phase("optimizer"):
                lr = self.schedule(state["step"])
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.zero_grad(set_to_none=True)
            with ph.phase("forward"):
                logits = model(images)
                loss = local_share(cross_entropy(
                    logits, labels, self.cfg.label_smoothing), self.mesh)
            with ph.phase("backward"):
                loss.backward()
            if self.placements:
                with ph.phase("grad_reduce"):
                    sharding.reduce_grads(model, self.placements, self.mesh)
            with ph.phase("optimizer"):
                opt.step()
            state["step"] += 1
            with ph.phase("metrics"):
                hits = (logits.detach().argmax(-1) == labels).float()
                self.last_metrics = {
                    "loss": data_sum(loss, self.mesh),
                    "accuracy": data_sum(local_share(hits.mean(), self.mesh),
                                         self.mesh)}
        return state, self.last_metrics

    def multi_step(self, k: int):
        """A step function that runs ``k`` train steps on one batch with no
        fence between them: the JAX trainer's ``multi_step_fn(k)`` with
        ``fresh_data=False``."""
        def run(state, images, labels):
            for _ in range(k):
                state, metrics = self.train_step(state, images, labels)
            return state, {"loss": metrics["loss"]}

        return run

    def synthetic_batch(self, batch: int | None = None, seed: int = 0):
        """This rank's block (``sharding.shard_batch``) of a global batch
        of normal images [B, S, S, 3] f32 and uniform labels, made on the
        trainer's device from a seeded generator."""
        return synthetic_images(self.mesh, self.device,
                                batch or self.cfg.batch_size,
                                self.cfg.image_size, self.cfg.num_classes,
                                seed)

    def flops_per_step(self, batch: int | None = None) -> float:
        """fwd + bwd ≈ 3× the forward FLOPs."""
        cfg = self.cfg
        fwd = resnet.flops_per_image(cfg.depth, cfg.image_size,
                                     cfg.num_classes, stem=cfg.stem)
        return 3.0 * fwd * (batch or cfg.batch_size)

    def measure(self, batch: int | None = None, steps: int = 20,
                warmup: int = 3, steps_per_call: int = 1,
                repeats: int = 3) -> dict:
        """Timed train steps on one synthetic global batch: img/s, img/s a
        chip, step ms and MFU against the world's bf16 peak.
        ``steps_per_call > 1`` runs ``multi_step``; ``steps`` then counts
        its calls, so ``(warmup + steps·repeats)·steps_per_call`` steps run
        in all. Needs the card."""
        peak = peak_flops_per_chip(self.device)
        chips = self.spec.n_devices
        batch = batch or self.cfg.batch_size
        state = self.init_state()
        images, labels = self.synthetic_batch(batch)
        step_fn = (self.multi_step(steps_per_call) if steps_per_call > 1
                   else self.train_step)
        _, times = timed_steps(step_fn, state, (images, labels), steps,
                               warmup, repeats)
        stats = step_stats(times, steps_per_call)
        dt = stats["median_ms"] / 1e3
        achieved = self.flops_per_step(batch) / dt
        return {"img_per_sec": batch / dt,
                "img_per_sec_per_chip": batch / dt / chips,
                "step_time_ms": stats["median_ms"],
                "mfu": achieved / (peak * chips), "chips": chips,
                "mesh": dict(self.spec.sizes()), "batch": batch,
                "achieved_tflops": achieved / 1e12,
                "device": torch.cuda.get_device_name(self.device),
                "final_loss": float(self.last_metrics["loss"]),
                "step_stats": stats}


def synthetic_images(mesh, device: torch.device, batch: int, size: int,
                     classes: int, seed: int = 0) -> tuple:
    """This rank's block of a seeded global batch of normal images [B, S,
    S, 3] f32 and uniform labels [B], the same global batch on every
    rank."""
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn(batch, size, size, 3, generator=gen, device=device)
    labels = torch.randint(0, classes, (batch,), generator=gen, device=device)
    return sharding.shard_batch(mesh, images), sharding.shard_batch(mesh,
                                                                     labels)
