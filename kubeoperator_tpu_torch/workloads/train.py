"""The ResNet classifier's trainer, and the measurement helpers every
trainer of the port shares: counterparts of ``kubeoperator_tpu/workloads/
train.py`` (``TrainConfig``, ``lr_schedule``, ``make_optimizer``,
``cross_entropy``, ``Trainer``, ``peak_flops_per_chip``, ``timed_steps``,
``step_stats``), one device only (``MeshSpec`` with an axis above 1
raises).
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.workloads import resnet

# Peak dense bf16 FLOP/s and HBM bytes/s by device-name substring (NVIDIA's
# data sheets). Order matters: the first match wins.
PEAKS = (
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 sxm", 989e12, 3.35e12),
    ("h100 80gb hbm3", 989e12, 3.35e12),    # the SXM part's device name
    ("h200", 989e12, 4.8e12),
)


@dataclass(frozen=True)
class MeshSpec:
    """Parallelism degrees, as the JAX package names them. The port runs
    one device: every degree must be 1 until the multi-device slice."""
    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    def sizes(self) -> tuple[tuple[str, int], ...]:
        return (("dp", self.dp), ("fsdp", self.fsdp), ("pp", self.pp),
                ("ep", self.ep), ("tp", self.tp), ("sp", self.sp))


def refuse_mesh(spec: MeshSpec | None) -> None:
    """Raise for a mesh with any axis above 1: the port's trainers run on
    one device until the multi-device slice."""
    if spec is not None and any(s > 1 for _, s in spec.sizes()):
        raise NotImplementedError(
            f"mesh {dict(spec.sizes())}: the port trains on one device "
            f"until ROADMAP queue 1's multi-device item")


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


def _peaks(device) -> tuple[float, float]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"no published peak for device type {dev.type!r}")
    name = torch.cuda.get_device_name(dev).lower()
    for key, flops, hbm in PEAKS:
        if key in name:
            return flops, hbm
    raise ValueError(f"unknown card {name!r}: add its bf16 dense peak and "
                     f"HBM rate to PEAKS")


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
    conv_bwd: str = "dot"            # "dot" | "pallas" (kernel K7)
    pad_min_channels: int = 0        # not ported: must stay 0
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float) -> torch.Tensor:
    """Mean softmax cross-entropy against one-hot labels smoothed to
    (1 − s)·onehot + s/classes."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.cross_entropy(logits, labels.long(), label_smoothing=smoothing)


class Trainer:
    """ResNet classification on one device. The step is eager PyTorch:
    forward in training mode (batch statistics, running ones updated in
    place), label-smoothed cross-entropy, backward, and Nesterov SGD at the
    step's learning rate, updating model and optimizer state in place."""

    def __init__(self, cfg: TrainConfig | None = None,
                 spec: MeshSpec | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        refuse_mesh(spec)
        self.cfg = cfg or TrainConfig()
        if self.cfg.pad_min_channels:
            raise NotImplementedError(
                "pad_min_channels is not ported (ROADMAP queue 1, item 11's "
                "remainder)")
        self.schedule = lr_schedule(self.cfg)
        self.last_metrics: dict = {}

    def init_state(self, params: dict | None = None, seed: int = 0) -> dict:
        """{"step", "model", "opt"}: the model, built on the trainer's
        device, from ``params`` (a state dict of params and batch stats,
        e.g. ``bridge.resnet_params_from_jax``) or the seeded init, and its
        optimizer."""
        cfg = self.cfg
        with torch.device(self.device):
            model = resnet.ResNet(
                num_classes=cfg.num_classes, depth=cfg.depth, dtype=cfg.dtype,
                stem=cfg.stem, dw_dot_max_k=cfg.dw_dot_max_k,
                conv_bwd=cfg.conv_bwd, fused_bn=cfg.fused_bn,
                image_size=cfg.image_size)
        if params is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(params)
        return {"step": 0, "model": model,
                "opt": make_optimizer(self.cfg, model.parameters())}

    def train_step(self, state: dict, images: torch.Tensor,
                   labels: torch.Tensor):
        """One step on images [B, S, S, 3] and integer labels [B]; updates
        ``state`` in place and returns it with {"loss", "accuracy"} as 0-d
        tensors."""
        model, opt = state["model"], state["opt"]
        model.train()
        lr = self.schedule(state["step"])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        logits = model(images)
        loss = cross_entropy(logits, labels, self.cfg.label_smoothing)
        loss.backward()
        opt.step()
        state["step"] += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        self.last_metrics = {"loss": loss.detach(), "accuracy": acc}
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
        """Normal images [B, S, S, 3] f32 and uniform labels, made on the
        trainer's device from a seeded generator."""
        batch = batch or self.cfg.batch_size
        gen = torch.Generator(device=self.device).manual_seed(seed)
        size = self.cfg.image_size
        images = torch.randn(batch, size, size, 3, generator=gen,
                             device=self.device)
        labels = torch.randint(0, self.cfg.num_classes, (batch,),
                               generator=gen, device=self.device)
        return images, labels

    def flops_per_step(self, batch: int | None = None) -> float:
        """fwd + bwd ≈ 3× the forward FLOPs."""
        cfg = self.cfg
        fwd = resnet.flops_per_image(cfg.depth, cfg.image_size,
                                     cfg.num_classes, stem=cfg.stem)
        return 3.0 * fwd * (batch or cfg.batch_size)

    def measure(self, batch: int | None = None, steps: int = 20,
                warmup: int = 3, steps_per_call: int = 1,
                repeats: int = 3) -> dict:
        """Timed train steps on one synthetic batch: img/s, step ms and MFU
        against the card's bf16 peak. ``steps_per_call > 1`` runs
        ``multi_step``; ``steps`` then counts its calls, so ``(warmup +
        steps·repeats)·steps_per_call`` steps run in all. Needs the
        card."""
        peak = peak_flops_per_chip(self.device)
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
        return {"img_per_sec": batch / dt, "img_per_sec_per_chip": batch / dt,
                "step_time_ms": stats["median_ms"], "mfu": achieved / peak,
                "chips": 1, "batch": batch,
                "achieved_tflops": achieved / 1e12,
                "device": torch.cuda.get_device_name(self.device),
                "final_loss": float(self.last_metrics["loss"]),
                "step_stats": stats}
