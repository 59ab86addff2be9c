"""LM trainer, the counterpart of
``kubeoperator_tpu/workloads/lm.py::LMTrainer``: the transformer under a
dp×fsdp×tp×sp mesh of ``torch.distributed`` ranks, or on one device.

The step is eager PyTorch: forward, masked next-token cross-entropy on
f32 logits (plus, for an MoE config, the layers' summed load-balancing
aux loss, which the reported loss includes, as the reference's does),
backward, and ``AdamW`` with optax.adamw's settings on each rank's
parameter shards, updating the model and optimizer state in place (the
JAX step returned a new state and donated the old one).

Under a mesh, every rank takes the same global batch and cuts its block
(rows over dp×fsdp, the sequence over sp) after forming the targets from
the whole sequence: the reference's roll, with the last global position
masked. Its loss is ``(losses·mask).sum() / mask.sum()`` of a [1, T]
mask, summed over the global batch and divided by T − 1, so each rank
divides its own sum by the global T − 1 and the loss and the gradients
are summed over the ranks, never averaged: fsdp by the parameter
gathers' reduce-scatter, dp and sp after the backward
(``sharding.reduce_grads``). Under tp the logits are vocab-parallel and
so is the softmax (``vocab_parallel_cross_entropy``). An MoE config runs
under any of these axes and ep (``moe.py``): every rank holds the global
batch's aux loss, so each adds its share of it, 1/(dp·fsdp·sp), and the
summed loss counts it once, as the reference's does.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.telemetry.tracing import StepPhases
from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads import sharding
from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
from kubeoperator_tpu_torch.workloads.train import (
    peak_flops_per_chip, resolve_device, step_stats, timed_steps,
)
from kubeoperator_tpu_torch.workloads.transformer import (
    Transformer, TransformerConfig, flash_block, flops_per_token,
    param_axes,
)

__all__ = ["LMTrainer", "MeshSpec", "lm_loss",
           "vocab_parallel_cross_entropy"]


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss with the JAX trainer's roll + mask: targets are the
    tokens rolled left by one and the last position is masked out. The sum
    is divided by mask.sum() of the [1, T] mask, exactly as lm.py does."""
    t = tokens.shape[1]
    targets = torch.roll(tokens, -1, dims=1)
    mask = (torch.arange(t, device=tokens.device) < t - 1).float()[None, :]
    losses = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                             targets.reshape(-1), reduction="none")
    return (losses.reshape(tokens.shape) * mask).sum() / mask.sum()


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 group) -> torch.Tensor:
    """Per-token cross-entropy when each tp rank holds the logits of V/tp
    vocabulary rows in rank order (the reference's ``vocab`` → tp rule):
    the max and the sum of exponentials over the whole vocabulary and the
    target's logit, each summed over tp. logits [..., V/tp] f32, targets
    [...] global ids."""
    if group is None:
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1),
                               reduction="none").reshape(targets.shape)
    rows = logits.shape[-1]
    m = cl.all_reduce_max(logits.amax(-1), group)
    z = logits - m[..., None]
    sumexp = cl.reduce_from(z.exp().sum(-1), group)
    local = targets - cl.group_rank(group) * rows
    inside = (local >= 0) & (local < rows)
    picked = z.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    target = cl.reduce_from(picked * inside, group)
    return sumexp.log() - target


class LMTrainer:
    """``slices`` (one id a rank) places the mesh over slices
    (``sharding.build_mesh``); ``compile_cache`` (an
    ``aot.CompileCache``) brings up the kernel library the configuration
    launches, ``flash_attention`` when its attention takes flash on the
    card, at construction, into ``self.aot``. ``workload`` labels the step
    phases' counters (``self.phases``): the job's name."""

    def __init__(self, cfg: TransformerConfig, spec: MeshSpec | None = None,
                 device: str | torch.device | None = None,
                 learning_rate: float = 3e-4,
                 slices: list[int] | None = None,
                 compile_cache=None, workload: str = "llm"):
        self.device = resolve_device(device)
        self.spec = spec or MeshSpec(dp=sharding.world_size())
        self.mesh = sharding.build_mesh(self.spec, self.device.type, slices)
        self.cfg = replace(cfg, ring=self.spec.sp > 1)
        self.aot = None
        if compile_cache is not None:
            flash = (self.device.type == "cuda" and not self.cfg.ring
                     and flash_block(self.cfg, self.cfg.max_seq_len, True)
                     is not None)
            self.aot = compile_cache.consult(
                "LMTrainer", ["flash_attention"] if flash else [],
                mesh_spec=self.spec)
        # ranks whose loss shares sum to the global loss: each adds this
        # share of the (global) MoE aux loss
        self.aux_share = 1.0 / (self.spec.dp * self.spec.fsdp * self.spec.sp)
        self.learning_rate = learning_rate
        self.tp = sharding.axis_group(self.mesh, "tp")
        self.placements: dict = {}
        self.last_metrics: dict = {}
        self.phases = StepPhases(workload, self.device)

    # -- state -------------------------------------------------------------
    def init_state(self, params: dict | None = None, seed: int = 0) -> dict:
        """{"step", "model", "opt"}: a model built whole on the trainer's
        device, from ``params`` (a state dict, e.g.
        ``bridge.params_from_jax``) or the seeded init, then placed on the
        mesh (each rank keeps its shards), and AdamW over the shards."""
        with torch.device(self.device):
            model = Transformer(self.cfg, self.mesh)
        if params is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(params)
        if self.spec.n_devices > 1:
            self.placements = sharding.parallelize(model, self.mesh,
                                                   self.spec, param_axes)
        # optax.adamw(lr, weight_decay=0.01): b1 0.9, b2 0.999, eps 1e-8,
        # decoupled decay on every parameter
        opt = torch.optim.AdamW(model.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        return {"step": 0, "model": model, "opt": opt}

    def full_params(self, model: Transformer, grads: bool = False) -> dict:
        """The whole state dict (or its gradients) on every rank, from the
        shards (a collective under a mesh)."""
        return sharding.full_state(model, self.placements, self.mesh, grads)

    # -- step --------------------------------------------------------------
    def local_batch(self, tokens: torch.Tensor) -> tuple:
        """(inputs, targets, mask) of this rank from the global [B, T]
        batch: targets rolled over the whole sequence, the last global
        position masked, then rows cut over dp×fsdp and the sequence over
        sp."""
        t = tokens.shape[1]
        targets = torch.roll(tokens, -1, dims=1)
        mask = (torch.arange(t, device=tokens.device) < t - 1).float()[None]
        cut = lambda x: sharding.shard_batch(self.mesh, x, seq_dim=1)  # noqa: E731
        return cut(tokens), cut(targets), sharding.local_block(
            mask, sharding.axis_index(self.mesh, "sp"),
            sharding.axis_size(self.mesh, "sp"), 1)

    def objective(self, model: Transformer, tokens: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, aux) of this rank's block of the global batch ``tokens``:
        its share of the next-token loss plus the MoE aux loss, and the aux
        alone (0-d zero for a dense config), the global batch's on every
        rank. Summed over the ranks, the shares are the global loss."""
        inputs, targets, mask = self.local_batch(tokens)
        logits, aux = model(inputs, return_aux=True)
        losses = vocab_parallel_cross_entropy(logits.float(), targets, self.tp)
        return ((losses * mask).sum() / (tokens.shape[1] - 1)
                + aux * self.aux_share, aux)

    def loss(self, model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        return self.objective(model, tokens)[0]

    def train_step(self, state: dict, tokens: torch.Tensor):
        """One AdamW step on the global batch ``tokens`` [B, T]; updates
        ``state`` in place and returns it with {"loss": 0-d tensor, "aux":
        0-d tensor}: the global loss on every rank, aux included. Its
        phases go to ``self.phases``."""
        model, opt, ph = state["model"], state["opt"], self.phases
        with ph.step():
            with ph.phase("optimizer"):
                opt.zero_grad(set_to_none=True)
            with ph.phase("forward"):
                loss, aux = self.objective(model, tokens)
            with ph.phase("backward"):
                loss.backward()
            if self.placements:
                with ph.phase("grad_reduce"):
                    sharding.reduce_grads(model, self.placements, self.mesh)
            with ph.phase("optimizer"):
                opt.step()
            state["step"] += 1
            with ph.phase("metrics"):
                loss = loss.detach()
                for axis in ("dp", "fsdp", "sp"):
                    loss = cl.reduce_from(loss, sharding.axis_group(self.mesh,
                                                                    axis))
                self.last_metrics = {"loss": loss, "aux": aux.detach()}
        return state, self.last_metrics

    # -- data / measurement ------------------------------------------------
    def synthetic_batch(self, batch: int, seq_len: int, seed: int = 0):
        """The global batch from ``seed``, the same on every rank; the
        step cuts each rank's block of it."""
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, self.cfg.vocab_size, (batch, seq_len))
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def measure(self, batch: int, seq_len: int, steps: int = 10,
                warmup: int = 2, repeats: int = 3) -> dict:
        """Train steps on a synthetic global batch; tokens/s, step ms and
        MFU (by ``flops_per_token``, the MoE one for an MoE config)
        against the world's bf16 peak, the final loss and its aux share.
        Needs the card."""
        peak = peak_flops_per_chip(self.device)
        chips = self.spec.n_devices
        state = self.init_state()
        tokens = self.synthetic_batch(batch, seq_len)
        _, times = timed_steps(self.train_step, state, (tokens,), steps,
                               warmup, repeats)
        stats = step_stats(times)
        dt = stats["median_ms"] / 1e3
        tokens_per_step = batch * seq_len
        achieved = 3 * flops_per_token(self.cfg, seq_len) * tokens_per_step / dt
        return {"tokens_per_sec": tokens_per_step / dt,
                "step_time_ms": stats["median_ms"],
                "mfu": achieved / (peak * chips),
                "achieved_tflops": achieved / 1e12, "chips": chips,
                "device": torch.cuda.get_device_name(self.device),
                "final_loss": float(self.last_metrics["loss"]),
                "final_aux": float(self.last_metrics["aux"]),
                "step_stats": stats}
