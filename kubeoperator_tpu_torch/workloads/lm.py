"""LM trainer on one device, the counterpart of
``kubeoperator_tpu/workloads/lm.py::LMTrainer``.

The JAX trainer spreads the batch and sequence over a dp×fsdp×tp×sp mesh;
this slice ports the single-device trainer only, so a ``MeshSpec`` with
any axis above 1 raises. The step is eager PyTorch: forward, masked
next-token cross-entropy on f32 logits, backward, and ``AdamW`` with
optax.adamw's settings, updating the model and optimizer state in place
(the JAX step returned a new state and donated the old one).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch.workloads.train import (
    MeshSpec, peak_flops_per_chip, refuse_mesh, resolve_device, step_stats,
    timed_steps,
)
from kubeoperator_tpu_torch.workloads.transformer import (
    Transformer, TransformerConfig, flops_per_token,
)


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


class LMTrainer:
    def __init__(self, cfg: TransformerConfig, spec: MeshSpec | None = None,
                 device: str | torch.device | None = None,
                 learning_rate: float = 3e-4):
        self.device = resolve_device(device)
        refuse_mesh(spec)
        self.cfg = cfg
        self.learning_rate = learning_rate
        self.last_metrics: dict = {}

    # -- state -------------------------------------------------------------
    def init_state(self, params: dict | None = None, seed: int = 0) -> dict:
        """{"step", "model", "opt"}: a model built on the trainer's device,
        from ``params`` (a state dict, e.g. ``bridge.params_from_jax``) or
        the seeded init, and its AdamW state."""
        with torch.device(self.device):
            model = Transformer(self.cfg)
        if params is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(params)
        # optax.adamw(lr, weight_decay=0.01): b1 0.9, b2 0.999, eps 1e-8,
        # decoupled decay on every parameter
        opt = torch.optim.AdamW(model.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        return {"step": 0, "model": model, "opt": opt}

    # -- step --------------------------------------------------------------
    def loss(self, model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        return lm_loss(model(tokens), tokens)

    def train_step(self, state: dict, tokens: torch.Tensor):
        """One AdamW step on ``tokens`` [B, T]; updates ``state`` in place
        and returns it with {"loss": 0-d tensor}."""
        model, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = self.loss(model, tokens)
        loss.backward()
        opt.step()
        state["step"] += 1
        self.last_metrics = {"loss": loss.detach()}
        return state, self.last_metrics

    # -- data / measurement ------------------------------------------------
    def synthetic_batch(self, batch: int, seq_len: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, self.cfg.vocab_size, (batch, seq_len))
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def measure(self, batch: int, seq_len: int, steps: int = 10,
                warmup: int = 2, repeats: int = 3) -> dict:
        """Train steps on a synthetic batch; tokens/s, step ms and MFU
        against the card's bf16 peak. Needs the card."""
        peak = peak_flops_per_chip(self.device)
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
                "mfu": achieved / peak,
                "achieved_tflops": achieved / 1e12, "chips": 1,
                "device": torch.cuda.get_device_name(self.device),
                "final_loss": float(self.last_metrics["loss"]),
                "step_stats": stats}
