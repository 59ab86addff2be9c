"""Vision Transformer classifier and its single-device trainer, the
counterpart of ``kubeoperator_tpu/workloads/vit.py``.

The encoder is the LM's ``Block`` stack with ``causal=False``:
bidirectional attention over the patch sequence, 1-D rope over the
flattened patch index inside the shared ``Attention``, and the same
flash/dense selection. In the default ``ViTConfig`` (ViT-B/16) attention
is the packed-layout flash op, kernels K4-K6, with ``dots+attn`` remat
saving its output.

Images are NHWC, as in the JAX package. The stride-p patch conv is one
matmul: the image is cut into ``[B, T, p·p·3]`` patches in (row, column,
channel) order, so the flax HWIO kernel ``[p, p, 3, d]`` reshapes to
``[p·p·3, d]``; patches flatten row-major over the (h', w') grid as the
flax ``x.reshape(b, -1, d)`` does. The conv and its bias run in the
encoder dtype, the head in f32 on the f32 mean of ``ln_f``'s output.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from kubeoperator_tpu_torch.workloads.lm import MeshSpec, refuse_mesh
from kubeoperator_tpu_torch.workloads.train import (
    peak_flops_per_chip, resolve_device, step_stats, timed_steps,
)
from kubeoperator_tpu_torch.workloads.transformer import (
    Block, RMSNorm, TransformerConfig, _lecun_normal_, remat_context_fn,
    run_blocks,
)


@dataclass(frozen=True)
class ViTConfig:
    num_classes: int = 1000
    image_size: int = 224
    patch: int = 16
    # ViT-B/16 with the JAX package's default attention recipe: the packed
    # [B, T, H·D] flash kernels at block 256 (T = 196 padded to 256) and
    # the attention output saved across the remat boundary
    encoder: TransformerConfig = field(default_factory=lambda: TransformerConfig(
        d_model=768, n_heads=12, n_layers=12, d_ff=3072, causal=False,
        max_seq_len=(224 // 16) ** 2, attention="flash", flash_block=256,
        remat_policy="dots+attn", flash_layout="packed", scan_layers=False))

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch) ** 2


class DenseBias(nn.Module):
    """A flax ``kernel``/``bias`` pair: the patch conv (kernel HWIO
    ``[p, p, 3, d]``) and the head (kernel ``[d, classes]``)."""

    def __init__(self, kernel_shape: tuple, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, gen):
        fan_in = math.prod(self.kernel.shape[:-1])
        _lecun_normal_(self.kernel, fan_in, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """x [..., fan_in] times the kernel, plus the bias, all in ``dt``."""
        w = self.kernel.to(dt).reshape(-1, self.kernel.shape[-1])
        return torch.matmul(x.to(dt), w) + self.bias.to(dt)


def patchify(images: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)·(W/p), p·p·C] in (ph, pw, c) order, the
    patches row-major over the (h', w') grid; rows and columns past the
    last whole patch are dropped, as the VALID conv drops them."""
    b, h, w, c = images.shape
    gh, gw = h // p, w // p
    x = images[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        enc = cfg.encoder
        self.cfg = cfg
        self.patch_embed = DenseBias((cfg.patch, cfg.patch, 3, enc.d_model),
                                     enc.d_model)
        self.layers = nn.ModuleList(Block(enc) for _ in range(enc.n_layers))
        self.ln_f = RMSNorm(enc.d_model)
        self.head = DenseBias((enc.d_model, cfg.num_classes), cfg.num_classes)
        self._remat_ctx = remat_context_fn(enc.remat_policy)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "VisionTransformer":
        """Seeded init with flax's initializers (lecun_normal kernels, zero
        biases, unit norms). Draws differ from JAX's."""
        gen = torch.Generator(device=self.ln_f.scale.device).manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3]. Returns f32 logits [B, num_classes]."""
        enc = self.cfg.encoder
        x = self.patch_embed(patchify(images.to(enc.dtype), self.cfg.patch),
                             enc.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x = run_blocks(self.layers, x, positions,
                       enc.remat and torch.is_grad_enabled(), self._remat_ctx)
        x = self.ln_f(x).float().mean(1)          # mean-pool the patches
        return self.head(x, torch.float32)


def flops_per_image(cfg: ViTConfig) -> float:
    """Forward FLOPs per image (matmul terms ×2)."""
    enc, t = cfg.encoder, cfg.seq_len
    patch_embed = 2 * (cfg.patch ** 2 * 3) * enc.d_model * t
    per_layer = 2 * 4 * enc.d_model ** 2 + 2 * 3 * enc.d_model * enc.d_ff
    attn = 2 * 2 * t * enc.d_model                  # qk^T + pv per token
    head = 2 * enc.d_model * cfg.num_classes
    return patch_embed + t * enc.n_layers * (per_layer + attn) + head


class ViTTrainer:
    """ViT classification trainer on one device. The step is eager
    PyTorch: forward, mean softmax cross-entropy over integer labels,
    backward, and ``AdamW`` with optax.adamw's settings on every parameter,
    updating the model and optimizer state in place (the JAX step returned
    a new state and donated the old one). A ``MeshSpec`` with any axis
    above 1 raises."""

    def __init__(self, cfg: ViTConfig, spec: MeshSpec | None = None,
                 device: str | torch.device | None = None,
                 learning_rate: float = 3e-4):
        self.device = resolve_device(device)
        refuse_mesh(spec)
        self.cfg = cfg
        self.learning_rate = learning_rate
        self.last_metrics: dict = {}

    def init_state(self, params: dict | None = None, seed: int = 0) -> dict:
        """{"step", "model", "opt"}: a model built on the trainer's device,
        from ``params`` (a state dict, e.g. ``bridge.vit_params_from_jax``)
        or the seeded init, and its AdamW state."""
        with torch.device(self.device):
            model = VisionTransformer(self.cfg)
        if params is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(params)
        # optax.adamw(lr, weight_decay=0.05): b1 0.9, b2 0.999, eps 1e-8,
        # decoupled decay on every parameter
        opt = torch.optim.AdamW(model.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.05)
        return {"step": 0, "model": model, "opt": opt}

    def loss(self, model: VisionTransformer, images: torch.Tensor,
             labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean cross-entropy, logits)"""
        logits = model(images)
        return F.cross_entropy(logits, labels.long()), logits

    def train_step(self, state: dict, images: torch.Tensor,
                   labels: torch.Tensor):
        """One AdamW step on images [B, H, W, 3] and integer labels [B];
        updates ``state`` in place and returns it with {"loss",
        "accuracy"} as 0-d tensors."""
        model, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        loss, logits = self.loss(model, images, labels)
        loss.backward()
        opt.step()
        state["step"] += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        self.last_metrics = {"loss": loss.detach(), "accuracy": acc}
        return state, self.last_metrics

    def multi_step(self, k: int):
        """A step function that runs ``k`` train steps on one batch with
        no fence between them: the counterpart of the JAX trainer's
        ``lax.scan`` over k steps per dispatch."""
        def run(state, images, labels):
            for _ in range(k):
                state, metrics = self.train_step(state, images, labels)
            return state, {"loss": metrics["loss"]}

        return run

    def synthetic_batch(self, batch: int, seed: int = 0):
        """Normal images [B, S, S, 3] f32 and uniform labels, made on the
        trainer's device from a seeded generator."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        size = self.cfg.image_size
        images = torch.randn(batch, size, size, 3, generator=gen,
                             device=self.device)
        labels = torch.randint(0, self.cfg.num_classes, (batch,),
                               generator=gen, device=self.device)
        return images, labels

    def measure(self, batch: int, steps: int = 6, warmup: int = 2,
                steps_per_call: int = 1, repeats: int = 3) -> dict:
        """Timed train steps on a synthetic batch: img/s, step ms and MFU
        (fwd+bwd ≈ 3× forward FLOPs) against the card's bf16 peak.
        ``steps_per_call > 1`` runs ``multi_step``; ``steps`` then counts
        its calls, so ``(warmup + steps·repeats)·steps_per_call`` steps run
        in all. Needs the card."""
        peak = peak_flops_per_chip(self.device)
        state = self.init_state()
        images, labels = self.synthetic_batch(batch)
        step_fn = (self.multi_step(steps_per_call) if steps_per_call > 1
                   else self.train_step)
        _, times = timed_steps(step_fn, state, (images, labels), steps,
                               warmup, repeats)
        stats = step_stats(times, steps_per_call)
        dt = stats["median_ms"] / 1e3
        achieved = 3 * flops_per_image(self.cfg) * batch / dt
        return {"img_per_sec": batch / dt,
                "img_per_sec_per_chip": batch / dt,
                "step_time_ms": stats["median_ms"],
                "mfu": achieved / peak,
                "achieved_tflops": achieved / 1e12, "chips": 1,
                "device": torch.cuda.get_device_name(self.device),
                "final_loss": float(self.last_metrics["loss"]),
                "step_stats": stats}
