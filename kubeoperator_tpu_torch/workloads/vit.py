"""Vision Transformer classifier and its trainer, the counterpart of
``kubeoperator_tpu/workloads/vit.py``.

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

The trainer runs over a dp×fsdp×tp×sp mesh of ``torch.distributed``
ranks, or on one device, as the reference's: parameters placed by the
logical rules (``vit_param_axes``: the LM's names, the patch kernel's
``embed`` dimension and the head's rows), the batch split over dp×fsdp,
the encoder Megatron over tp (each rank's K4-K6 run on its H/tp heads). The
reference's ViT attends over the whole sequence (no ring), so sp ranks
compute the same step and their gradients are not summed. Each rank's
loss is its share of the global mean, the gradients summed over dp and
fsdp (``sharding.reduce_grads``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from kubeoperator_tpu_torch.telemetry.tracing import StepPhases
from kubeoperator_tpu_torch.workloads import sharding
from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
from kubeoperator_tpu_torch.workloads.train import (
    data_sum, local_share, peak_flops_per_chip, refuse_axes, resolve_device,
    step_stats, synthetic_images, timed_steps,
)
from kubeoperator_tpu_torch.workloads.transformer import (
    Block, RMSNorm, TransformerConfig, _lecun_normal_, flash_block,
    param_axes, remat_context_fn, run_blocks,
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
    """Under a mesh (``VisionTransformer(cfg, mesh)``, placed by
    ``sharding.parallelize`` with ``vit_param_axes``) the blocks are
    Megatron over tp, as the LM's."""

    def __init__(self, cfg: ViTConfig, mesh=None):
        super().__init__()
        enc = cfg.encoder
        self.cfg = cfg
        self.patch_embed = DenseBias((cfg.patch, cfg.patch, 3, enc.d_model),
                                     enc.d_model)
        self.layers = nn.ModuleList(Block(enc, mesh)
                                    for _ in range(enc.n_layers))
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
        x, _ = run_blocks(self.layers, x, positions,
                          enc.remat and torch.is_grad_enabled(),
                          self._remat_ctx)
        x = self.ln_f(x).float().mean(1)          # mean-pool the patches
        return self.head(x, torch.float32)


# the logical names of the parameters outside the blocks (vit.py's
# with_parts); the biases have none and replicate
VIT_AXES = {"patch_embed.kernel": (None, None, None, "embed"),
            "patch_embed.bias": (None,), "head.kernel": ("embed", None),
            "head.bias": (None,)}


def vit_param_axes(name: str) -> tuple:
    """Logical axes of the ViT's parameter ``name``: the LM's for the
    blocks and ``ln_f``."""
    return VIT_AXES.get(name) or param_axes(name)


def flops_per_image(cfg: ViTConfig) -> float:
    """Forward FLOPs per image (matmul terms ×2)."""
    enc, t = cfg.encoder, cfg.seq_len
    patch_embed = 2 * (cfg.patch ** 2 * 3) * enc.d_model * t
    per_layer = 2 * 4 * enc.d_model ** 2 + 2 * 3 * enc.d_model * enc.d_ff
    attn = 2 * 2 * t * enc.d_model                  # qk^T + pv per token
    head = 2 * enc.d_model * cfg.num_classes
    return patch_embed + t * enc.n_layers * (per_layer + attn) + head


class ViTTrainer:
    """ViT classification trainer over a dp×fsdp×tp×sp mesh (default: dp
    over the world) or on one device. The step is eager PyTorch: forward,
    mean softmax cross-entropy over integer labels, backward, and
    ``AdamW`` with optax.adamw's settings on every parameter shard,
    updating the model and optimizer state in place (the JAX step returned
    a new state and donated the old one). ep and pp raise: the reference's
    ViT has no experts and no stages. ``workload`` labels the step phases'
    counters (``self.phases``): the job's name."""

    def __init__(self, cfg: ViTConfig, spec: MeshSpec | None = None,
                 device: str | torch.device | None = None,
                 learning_rate: float = 3e-4,
                 slices: list[int] | None = None,
                 compile_cache=None, workload: str = "vit"):
        self.device = resolve_device(device)
        self.spec = spec or MeshSpec(dp=sharding.world_size())
        refuse_axes(self.spec, ("dp", "fsdp", "tp", "sp"),
                    "the ViT has no experts and no pipeline stages; the "
                    "reference's ViTTrainer gives the axis no meaning")
        self.mesh = sharding.build_mesh(self.spec, self.device.type, slices)
        # the compile cache (as LMTrainer's): flash_attention when the
        # encoder takes flash on the card
        self.aot = None
        if compile_cache is not None:
            flash = (self.device.type == "cuda" and flash_block(
                cfg.encoder, cfg.seq_len, True) is not None)
            self.aot = compile_cache.consult(
                "ViTTrainer", ["flash_attention"] if flash else [],
                mesh_spec=self.spec)
        self.cfg = cfg
        self.learning_rate = learning_rate
        self.placements: dict = {}
        self.last_metrics: dict = {}
        self.phases = StepPhases(workload, self.device)

    def init_state(self, params: dict | None = None, seed: int = 0) -> dict:
        """{"step", "model", "opt"}: a model built whole on the trainer's
        device, from ``params`` (a state dict, e.g.
        ``bridge.vit_params_from_jax``) or the seeded init, then placed on
        the mesh (each rank keeps its shards), and AdamW over the shards."""
        with torch.device(self.device):
            model = VisionTransformer(self.cfg, self.mesh)
        if params is None:
            model.reset_parameters(seed)
        else:
            model.load_state_dict(params)
        if self.spec.n_devices > 1:
            self.placements = sharding.parallelize(model, self.mesh,
                                                   self.spec, vit_param_axes)
        # optax.adamw(lr, weight_decay=0.05): b1 0.9, b2 0.999, eps 1e-8,
        # decoupled decay on every parameter
        opt = torch.optim.AdamW(model.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.05)
        return {"step": 0, "model": model, "opt": opt}

    def full_params(self, model: VisionTransformer,
                    grads: bool = False) -> dict:
        """The whole state dict (or its gradients) on every rank, from the
        shards (a collective under a mesh)."""
        return sharding.full_state(model, self.placements, self.mesh, grads)

    def loss(self, model: VisionTransformer, images: torch.Tensor,
             labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(this rank's share of the global mean cross-entropy, logits)
        on this rank's block of the global batch"""
        logits = model(images)
        return local_share(F.cross_entropy(logits, labels.long()),
                           self.mesh), logits

    def train_step(self, state: dict, images: torch.Tensor,
                   labels: torch.Tensor):
        """One AdamW step on this rank's block of the global batch:
        images [b, H, W, 3] and integer labels [b]; updates ``state`` in
        place and returns it with {"loss", "accuracy"} of the global batch
        as 0-d tensors; its phases go to ``self.phases``."""
        model, opt, ph = state["model"], state["opt"], self.phases
        with ph.step():
            with ph.phase("optimizer"):
                opt.zero_grad(set_to_none=True)
            with ph.phase("forward"):
                loss, logits = self.loss(model, images, labels)
            with ph.phase("backward"):
                loss.backward()
            if self.placements:
                with ph.phase("grad_reduce"):
                    sharding.reduce_grads(model, self.placements, self.mesh,
                                          axes=("dp", "fsdp"))
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
        """A step function that runs ``k`` train steps on one batch with
        no fence between them: the counterpart of the JAX trainer's
        ``lax.scan`` over k steps per dispatch."""
        def run(state, images, labels):
            for _ in range(k):
                state, metrics = self.train_step(state, images, labels)
            return state, {"loss": metrics["loss"]}

        return run

    def synthetic_batch(self, batch: int, seed: int = 0):
        """This rank's block of a global batch of normal images [B, S, S,
        3] f32 and uniform labels, made on the trainer's device from a
        seeded generator."""
        return synthetic_images(self.mesh, self.device, batch,
                                self.cfg.image_size, self.cfg.num_classes,
                                seed)

    def measure(self, batch: int, steps: int = 6, warmup: int = 2,
                steps_per_call: int = 1, repeats: int = 3) -> dict:
        """Timed train steps on a synthetic global batch: img/s, img/s a
        chip, step ms and MFU (fwd+bwd ≈ 3× forward FLOPs) against the
        world's bf16 peak.
        ``steps_per_call > 1`` runs ``multi_step``; ``steps`` then counts
        its calls, so ``(warmup + steps·repeats)·steps_per_call`` steps run
        in all. Needs the card."""
        peak = peak_flops_per_chip(self.device)
        chips = self.spec.n_devices
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
                "img_per_sec_per_chip": batch / dt / chips,
                "step_time_ms": stats["median_ms"],
                "mfu": achieved / (peak * chips),
                "achieved_tflops": achieved / 1e12, "chips": chips,
                "mesh": dict(self.spec.sizes()),
                "device": torch.cuda.get_device_name(self.device),
                "final_loss": float(self.last_metrics["loss"]),
                "step_stats": stats}
