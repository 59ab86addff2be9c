"""ResNet (v1.5) classifier: the counterpart of
``kubeoperator_tpu/workloads/resnet.py``.

Images and activations are NHWC ``[B, H, W, C]`` tensors; kernels are
flax's HWIO, cast with the activations to ``dtype`` (bf16) per conv, over
f32 masters. Convs, the max pool and BatchNorm follow the JAX model:

- padding is XLA's SAME (``conv_vjp.same_pads``), asymmetric where XLA's is
  (the 3×3 stride-2 convs and the max pool at even sizes, the 7×7 and the
  s2d 4×4 stems), applied with ``F.pad`` before an unpadded conv or pool;
- ``BatchNorm`` is flax's: statistics in f32, var = E[x²] − E[x]² clipped at
  0, the running var updated with that biased batch var at momentum 0.9,
  and the output (x − μ)·(rsqrt(var + ε)·γ) + β in the model dtype
  (``F.batch_norm`` keeps an unbiased running var, so it is not used);
- convs whose kernel is at most ``dw_dot_max_k`` take ``conv_vjp.make_conv``
  with backward ``conv_bwd`` (``"pallas"``: kernel K7 on 1×1 stride-1
  convs); with ``fused_bn`` the (1×1 stride-1 conv, BN, relu)
  neighbourhoods of blocks whose input has H·W ≥ 3136 are
  ``bn_fused.FusedConvBN`` units (kernel K8).

The fused choice and the projections depend on the activations' sizes, so
a model is built for one image size and refuses others. The head's mean
over H, W is taken on the bf16 activations; the head runs in f32.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from kubeoperator_tpu_torch.workloads.bn_fused import FusedConvBN
from kubeoperator_tpu_torch.workloads.conv_vjp import (
    Conv, _lecun_normal_, pad_nhwc, same_pads,
)

STAGE_SIZES = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
               101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
FUSED_MIN_HW = 3136     # 56 × 56: block inputs at least this large fuse
                        # (resnet.py:68-69)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channel axis of NHWC input: ``scale``
    and ``bias`` parameters, running ``mean`` and ``var`` buffers. Batch
    statistics in training mode, running ones in eval mode."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.eps = momentum, eps
        self.dtype, self.zero_scale = dtype, zero_scale

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.constant_(self.scale, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean((0, 1, 2))
            var = torch.maximum((xf * xf).mean((0, 1, 2)) - mean * mean,
                                xf.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's ``max_pool(x, (k, k), (s, s), "SAME")`` on NHWC x: XLA's
    SAME pads filled with −inf."""
    pads = same_pads(x.shape[1:3], (k, k), (s, s))
    if all(lo == hi for lo, hi in pads):
        pool_pad = tuple(lo for lo, _ in pads)
    else:
        x, pool_pad = pad_nhwc(x, pads, float("-inf")), (0, 0)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s, padding=pool_pad)
    return y.permute(0, 2, 3, 1).contiguous()


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """NHWC space-to-depth: (B, H, W, C) -> (B, H/b, W/b, C·b·b) in
    (row, column, channel) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               c * block * block)


def _after(hw: tuple, strides: int) -> tuple:
    """Spatial size after a SAME op of this stride."""
    return tuple(-(-n // strides) for n in hw)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (stride here, v1.5) → 1×1 (4× wider, zero-init scale),
    plus a projection where the residual's shape changes. ``fused`` (a
    ``FusedConvBN`` constructor) replaces the 1×1 conv + BN (+ relu)
    pairs, and a stride-1 projection, by fused units."""

    def __init__(self, in_features: int, features: int, strides: int,
                 conv, norm, hw: tuple, fused=None):
        super().__init__()
        out = features * 4
        self.fused = fused is not None
        if self.fused:
            self.fused1 = fused(in_features, features, relu=True)
        else:
            self.conv1 = conv(in_features, features, (1, 1))
            self.bn1 = norm(features)
        self.conv2 = conv(features, features, (3, 3), (strides, strides))
        self.bn2 = norm(features)
        if self.fused:
            self.fused3 = fused(features, out, relu=False, zero_scale=True)
        else:
            self.conv3 = conv(features, out, (1, 1))
            self.bn3 = norm(out, zero_scale=True)
        self.project = in_features != out or _after(hw, strides) != hw
        self.fused_proj = self.project and self.fused and strides == 1
        if self.fused_proj:
            self.proj_fused = fused(in_features, out, relu=False)
        elif self.project:
            self.proj_conv = conv(in_features, out, (1, 1), (strides, strides))
            self.proj_bn = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            y = self.fused1(x)
        else:
            y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.fused3(y) if self.fused else self.bn3(self.conv3(y))
        residual = x
        if self.fused_proj:
            residual = self.proj_fused(x)
        elif self.project:
            residual = self.proj_bn(self.proj_conv(x))
        return torch.relu(residual + y)


class BasicBlock(nn.Module):
    """3×3 (stride) → 3×3 (zero-init scale), plus a projection where the
    residual's shape changes (depths 18 and 34)."""

    def __init__(self, in_features: int, features: int, strides: int,
                 conv, norm, hw: tuple, fused=None):
        super().__init__()
        self.conv1 = conv(in_features, features, (3, 3), (strides, strides))
        self.bn1 = norm(features)
        self.conv2 = conv(features, features, (3, 3))
        self.bn2 = norm(features, zero_scale=True)
        self.project = in_features != features or _after(hw, strides) != hw
        if self.project:
            self.proj_conv = conv(in_features, features, (1, 1),
                                  (strides, strides))
            self.proj_bn = norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.project else x
        return torch.relu(residual + y)


class Head(nn.Module):
    """flax ``nn.Dense`` in f32: ``kernel`` [d, classes] and ``bias``."""

    def __init__(self, features: int, classes: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, classes))
        self.bias = nn.Parameter(torch.empty(classes))

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.kernel, self.kernel.shape[0], gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.float(), self.kernel.float()) + self.bias.float()


class ResNet(nn.Module):
    """The JAX package's ``ResNet`` built for ``image_size`` × ``image_size``
    × 3 NHWC images. Modes as there: ``stem`` ``"conv"`` (7×7 stride 2) or
    ``"space_to_depth"`` (2×2 s2d, then a 4×4 stride-1 conv; even sizes),
    ``dw_dot_max_k``, ``conv_bwd`` (``"dot"`` or ``"pallas"``) and
    ``fused_bn`` (depth ≥ 50). ``pad_min_channels`` is not ported."""

    def __init__(self, num_classes: int = 1000, depth: int = 50,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 stem: str = "conv", dw_dot_max_k: int = 0,
                 conv_bwd: str = "dot", pad_min_channels: int = 0,
                 fused_bn: bool = False, image_size: int = 224):
        super().__init__()
        if pad_min_channels:
            raise NotImplementedError(
                "pad_min_channels is not ported (ROADMAP queue 1, item 11's "
                "remainder)")
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        bottleneck = depth >= 50
        if fused_bn and not bottleneck:
            raise ValueError("fused_bn requires depth >= 50 (bottleneck "
                             "blocks)")
        self.dtype, self.stem, self.image_size = dtype, stem, image_size

        def conv(cin, cout, kernel, strides=(1, 1)):
            impl = conv_bwd if max(kernel) <= dw_dot_max_k else None
            return Conv(cin, cout, kernel, strides, "SAME", dtype=dtype,
                        bwd_impl=impl)

        norm = partial(BatchNorm, momentum=0.9, eps=1e-5, dtype=dtype)
        fused = partial(FusedConvBN, dtype=dtype) if fused_bn else None
        if stem == "space_to_depth":
            if image_size % 2:
                raise ValueError("the space_to_depth stem needs an even "
                                 "image size")
            self.stem_conv_s2d = conv(12, width, (4, 4))
            hw = (image_size // 2,) * 2
        else:
            self.stem_conv = conv(3, width, (7, 7), (2, 2))
            hw = _after((image_size, image_size), 2)
        self.stem_bn = norm(width)
        hw = _after(hw, 2)                               # max pool
        block = BottleneckBlock if bottleneck else BasicBlock
        blocks, cin = [], width
        for stage, n_blocks in enumerate(STAGE_SIZES[depth]):
            for i in range(n_blocks):
                features = width * 2 ** stage
                strides = 2 if stage > 0 and i == 0 else 1
                fuse = fused if hw[0] * hw[1] >= FUSED_MIN_HW else None
                blocks.append(block(cin, features, strides, conv, norm, hw,
                                    fused=fuse))
                cin = features * 4 if bottleneck else features
                hw = _after(hw, strides)
        self.blocks = nn.ModuleList(blocks)
        self.head = Head(cin, num_classes)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> "ResNet":
        """Seeded init with flax's initializers (lecun_normal kernels, unit
        or zero BN scales, zero biases). Draws differ from JAX's."""
        gen = torch.Generator(device=self.head.kernel.device).manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, S, S, 3], S the built size. Returns f32 logits."""
        if tuple(images.shape[1:3]) != (self.image_size,) * 2:
            raise ValueError(f"this ResNet is built for {self.image_size}² "
                             f"images, got {tuple(images.shape[1:3])}")
        x = images.to(self.dtype)
        if self.stem == "space_to_depth":
            x = self.stem_conv_s2d(space_to_depth(x, 2))
        else:
            x = self.stem_conv(x)
        x = max_pool_same(torch.relu(self.stem_bn(x)), 3, 2)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x.mean((1, 2)))


def flops_per_image(depth: int = 50, image_size: int = 224,
                    num_classes: int = 1000, width: int = 64,
                    stem: str = "conv") -> float:
    """Analytic forward FLOPs per image (multiply-adds × 2), as the JAX
    package counts them for MFU."""
    flops = 0.0
    hw = image_size / 2
    stem_k = (4 * 4 * 12) if stem == "space_to_depth" else (7 * 7 * 3)
    flops += 2 * stem_k * width * hw * hw
    hw /= 2
    c_in = width
    bottleneck = depth >= 50
    for stage, n_blocks in enumerate(STAGE_SIZES[depth]):
        c = width * 2 ** stage
        c_out = c * 4 if bottleneck else c
        for i in range(n_blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            hw_out = hw / stride
            if bottleneck:
                flops += 2 * c_in * c * hw * hw
                flops += 2 * (9 * c) * c * hw_out * hw_out
                flops += 2 * c * c_out * hw_out * hw_out
            else:
                flops += 2 * (9 * c_in) * c * hw_out * hw_out
                flops += 2 * (9 * c) * c * hw_out * hw_out
            if stride != 1 or c_in != c_out:
                flops += 2 * c_in * c_out * hw_out * hw_out
            c_in, hw = c_out, hw_out
    flops += 2 * c_in * num_classes
    return flops
