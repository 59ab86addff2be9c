"""Plain ResNet-50 v1.5 in PyTorch: the benchmark's reference.

f32 throughout, TF32 off, no kernel of the port and nothing it made:
space-to-depth stem (2×2 blocks in (row, column, channel) order, a 4×4
stride-1 conv), BatchNorm with batch statistics over the whole batch
(var = E[x²] − E[x]², clipped at 0), relu, a 3×3 stride-2 max pool,
bottleneck blocks with the stride on the 3×3 conv and a 1×1 projection
where the shape changes, the mean over the image, a dense head; padding
is XLA's SAME rule. The loss is label-smoothed cross-entropy over the
batch; the optimizer Nesterov SGD with weight decay on the kernels, at a
linear warmup into a cosine. Each block is recomputed in the backward
(``torch.utils.checkpoint``) so a step over a large batch fits.

``precision="fp8"`` is the control: each precision the configuration
states, one step down, where the program holds it. What the program keeps
in bf16 is fp8 here: the convs' operands and outputs, BatchNorm's output,
the residual sums, the pooled features (e4m3 in the forward, e5m2 for
their gradients, one scale a tensor); what it keeps in f32 is bf16 here:
BatchNorm's statistics and the head's operands.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.configs.precision import (
    Fp8Conv, lower, lower_f32, matmul, no_tf32,
)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def blocks(config: dict) -> list[tuple]:
    """(name, in channels, inner width, out channels, stride, projection)
    of every bottleneck block, in order."""
    out, cin = [], config["width"]
    for stage, n in enumerate(config["stage_sizes"]):
        c = config["width"] * 2 ** stage
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            cout = c * config["expansion"]
            out.append((f"s{stage}b{i}", cin, c, cout, stride,
                        cin != cout or stride != 1))
            cin = cout
    return out


def leaves(config: dict) -> list[tuple]:
    """(name, shape, init, fan_in) of every parameter, in the model's
    order: kernels HWIO, each conv's BatchNorm scale and bias after it."""
    def conv_bn(name, k, cin, cout):
        return [(f"{name}.kernel", (k, k, cin, cout), "normal", k * k * cin),
                (f"{name}.scale", (cout,), "ones", 1),
                (f"{name}.bias", (cout,), "zeros", 1)]

    w = config["width"]
    if config["stem"] != "space_to_depth":
        raise ValueError(f"stem {config['stem']!r}: the reference builds the "
                         f"space-to-depth stem")
    out = conv_bn("stem", 4, 4 * config["channels"], w)
    for name, cin, c, cout, _, project in blocks(config):
        out += conv_bn(f"{name}.conv1", 1, cin, c)
        out += conv_bn(f"{name}.conv2", 3, c, c)
        out += conv_bn(f"{name}.conv3", 1, c, cout)
        if project:
            out += conv_bn(f"{name}.proj", 1, cin, cout)
    feats = blocks(config)[-1][3]
    out += [("head.kernel", (feats, config["num_classes"]), "normal", feats),
            ("head.bias", (config["num_classes"],), "zeros", 1)]
    return out


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one dim: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w_hwio, stride: int, precision: str):
    """NCHW x, HWIO kernel, SAME padding."""
    k = w_hwio.shape[0]
    (t, b), (l, r) = (same_pads(x.shape[2], k, stride),
                      same_pads(x.shape[3], k, stride))
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b))
    w = w_hwio.permute(3, 2, 0, 1)
    if precision == "fp8":
        return lower(Fp8Conv.apply(x, w, stride), precision)
    return F.conv2d(x, w, stride=stride)


def batch_norm(x, scale, bias, eps: float, precision: str):
    x = lower_f32(x, precision)
    mean = lower_f32(x.mean((0, 2, 3)), precision)
    msq = lower_f32((x * x).mean((0, 2, 3)), precision)
    var = torch.clamp(msq - mean * mean, min=0.0)
    mul = lower_f32(torch.rsqrt(var + eps) * scale, precision)
    y = (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return lower(y, precision)


def conv_bn(x, p, name, stride, eps, precision, relu: bool):
    y = batch_norm(conv(x, p[f"{name}.kernel"], stride, precision),
                   p[f"{name}.scale"], p[f"{name}.bias"], eps, precision)
    return torch.relu(y) if relu else y


def max_pool(x):
    (t, b), (l, r) = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def space_to_depth(x):
    """NCHW [B, C, H, W] -> [B, 4C, H/2, W/2], channels in (row, column,
    channel) order."""
    b, c, h, w = x.shape
    x = x.view(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def bottleneck(x, p, name, stride, project, eps, precision):
    y = conv_bn(x, p, f"{name}.conv1", 1, eps, precision, True)
    y = conv_bn(y, p, f"{name}.conv2", stride, eps, precision, True)
    y = conv_bn(y, p, f"{name}.conv3", 1, eps, precision, False)
    res = (conv_bn(x, p, f"{name}.proj", stride, eps, precision, False)
           if project else x)
    return torch.relu(lower(res + y, precision))


def forward(p: dict, images, config: dict, precision: str = "f32",
            remat: bool = True):
    """f32 logits [B, classes] of NHWC images [B, S, S, C]."""
    eps = config["recipe"]["bn_eps"]
    x = space_to_depth(lower(images, precision).permute(0, 3, 1, 2))
    x = max_pool(conv_bn(x, p, "stem", 1, eps, precision, True))
    for name, _, _, _, stride, project in blocks(config):
        fn = partial(bottleneck, p=p, name=name, stride=stride,
                     project=project, eps=eps, precision=precision)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    feats = lower(x.mean((2, 3)), precision)
    return matmul(feats, p["head.kernel"], precision) + p["head.bias"]


# ---------------------------------------------------------------------------
# the first steps
# ---------------------------------------------------------------------------

def lr_at(step: int, recipe: dict, global_batch: int) -> float:
    base = recipe["learning_rate"] * global_batch / recipe["learning_rate_per"]
    warmup = recipe["warmup_steps"]
    if step < warmup:
        return base * step / warmup
    decay = max(recipe["total_steps"], warmup + 1) - warmup
    count = min(step - warmup, decay)
    return base * 0.5 * (1 + math.cos(math.pi * count / decay))


def first_steps(params: dict, batches: list, config: dict, global_batch: int,
                precision: str = "f32", remat: bool = True) -> dict:
    """The losses of ``len(batches)`` steps from ``params``, the norm of
    each leaf's first gradient, and the norm of each leaf's change after
    the last step, all in ``leaves`` order."""
    recipe = config["recipe"]
    mu, wd = recipe["momentum"], recipe["weight_decay"]
    with no_tf32():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        bufs, losses, grad_norms = {}, [], None
        for step, (images, labels) in enumerate(batches):
            logits = forward(p, images, config, precision, remat)
            loss = F.cross_entropy(logits, labels,
                                   label_smoothing=recipe["label_smoothing"])
            grads = torch.autograd.grad(loss, list(p.values()))
            if step == 0:
                grad_norms = [float(g.norm()) for g in grads]
            lr = lr_at(step, recipe, global_batch)
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    d = g + wd * v if v.ndim > 1 else g
                    bufs[k] = d.clone() if k not in bufs else mu * bufs[k] + d
                    v.sub_(lr * (d + mu * bufs[k]))
            losses.append(float(loss.detach()))
            del logits, loss, grads
        change = [float((p[k].detach() - params[k]).norm()) for k in p]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
