"""Plain ViT-B/16 as the port's block defines it, in PyTorch: the
benchmark's reference.

f32 throughout, TF32 off, no kernel of the port and nothing it made. The
image is cut into p×p patches in (row, column, channel) order, row-major
over the patch grid, and embedded by one dense layer with a bias; each of
the blocks is x + attention(rmsnorm(x)), then x + swiglu(rmsnorm(x)):
RMSNorm (x·rsqrt(mean(x²) + ε)·scale), q, k, v projections without bias,
rotary embeddings on q and k (interleaved pairs, base 10,000, over the
flattened patch index), softmax attention over every patch, the output
projection; SwiGLU down(silu(gate(h))·up(h)). The head reads the mean over
the patches of the final RMSNorm. The loss is cross-entropy; the
optimizer AdamW (decoupled decay on every leaf) at a constant rate. Each
block is recomputed in the backward (``torch.utils.checkpoint``).

``precision="fp8"`` is the control: every product takes fp8 operands
(the dense layers e4m3 forward and e5m2 gradients, the attention's two
products e4m3 in the forward), the rest as above.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.configs.precision import Fp8Matmul, no_tf32, quantize


def leaves(config: dict) -> list[tuple]:
    """(name, shape, init, fan_in) of every parameter, in the model's
    order."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    hd, f = config["head_dim"], config["intermediate_size"]
    p, c = config["patch_size"], config["channels"]
    if h * hd != d:
        raise ValueError(f"{h} heads of {hd} do not make width {d}")
    out = [("patch.kernel", (p, p, c, d), "normal", p * p * c),
           ("patch.bias", (d,), "zeros", 1)]
    for i in range(config["num_hidden_layers"]):
        out += [(f"l{i}.ln1.scale", (d,), "ones", 1),
                (f"l{i}.attn.q", (d, h, hd), "normal", d),
                (f"l{i}.attn.k", (d, h, hd), "normal", d),
                (f"l{i}.attn.v", (d, h, hd), "normal", d),
                (f"l{i}.attn.o", (h, hd, d), "normal", h * hd),
                (f"l{i}.ln2.scale", (d,), "ones", 1),
                (f"l{i}.mlp.gate", (d, f), "normal", d),
                (f"l{i}.mlp.up", (d, f), "normal", d),
                (f"l{i}.mlp.down", (f, d), "normal", f)]
    out += [("ln_f.scale", (d,), "ones", 1),
            ("head.kernel", (d, config["num_classes"]), "normal", d),
            ("head.bias", (config["num_classes"],), "zeros", 1)]
    return out


def dense(x, w, precision: str, n_in: int = 1):
    """x [..., k] times w, its first ``n_in`` axes (k values) contracted."""
    k = x.shape[-1]
    if math.prod(w.shape[:n_in]) != k:
        raise ValueError(f"{tuple(w.shape)} does not take {k} inputs")
    w2 = w.reshape(k, -1)
    y = (Fp8Matmul.apply(x.reshape(-1, k), w2) if precision == "fp8"
         else x.reshape(-1, k) @ w2)
    return y.reshape(*x.shape[:-1], *w.shape[n_in:])


def operand(x, precision: str):
    """An attention product's operand: itself, or rounded to e4m3 in the
    forward with the gradient passed straight through."""
    if precision != "fp8":
        return x
    return x + (quantize(x, torch.float8_e4m3fn) - x).detach()


def rms(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, base: float):
    """x [B, T, H, D] rotated by position t in interleaved pairs."""
    t, d = x.shape[1], x.shape[-1]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    angles = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(angles)[None, :, None], torch.sin(angles)[None, :, None]
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def patches(images, p: int):
    """[B, H, W, C] -> [B, (H/p)·(W/p), p·p·C]."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def block(x, p, i, config, precision):
    eps, base = config["norm_eps"], config["rope_base"]
    hd = config["head_dim"]
    h = rms(x, p[f"l{i}.ln1.scale"], eps)
    q = rope(dense(h, p[f"l{i}.attn.q"], precision), base)
    k = rope(dense(h, p[f"l{i}.attn.k"], precision), base)
    v = dense(h, p[f"l{i}.attn.v"], precision)
    scores = torch.einsum("bqhd,bkhd->bhqk", operand(q, precision),
                          operand(k, precision)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", operand(probs, precision),
                     operand(v, precision))
    x = x + dense(o.flatten(2), p[f"l{i}.attn.o"], precision, 2)
    h = rms(x, p[f"l{i}.ln2.scale"], eps)
    y = F.silu(dense(h, p[f"l{i}.mlp.gate"], precision)) \
        * dense(h, p[f"l{i}.mlp.up"], precision)
    return x + dense(y, p[f"l{i}.mlp.down"], precision)


def forward(p: dict, images, config: dict, precision: str = "f32",
            remat: bool = True):
    """f32 logits [B, classes] of NHWC images."""
    x = dense(patches(images, config["patch_size"]), p["patch.kernel"],
              precision, 3) + p["patch.bias"]
    for i in range(config["num_hidden_layers"]):
        fn = partial(block, p=p, i=i, config=config, precision=precision)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = rms(x, p["ln_f.scale"], config["norm_eps"]).mean(1)
    return dense(x, p["head.kernel"], precision) + p["head.bias"]


def first_steps(params: dict, batches: list, config: dict,
                precision: str = "f32", remat: bool = True) -> dict:
    """The losses of ``len(batches)`` AdamW steps from ``params``, the norm
    of each leaf's first gradient, and the norm of each leaf's change after
    the last step, in ``leaves`` order."""
    r = config["recipe"]
    lr, b1, b2, eps, wd = (r["learning_rate"], r["b1"], r["b2"], r["eps"],
                           r["weight_decay"])
    with no_tf32():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        s = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, grad_norms = [], None
        for step, (images, labels) in enumerate(batches, start=1):
            logits = forward(p, images, config, precision, remat)
            loss = F.cross_entropy(logits, labels,
                                   label_smoothing=r["label_smoothing"])
            grads = torch.autograd.grad(loss, list(p.values()))
            if step == 1:
                grad_norms = [float(g.norm()) for g in grads]
            with torch.no_grad():
                for (k, v), g in zip(p.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    s[k].mul_(b2).add_(g * g, alpha=1 - b2)
                    mhat = m[k] / (1 - b1 ** step)
                    shat = s[k] / (1 - b2 ** step)
                    v.sub_(lr * (mhat / (shat.sqrt() + eps) + wd * v))
            losses.append(float(loss.detach()))
            del logits, loss, grads
        change = [float((p[k].detach() - params[k]).norm()) for k in p]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
