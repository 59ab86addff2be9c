"""The references' precisions: f32 with TF32 off, and the controls' one
step down (fp8 e4m3 forward and e5m2 gradients, one scale a tensor, where
the program holds bf16; bf16 where it holds f32)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def quantize(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """x rounded to ``fmt`` under one scale that maps its largest
    magnitude to the format's largest, back in x's dtype."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = torch.finfo(fmt).max / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


class Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        xq = quantize(x, torch.float8_e4m3fn)
        wq = quantize(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.stride = stride
        return F.conv2d(xq, wq, stride=stride)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = quantize(g, torch.float8_e5m2)
        dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride=ctx.stride)
        dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride=ctx.stride)
        return dx, dw, None


class Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq = quantize(a, torch.float8_e4m3fn)
        bq = quantize(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = quantize(g, torch.float8_e5m2)
        return gq @ bq.t(), aq.t() @ gq


class Lower(torch.autograd.Function):
    """x rounded to e4m3 (or to bf16) in the forward and its gradient to
    e5m2 (or bf16) in the backward, back in x's dtype."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return round_to(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.bwd), None, None


def round_to(x, fmt):
    if fmt == torch.bfloat16:
        return x.to(fmt).to(x.dtype)
    return quantize(x, fmt)


def lower(x, precision: str):
    """A tensor the program holds in bf16: itself, or in the control fp8."""
    if precision != "fp8":
        return x
    return Lower.apply(x, torch.float8_e4m3fn, torch.float8_e5m2)


def lower_f32(x, precision: str):
    """A tensor the program holds in f32: itself, or in the control bf16."""
    if precision != "fp8":
        return x
    return Lower.apply(x, torch.bfloat16, torch.bfloat16)


def matmul(a, b, precision: str):
    """The head: f32 operands in the program, bf16 in the control."""
    return lower_f32(a, precision) @ lower_f32(b, precision)
