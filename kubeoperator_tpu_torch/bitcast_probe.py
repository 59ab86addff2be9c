"""Per-channel sum of a conv output, three ways: the counterpart of
``scripts/perf_bitcast_probe.py`` on the card.

    python -m kubeoperator_tpu_torch.bitcast_probe

On the TPU the probe showed that a Pallas consumer of a conv output paid a
0.6 ms layout copy unless its operand was a bitcast view of the conv's
physical layout. Here the conv is cuDNN's on a channels-last view, so its
NHWC output is already the ``[N, C]`` row-major matrix a kernel reads.
After a 64→256 1×1 conv of a [128, 56, 56, 64] bf16 input, ``probe``
times, by CUDA events, three consumers of the [128, 56, 56, 256] output:

- ``library``: ``y.sum((0, 1, 2), dtype=torch.float32)``;
- ``kernel_nhwc``: kernel K9 (``channel_sum``) on the channels-last output
  read as [N, C], no copy;
- ``kernel_after_copy``: the conv run on NCHW-contiguous operands, then the
  NCHW → NHWC ``.contiguous()`` copy, then K9 (the copy the TPU avoided
  with its bitcast).

K9 is the column-sum device code of K8's phase 0 without its relu gate
and x̂ (``csrc/conv_bwd.cu::colsum_kernel<false>``): f32 partial sums per
512-row chunk, then a fixed-order reduction over the chunks.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.workloads.bn_fused import sum_chunks
from kubeoperator_tpu_torch.workloads.conv_vjp import (
    check_cuda, conv2d_nhwc, stream_of,
)
from kubeoperator_tpu_torch.workloads.train import cuda_ms

LAUNCHES = {"channel_sum": 0}
SHAPE = (128, 56, 56, 64, 256)      # B, H, W, Ci, Co of the TPU probe


def reset_launches() -> None:
    LAUNCHES["channel_sum"] = 0


def channel_sum_plain(y2: torch.Tensor) -> torch.Tensor:
    """K9's spec: the f32 sum over the rows of y2 [N, C]."""
    return y2.float().sum(0)


def channel_sum(y2: torch.Tensor) -> torch.Tensor:
    """K9: f32 [C] column sums of y2 [N, C]. CPU tensors take
    ``channel_sum_plain``; CUDA tensors (bf16, C a multiple of 8) launch
    ``ko_channel_sum`` or raise."""
    if y2.device.type == "cpu":
        return channel_sum_plain(y2)
    n, c = y2.shape
    check_cuda("channel_sum", (y2, (n, c), torch.bfloat16))
    if c % 8:
        raise ValueError(f"channel_sum: {c} channels; the kernel takes "
                         f"multiples of 8")
    out = torch.empty(c, dtype=torch.float32, device=y2.device)
    rows, chunks = sum_chunks(n)
    ws = torch.empty((chunks, c), dtype=torch.float32, device=y2.device)
    lib = kernels.load("conv_bwd")
    kernels.check(lib.ko_channel_sum(y2.data_ptr(), out.data_ptr(),
                                     ws.data_ptr(), n, c, rows, chunks,
                                     stream_of(y2)), "channel_sum")
    LAUNCHES["channel_sum"] += 1
    return out


def probe(seed: int = 0) -> dict:
    """The three consumers at the TPU probe's shape, each timed alone and
    with the conv in front of it; needs the card."""
    b, h, w, ci, co = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, h, w, ci, device="cuda",
                    generator=gen).to(torch.bfloat16)
    k = (torch.randn(1, 1, ci, co, device="cuda", generator=gen)
         * 0.05).to(torch.bfloat16)
    pads = ((0, 0), (0, 0))
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    k_oihw = k.permute(3, 2, 0, 1).contiguous()

    def conv_nhwc():
        return conv2d_nhwc(x, k, (1, 1), pads)

    def conv_nchw():
        return F.conv2d(x_nchw, k_oihw)

    y = conv_nhwc()
    y_nchw = conv_nchw()
    n = b * h * w

    def library(t):
        return t.sum((0, 1, 2), dtype=torch.float32)

    def kernel_nhwc(t):
        return channel_sum(t.view(n, co))

    def kernel_after_copy(t):
        return channel_sum(t.permute(0, 2, 3, 1).contiguous().view(n, co))

    # the NCHW conv may round other elements to bf16 than the NHWC one, so
    # each variant is held against the plain sum of its own input
    want_nhwc = channel_sum_plain(y.view(n, co))
    want = {"library": want_nhwc, "kernel_nhwc": want_nhwc,
            "kernel_after_copy": channel_sum_plain(
                y_nchw.permute(0, 2, 3, 1).reshape(n, co))}
    got = {"library": library(y), "kernel_nhwc": kernel_nhwc(y),
           "kernel_after_copy": kernel_after_copy(y_nchw)}
    torch.cuda.synchronize()
    out = {"shape": {"b": b, "h": h, "w": w, "ci": ci, "co": co},
           "conv_nhwc_ms": cuda_ms(conv_nhwc, n=10),
           "conv_nchw_ms": cuda_ms(conv_nchw, n=10)}
    variants = {"library": (library, y, conv_nhwc),
                "kernel_nhwc": (kernel_nhwc, y, conv_nhwc),
                "kernel_after_copy": (kernel_after_copy, y_nchw, conv_nchw)}
    for name, (fn, t, conv) in variants.items():
        out[name] = {
            "ms": cuda_ms(lambda: fn(t), n=10),
            "with_conv_ms": cuda_ms(lambda: fn(conv()), n=10),
            "max_abs_err": float((got[name] - want[name]).abs().max()),
            "max_abs_want": float(want[name].abs().max())}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bitcast_probe: needs a CUDA card")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      **probe(args.seed)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
