"""Pipeline parallelism, the counterpart of
``kubeoperator_tpu/workloads/pipeline.py``: the scan-over-stages stance
and GPipe over a ``pp`` mesh axis.

1. **Stacked stages** (``scan_stages``): every rank runs every layer;
   stage params are stacked on a leading axis and the forward loops over
   them under ``torch.utils.checkpoint``: the activation-memory profile
   pipelining exists for, with no bubble.
2. **GPipe over ``pp``** (``gpipe_loss_fn``): each rank of the pp group
   holds one stage, the batch splits into M microbatches, and activations
   hop stage → stage over ``collectives.ppermute``: fill/drain over
   M + S − 1 ticks, bubble (S − 1)/(M + S − 1). The ppermute's backward
   runs the reverse pipeline. Every rank runs the same ops every tick (a
   bubble tick computes on zeros and its result is masked), as the
   reference's SPMD program does, so the ranks' backward graphs, and with
   them the order of their collectives, agree.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from kubeoperator_tpu_torch.workloads import collectives as cl
from kubeoperator_tpu_torch.workloads import sharding


# the MLP LM's functions for the loss builders (the fsdp and pipeline
# jobs, the multi-device bench, the dry run): embedding lookup, residual
# tanh MLP stage, linear head, per-example cross-entropy
MLP_FNS = dict(
    embed_fn=lambda e, t: e[t],
    stage_fn=lambda p, h: h + torch.tanh(h @ p["w1"]) @ p["w2"],
    head_fn=lambda p, h: h @ p,
    loss_fn=lambda out, y: -torch.log_softmax(out, -1)[
        torch.arange(y.shape[0], device=y.device), y])


def bubble_fraction(pp: int, microbatches: int) -> float:
    """Analytic GPipe bubble: the fill/drain schedule runs ``microbatches +
    pp − 1`` ticks, of which ``microbatches`` advance a given stage."""
    if pp < 1 or microbatches < 1:
        raise ValueError(f"pp={pp} microbatches={microbatches} must be >= 1")
    return (pp - 1) / (microbatches + pp - 1)


def bubble_from_timings(t_a: float, micro_a: int, t_b: float, micro_b: int,
                        pp: int) -> float:
    """Measured bubble from two step times at different microbatch counts:
    ``T(M) = overhead + tick × (M + pp − 1)``, so ``tick = (T_b − T_a) /
    (M_b − M_a)`` and the bubble at ``M_a`` is ``tick × (pp − 1) / T_a``.
    Per-step overhead biases it low."""
    if micro_b == micro_a:
        raise ValueError("need two distinct microbatch counts")
    tick = (t_b - t_a) / (micro_b - micro_a)
    if tick <= 0 or t_a <= 0:
        return 0.0
    return min(1.0, tick * (pp - 1) / t_a)


def stack_stages(stage_params: list[dict]) -> dict:
    """Stack per-stage {name: tensor} dicts on a new leading axis."""
    if not stage_params:
        raise ValueError("need at least one stage")
    return {k: torch.stack([p[k] for p in stage_params])
            for k in stage_params[0]}


def unstack_stages(stacked: dict) -> list[dict]:
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _remat(fn: Callable, remat: bool) -> Callable:
    if not remat:
        return fn
    return lambda p, h: checkpoint(fn, p, h, use_reentrant=False)


def scan_stages(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                stacked_params: dict, x: torch.Tensor,
                remat: bool = True) -> torch.Tensor:
    """Run ``x`` through the stacked stages in order, each under
    checkpointing with ``remat``."""
    fn = _remat(stage_fn, remat)
    for p in unstack_stages(stacked_params):
        x = fn(p, x)
    return x


def pipeline_forward(embed_fn: Callable, stage_fn: Callable,
                     head_fn: Callable, params: dict, x: torch.Tensor,
                     remat: bool = True) -> torch.Tensor:
    """embed → stacked stages → head; ``params`` = {"embed", "stages"
    (stacked), "head"}."""
    h = embed_fn(params["embed"], x)
    h = scan_stages(stage_fn, params["stages"], h, remat=remat)
    return head_fn(params["head"], h)


def gpipe_loss_fn(mesh, embed_fn: Callable, stage_fn: Callable,
                  head_fn: Callable, loss_fn: Callable, n_micro: int,
                  axis: str = "pp", remat: bool = True) -> Callable:
    """``loss(params, x, y) -> scalar`` with the stages pipelined over the
    mesh's ``axis``: the sum of ``loss_fn`` over the global batch divided
    by its size, every rank's result the same.

    params = {"embed": replicated, "stages": this rank's stage ({name:
    tensor}, no stage axis), "head": replicated}; ``embed_fn(p, x) -> h``,
    ``stage_fn(p, h) -> h``, ``head_fn(p, h) -> out``, ``loss_fn(out, y)
    -> per-example losses``. x/y: the global batch [B, ...], B divisible
    by ``n_micro`` and each microbatch by the data axes (dp×fsdp).

    Tick t: stage i applies its layer to microbatch t − i (stage 0 to the
    embedded microbatch t), the last stage scores it, and every output
    hops i → i+1. The loss is summed over stages and data ranks; its
    gradients are the whole step's (embed and head summed over pp and the
    data axes, the stage over the data axes)."""
    s = sharding.axis_size(mesh, axis)
    i = sharding.axis_index(mesh, axis)
    group = sharding.axis_group(mesh, axis)
    data = sharding.data_groups(mesh)
    block, blocks = sharding.batch_index(mesh)
    stage = _remat(stage_fn, remat)

    def loss(params, x, y):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        # microbatch m is rows [m·mb, (m+1)·mb); each data rank its block
        xm = sharding.local_block(x.reshape(n_micro, b // n_micro,
                                            *x.shape[1:]), block, blocks, 1)
        ym = sharding.local_block(y.reshape(n_micro, b // n_micro,
                                            *y.shape[1:]), block, blocks, 1)
        embed_p = cl.grads_summed_over(params["embed"], [group, *data])
        head_p = cl.grads_summed_over(params["head"], [group, *data])
        p = {k: cl.grads_summed_over(v, data)
             for k, v in params["stages"].items()}
        state = torch.zeros_like(embed_fn(embed_p, xm[0]))
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        first = torch.tensor(i == 0, device=x.device)
        for t in range(n_micro + s - 1):
            m = t - i
            valid = 0 <= m < n_micro
            # both operands stay in every rank's graph (see the module doc)
            inp = torch.where(first, embed_fn(embed_p,
                                              xm[min(t, n_micro - 1)]), state)
            h = stage(p, inp)
            losses = loss_fn(head_fn(head_p, h),
                             ym[min(max(m, 0), n_micro - 1)])
            take = float(i == s - 1 and valid)
            total = total + take * losses.sum()
            state = cl.ppermute(h, group, 1)
        return cl.sum_over(total, [group, *data]) / b

    return loss
