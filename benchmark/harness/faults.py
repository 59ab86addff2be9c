"""Faults planted under the timed path, to show that the comparison
catches them (``tests/test_portbench_faults.py`` on the CPU; the chip's
readings of them, by ``benchmark/calibrate.py``, set the limits' upper
ends). Each acts on the program's objects in this process only, and
``install`` returns the call that takes it out again.

- ``unchanged``: the optimizer's step returns the state unchanged;
- ``half_batch``: the step takes half of its rows, the mean over the rest;
- ``no_exchange``: the gradients' exchange between ranks is left out;
- ``altered``: the gradient is altered where the backward produces it
  (the largest leaf's scaled by 3) before the optimizer reads it. A
  smaller error in one leaf hides in ResNet's bf16 spread: scaled by 1.5,
  its kernel gaps read 0.29-0.30, under the kernels' limits.
"""

from __future__ import annotations

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")
ALTER = 3.0


def install(fault: str | None, subject):
    """Plant ``fault`` under ``subject`` (a ``subject.Subject``); returns
    the undo."""
    if fault is None:
        return lambda: None
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")
    opt = subject.opt
    if fault == "unchanged":
        opt.step = lambda *a, **k: None
        return lambda: opt.__dict__.pop("step", None)
    if fault == "altered":
        leaf = max(subject.params(), key=lambda p: p.numel())
        real = type(opt).step.__get__(opt)

        def step(*a, **k):
            if leaf.grad is not None:
                leaf.grad.mul_(ALTER)
            return real(*a, **k)

        opt.step = step
        return lambda: opt.__dict__.pop("step", None)
    if fault == "half_batch":
        real_step = subject.step

        def half(images, labels):
            n = images.shape[0] // 2
            return real_step(images[:n], labels[:n])

        subject.step = half
        return lambda: subject.__dict__.pop("step", None)
    from kubeoperator_tpu_torch.workloads import sharding
    real_reduce = sharding.reduce_grads
    sharding.reduce_grads = lambda *a, **k: None

    def undo():
        sharding.reduce_grads = real_reduce
    return undo
