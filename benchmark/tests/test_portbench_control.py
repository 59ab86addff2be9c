"""The control comes out not correct: the reference computed in fp8 (the
precision below the configurations' bf16) in the program's place, judged
by each cell's limits against the same reference in f32.

On the CPU at a tiny size; on the card (``gpu``) at the cells' own sizes
(their global batch, on one card) on three seeds, printing each reading:

    python -m pytest -s -m gpu benchmark/tests/test_portbench_control.py

Every number a cell's limits name has to be read, and be finite, before
the judgement counts: a number the control lacks would fail by itself.
"""

import math

import pytest
import torch

from benchmark.harness import compare, driver, spec

torch.set_num_threads(2)
CPU = torch.device("cpu")
TINY = {
    # at 8 rows the fp8 gradients' range is narrow, and the control reads
    # under the cell's limits; 32 rows fail them (11 s on two threads)
    "resnet50.k7k8.b256": ({"image_size": 64}, {"batch_per_chip": 32}),
    "vit_b16.flash.b512": ({"image_size": 32, "patch_size": 8,
                            "hidden_size": 64, "num_attention_heads": 4,
                            "head_dim": 16, "intermediate_size": 128,
                            "num_hidden_layers": 2, "num_classes": 10},
                           {"batch_per_chip": 4}),
}


def control(cell, seed, dev) -> dict:
    """The control's numbers at the cell's global batch (its ranks' rows
    together), with the kernels' numbers."""
    mod = cell.module()
    ref = driver.reference_numbers(cell, mod, seed, dev, cell.chips)
    low = driver.reference_numbers(cell, mod, seed, dev, cell.chips, "fp8")
    return compare.training_numbers(low, ref, driver.kernel_mask(cell))


def judged(cell, numbers: dict) -> tuple[bool, dict]:
    unread = [n for n in cell.limits
              if not math.isfinite(numbers.get(n, math.inf))]
    assert not unread, (unread, numbers)
    return compare.judge(numbers, cell.limits)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails_at_a_tiny_size(workload):
    cell = spec.resolve(spec.load_spec(), workload)
    cell.config.update(TINY[workload][0])
    cell.traffic.update(TINY[workload][1])
    ok, checks = judged(cell, control(cell, 2 ** 31 + 17, CPU))
    assert not ok, checks


def test_fp8_operands_round():
    from benchmark.configs.precision import quantize
    x = torch.linspace(-3, 3, 1001)
    q = quantize(x, torch.float8_e4m3fn)
    assert 0 < (q - x).abs().max() < 0.07 * 3
    assert q.abs().max() == pytest.approx(3.0)


def test_a_missing_number_is_caught():
    cell = spec.resolve(spec.load_spec(), "resnet50.k7k8.b256")
    with pytest.raises(AssertionError):
        judged(cell, {"grad_gap_median": 1.0})


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_spec()["workloads"]])
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.resolve(spec.load_spec(), workload)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ok, checks = judged(cell, control(cell, seed,
                                          torch.device("cuda", 0)))
        print(f"control {workload} {seed} " + " ".join(
            f"{n}={c['value']:.4g}/{c['limit']}" for n, c in checks.items()))
        assert not ok, (seed, checks)
