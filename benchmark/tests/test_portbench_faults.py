"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``driver.run_rank``: set-up, window, reference, the result line) at
a tiny size on the CPU, once sound and once with each fault a cell can
have (``harness.faults``): the optimizer's step returning the state
unchanged, half of the batch left out, the gradient altered where the
backward produces it, and, over two ranks (gloo), the exchange between
them left out. The cells' own limits judge.

The tiny ResNet runs the port in float64 against a float64 reference: at
these sizes BatchNorm over a few rows makes f32 rounding read as gaps of
a percent (the cells' sizes read far less).
"""

import math
import time

import pytest
import torch

from benchmark.harness import compare, driver, spec
from benchmark.harness.faults import FAULTS

torch.set_num_threads(2)
TINY = {
    "resnet50.k7k8.b256": ({"image_size": 64}, {"batch_per_chip": 8},
                           "float64"),
    "resnet50.job.b256": ({"image_size": 64}, {"batch_per_chip": 8},
                          "float64"),
    "vit_b16.flash.b512": ({"image_size": 32, "patch_size": 8,
                            "hidden_size": 64, "num_attention_heads": 4,
                            "head_dim": 16, "intermediate_size": 128,
                            "num_hidden_layers": 2, "num_classes": 10},
                           {"batch_per_chip": 4}, "float32"),
}


def tiny(workload: str):
    config, traffic, dtype = TINY[workload]
    cell = spec.resolve(spec.load_spec(), workload)
    cell.config.update(config)
    cell.config["recipe"]["dtype"] = dtype
    cell.traffic.update(traffic, trace_steps=1, host_steps=1)
    return cell


@pytest.fixture
def f64_reference(monkeypatch):
    """The reference over the same weights and rows, widened to the
    port's dtype."""
    real = driver.reference_numbers

    def widened(cell, mod, seed, dev, world, precision="f32"):
        dt = getattr(torch, cell.config["recipe"]["dtype"])
        make, batch = mod.make_params, driver.tr.global_batch
        with monkeypatch.context() as m:
            m.setattr(mod, "make_params", lambda *a: {
                k: v.to(dt) for k, v in make(*a).items()})
            m.setattr(driver.tr, "global_batch", lambda *a: tuple(
                x.to(dt) if x.is_floating_point() else x for x in batch(*a)))
            return real(cell, mod, seed, dev, world, precision)

    monkeypatch.setattr(driver, "reference_numbers", widened)


def run(cell, fault=None, trace=False):
    opts = {"seed": 2 ** 31 + 99, "seconds": 0.2, "trace": trace,
            "start": time.time()}
    rec = driver.run_rank(0, 1, cell, opts, "cpu", fault)
    return driver.result_line(cell, [rec], trace, "cpu", {})


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_sound_run_is_correct(workload, f64_reference):
    line = run(tiny(workload), trace=True)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_fault_is_not_correct(workload, fault, f64_reference):
    line = run(tiny(workload), fault)
    assert not line["correct"], (fault, line["checks"])


def test_every_fault_is_tested():
    assert set(FAULTS) == {"unchanged", "half_batch", "altered",
                           "no_exchange"}


def test_the_exchange_left_out_over_two_ranks():
    """``resnet50.k7k8.dp4.b256``'s fault, on two gloo ranks: the sound
    readings and the fault's from one spawn, then a whole run with the
    fault."""
    cell = tiny("resnet50.k7k8.b256")
    dp = spec.resolve(spec.load_spec(), "resnet50.k7k8.dp4.b256")
    cell.name, cell.chips, cell.limits = dp.name, 2, dp.limits
    cell.end_to_end, cell.per_layer = dp.end_to_end, dp.per_layer
    cell.traffic["batch_per_chip"] = 4
    seed = 2 ** 32 + 3
    recs = driver.run_ranks(cell, "readings", {
        "seeds": [seed], "faults": ["no_exchange"], "fault_seeds": [seed]},
        device_type="cpu", deadline_s=240)
    sound, broken = recs[0]["readings"]
    assert broken["kind"] == "no_exchange"
    assert broken["grad_gap_median"] > 10 * sound["grad_gap_median"]
    assert not compare.judge(broken, cell.limits)[0]
    opts = {"seed": seed, "seconds": 0.2, "trace": False,
            "start": time.time()}
    recs = driver.run_ranks(cell, "run", {"opts": opts, "fault":
                                          "no_exchange"},
                            device_type="cpu", deadline_s=240)
    line = driver.result_line(cell, recs, False, "cpu", {})
    assert not line["correct"]
    assert all(math.isfinite(c["value"]) for c in line["checks"].values())
    assert set(line["metrics"]) == {m["name"] for m in dp.end_to_end}
