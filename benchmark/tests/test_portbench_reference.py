"""The plain references against the port's CPU path at tiny sizes, on the
same weights and rows (the benchmark's own), through the harness's
``prepare`` and ``reference_numbers``.

The port's ResNet is run in float64 (its head stays f32), the reference
in f64 too: at these sizes BatchNorm over a few rows makes f32 rounding
read as gaps of a percent, which would hide a wrong equation. The ViT
compares in f32.
"""

import pytest
import torch

from benchmark.harness import compare, driver, spec
from benchmark.harness import traffic as tr

torch.set_num_threads(2)
CPU = torch.device("cpu")
TINY_VIT = {"image_size": 32, "patch_size": 8, "hidden_size": 64,
            "num_attention_heads": 4, "head_dim": 16,
            "intermediate_size": 128, "num_hidden_layers": 2,
            "num_classes": 10}


def tiny(workload, config, traffic, dtype):
    cell = spec.resolve(spec.load_spec(), workload)
    cell.config.update(config)
    cell.config["recipe"]["dtype"] = dtype
    cell.traffic.update(traffic)
    return cell


def numbers(cell, seed, ref_dtype):
    mod = cell.module()
    subject, pool, prog, undo = driver.prepare(cell, mod, seed, CPU, 0, 1)
    params = {k: v.to(ref_dtype)
              for k, v in mod.make_params(cell.config, seed, CPU).items()}
    batches = [(x.to(ref_dtype), y) for x, y in (
        tr.global_batch(cell.traffic, cell.config, seed, i, 1, CPU)
        for i in range(tr.FIRST_STEPS))]
    ref = mod.reference(cell.config, cell.traffic, params, batches, 1)
    return compare.training_numbers(prog, ref)


@pytest.mark.parametrize("workload", ["resnet50.k7k8.b256",
                                      "resnet50.job.b256"])
def test_resnet_reference_is_the_ports_model(workload):
    cell = tiny(workload, {"image_size": 64}, {"batch_per_chip": 8},
                "float64")
    got = numbers(cell, 2 ** 31 + 11, torch.float64)
    # the port's f32 head and f32 master weights leave gaps of ~1e-4
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 2e-3
    assert got["change_gap"] < 2e-3


def test_vit_reference_is_the_ports_model():
    cell = tiny("vit_b16.flash.b512", TINY_VIT, {"batch_per_chip": 4},
                "float32")
    got = numbers(cell, 2 ** 33 + 5, torch.float32)
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-4
