"""The PyTorch port stands alone: no module of it (nor chip_smoke.py)
imports JAX, flax, optax or the JAX package, and its entry points run on
the card unless the caller asks for the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.train import jobs
from kubeoperator_tpu_torch.workloads import decode_loop as tdl
from kubeoperator_tpu_torch.workloads import generate as tgen
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads import train as ttrain
from kubeoperator_tpu_torch.workloads import transformer as ttr
from kubeoperator_tpu_torch.workloads import vit as tvit

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "kubeoperator_tpu"}
TINY = ttr.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1,
                             d_ff=64, max_seq_len=16, dtype=torch.float32)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def port_files() -> list[Path]:
    return sorted((ROOT / "kubeoperator_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = port_files()
    assert len(files) >= 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"kubeoperator_tpu_torch/workloads/vit.py",
            "kubeoperator_tpu_torch/workloads/data.py",
            "kubeoperator_tpu_torch/workloads/conv_vjp.py",
            "kubeoperator_tpu_torch/workloads/bn_fused.py",
            "kubeoperator_tpu_torch/workloads/resnet.py",
            "kubeoperator_tpu_torch/bitcast_probe.py",
            "kubeoperator_tpu_torch/workloads/decode_loop.py",
            "kubeoperator_tpu_torch/workloads/moe.py",
            "kubeoperator_tpu_torch/workloads/serving.py",
            "kubeoperator_tpu_torch/telemetry/metrics.py",
            "kubeoperator_tpu_torch/workloads/checkpoint.py",
            "kubeoperator_tpu_torch/workloads/costmodel.py",
            "kubeoperator_tpu_torch/bench.py",
            "kubeoperator_tpu_torch/workloads/sharding.py",
            "kubeoperator_tpu_torch/workloads/collectives.py",
            "kubeoperator_tpu_torch/workloads/ring_attention.py",
            "kubeoperator_tpu_torch/workloads/pipeline.py",
            "kubeoperator_tpu_torch/train/launch.py",
            "kubeoperator_tpu_torch/aot/cache.py",
            "kubeoperator_tpu_torch/aot/warm.py",
            "kubeoperator_tpu_torch/aot/__main__.py",
            "kubeoperator_tpu_torch/analysis/compile_guard.py",
            "kubeoperator_tpu_torch/analysis/lint.py",
            "kubeoperator_tpu_torch/bench_multichip.py",
            "kubeoperator_tpu_torch/bench_serving.py",
            "kubeoperator_tpu_torch/dryrun.py",
            "kubeoperator_tpu_torch/telemetry/tracing.py",
            "kubeoperator_tpu_torch/telemetry/serve_trace.py",
            "kubeoperator_tpu_torch/telemetry/flight.py",
            "kubeoperator_tpu_torch/cluster/gateway.py",
            "kubeoperator_tpu_torch/cluster/disagg.py",
            "chip_smoke.py"} <= names
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_no_yaml():
    """The card's machine has no PyYAML: no port module (nor
    chip_smoke.py) imports ``yaml``; the serve job reads its span cap
    from the environment instead of a config file."""
    for path in port_files():
        assert "yaml" not in _imported_roots(path), path.relative_to(ROOT)


def test_scan_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("from kubeoperator_tpu.workloads import lm\nimport optax\n")
    assert _imported_roots(probe) & FORBIDDEN == {"kubeoperator_tpu", "optax"}


def _expect_cuda_default(make):
    """Without a card the default device raises; with one it is CUDA."""
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_trainer_defaults_to_cuda():
    _expect_cuda_default(lambda: tlm.LMTrainer(TINY).device)


def test_generate_defaults_to_cuda():
    model = ttr.Transformer(TINY).reset_parameters(0)
    _expect_cuda_default(
        lambda: tgen.generate(TINY, model, np.zeros((1, 2), int), 1).device)


def test_jobs_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a card the default run is the full job")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jobs.main(["llm", "--steps", "1", "--d-model", "32", "--heads", "4",
                   "--layers", "1", "--d-ff", "64", "--seq-len", "8",
                   "--vocab", "64"])


def test_vit_trainer_defaults_to_cuda():
    cfg = tvit.ViTConfig(num_classes=4, image_size=16, patch=8,
                         encoder=TINY)
    _expect_cuda_default(lambda: tvit.ViTTrainer(cfg).device)


def test_vit_job_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a card the default run is the full job")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jobs.main(["vit", "--steps", "1", "--batch-per-chip", "1",
                   "--image-size", "16", "--patch", "8", "--d-model", "32",
                   "--heads", "4", "--layers", "1", "--classes", "4"])


def test_resnet_trainer_defaults_to_cuda():
    cfg = ttrain.TrainConfig(batch_size=1, image_size=32, depth=18)
    _expect_cuda_default(lambda: ttrain.Trainer(cfg).device)


def test_resnet50_job_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("with a card the default run is the full job")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jobs.main(["resnet50", "--steps", "1", "--batch-per-chip", "1",
                   "--image-size", "32", "--depth", "18"])


def test_slot_pool_engine_defaults_to_cuda():
    with torch.device("cuda" if torch.cuda.is_available() else "cpu"):
        model = ttr.Transformer(TINY)
    _expect_cuda_default(
        lambda: tdl.SlotPoolEngine(TINY, model, slots=1, segment=1).device)


@pytest.mark.parametrize("engine", ["continuous", "dynamic"])
def test_serve_job_defaults_to_cuda(engine):
    if torch.cuda.is_available():
        pytest.skip("with a card the default run is the full server")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jobs.main(["serve", "--engine", engine, "--port", "0", "--vocab",
                   "64", "--d-model", "32", "--heads", "4", "--layers", "1",
                   "--d-ff", "64", "--max-seq-len", "16"])


def test_kernel_sources_are_built_from_the_checkout():
    """Each CUDA library has its C signatures and a source under csrc/; a
    library's path changes with its source and the shared header, which
    is the Hopper one alone (no mma.sync kernel is left)."""
    from kubeoperator_tpu_torch import kernels
    assert set(kernels.SIGNATURES) == {"flash_attention", "conv_bwd",
                                       "batch_norm"}
    for name in kernels.SIGNATURES:
        assert (kernels.CSRC / f"{name}.cu").exists()
        assert kernels.lib_path(name).parent == kernels.BUILD_DIR
    assert (kernels.CSRC / "sm90.cuh").exists()
    assert not (kernels.CSRC / "mma.cuh").exists()


def test_no_kernel_uses_mma_sync():
    """Every flash and conv kernel runs on Hopper's wgmma (or no matrix
    unit at all): no CUDA source of the port issues mma.sync."""
    from kubeoperator_tpu_torch import kernels
    sources = sorted(kernels.CSRC.glob("*.cu*"))
    assert {p.name for p in sources} >= {"flash_attention.cu", "conv_bwd.cu",
                                        "sm90.cuh"}
    for path in sources:
        assert "mma.sync" not in path.read_text(), path.name


@pytest.mark.parametrize("argv", [["smoke"], ["mnist", "--steps", "1",
                                              "--batch", "2"]])
def test_one_device_jobs_default_to_cuda(argv):
    if torch.cuda.is_available():
        pytest.skip("with a card the default run is the full job")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jobs.main(argv)
