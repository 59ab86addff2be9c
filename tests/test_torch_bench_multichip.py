"""The port's multi-device bench (``kubeoperator_tpu_torch.bench_multichip``):
its ``--cost-model`` mode through the CLI for the H100 (the reference's
matrix and record schema, the overlap win and the bubble guard), and its
measured matrix on 2 gloo ranks, one step a config, beside the reference
script's own child at 2 virtual CPU devices (``scripts/bench_multichip.py
--child 2``, run alongside): the same configs in the same order at the
same meshes, the fsdp overlap and eager schedules at the same loss, MFU
None on the CPU, and the refusals without a card."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from chip_smoke import TOL
from kubeoperator_tpu_torch import bench_multichip as bm
from torch_dist_cases import BENCH2_CONFIGS, BENCH_SEQ, spawn_group

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"


def reference_script():
    spec = importlib.util.spec_from_file_location(
        "ref_bench_multichip", ROOT / "scripts" / "bench_multichip.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def priced(tmp_path_factory):
    out = tmp_path_factory.mktemp("priced") / "artifact.json"
    proc = subprocess.run(
        [sys.executable, "-m", "kubeoperator_tpu_torch.bench_multichip",
         "--cost-model", "--card", H100, "--out", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    artifact = json.loads(out.read_text())
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == artifact
    return artifact


def test_cost_model_matrix_is_the_references(priced):
    """Configs, device counts, meshes and record keys as the reference's
    cost_model_records (priced for its TPU); the numbers are the H100's."""
    ref = reference_script().cost_model_records([1, 2, 4, 8])
    assert priced["devices"] == [1, 2, 4, 8] and priced["card"] == H100
    assert len(priced["configs"]) == len(ref["records"])
    for got, want in zip(priced["configs"], ref["records"]):
        assert (got["config"], got["n_devices"], got.get("mesh")) == (
            want["config"], want["n_devices"], want.get("mesh"))
        assert got.keys() == want.keys()
        assert got["ok"] and got["attribution_source"] == "cost-model"
    assert priced["guards"].keys() == ref["guards"].keys()


def test_cost_model_coverage_and_guards(priced):
    by: dict = {}
    for r in priced["configs"]:
        by.setdefault(r["config"], set()).add(r["n_devices"])
    assert by["fsdp-overlap"] == {1, 2, 4, 8}
    assert by["gpipe"] == {2, 4, 8}
    for seq_k in (8, 16, 32):
        assert by[f"ring-attention-{seq_k}k"] == {1, 2, 4, 8}
    wins = {r["n_devices"]: r["speedup"] for r in priced["configs"]
            if r["config"] == "fsdp-overlap"}
    assert wins == {1: 1.0, 2: 1.258, 4: 1.385, 8: 1.448}
    g = priced["guards"]
    assert g["fsdp_overlap_speedup"] == 1.448
    assert abs(g["bubble_measured"] - g["bubble_analytic"]) \
        <= 0.10 * g["bubble_analytic"]
    # ring at T 8k on one H100: 4·T²·H·D FLOPs at 989 TFLOP/s
    ring = next(r for r in priced["configs"]
                if r["config"] == "ring-attention-8k" and r["n_devices"] == 1)
    assert ring["compute_s"] == round(4 * 8192 ** 2 * 32 * 128 / 989e12, 6)


def test_cost_model_needs_a_card_name():
    with pytest.raises(RuntimeError, match="no CUDA device and no --card"):
        bm.card_name(None)
    with pytest.raises(ValueError, match="unknown card"):
        bm.cost_model_records([1], "NVIDIA A100-SXM4-80GB")


def test_measured_mode_needs_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bm.run_measured([1], 1, 1, False)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """(the port's two ranks' records by config, the reference child's
    records at 2 devices): the child runs while the ranks do."""
    work = tmp_path_factory.mktemp("bench2")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "bench_multichip.py"),
         "--child", "2", "--steps", "1", "--warmup", "0"], cwd=work,
        env=env, stdout=open(work / "reference.out", "w"),
        stderr=open(work / "reference.err", "w"))
    try:
        ranks = spawn_group("bench2", 2, work, {"card": H100})
        ref.wait(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, (work / "reference.err").read_text()[-3000:]
    last = (work / "reference.out").read_text().strip().splitlines()[-1]
    return ranks, json.loads(last)["configs"]


def ring_free(config: str) -> str:
    """A config's name with the ring's length dropped (the port's test
    ring is shorter than the reference child's T 8k)."""
    return "ring-attention" if config.startswith("ring-attention") \
        else config


def test_measured_matrix_is_the_references(world2):
    """The configs the port's matrix runs at n 2, in order, are the
    reference child's, and each at the reference's mesh."""
    ranks, ref = world2
    got = [r for c in BENCH2_CONFIGS for r in ranks[0][c]]
    assert all(r["ok"] for r in ref), ref
    assert [ring_free(r["config"]) for r in got] == [
        ring_free(r["config"]) for r in ref]
    for mine, want in zip(got, ref):
        assert (mine["n_devices"], mine["mesh"]) == (want["n_devices"],
                                                     want["mesh"])


@pytest.mark.parametrize("config", BENCH2_CONFIGS)
def test_measured_config_at_world_2(world2, config):
    """Each config's records agree on both ranks' meshes, are ok, build
    no library and have no MFU."""
    ranks, _ = world2
    recs = ranks[0][config]
    assert [r["mesh"] for r in recs] == [r["mesh"] for r in ranks[1][config]]
    for r in recs:
        assert r["ok"], r
        assert r["n_devices"] == 2
        assert r["compile_counts"] == {}
        assert r.get("mfu") is None
        assert r["step_time_s"] > 0


def test_fsdp_overlap_and_eager_agree(world2):
    """Same params, same data: the two schedules' losses within TOL, the
    cost model's shares scaled onto each measured step (priced for the
    H100), and the measured speedup recorded."""
    over, eager = world2[0][0]["fsdp-overlap"]
    assert (over["config"], eager["config"]) == ("fsdp-overlap",
                                                 "fsdp-eager")
    assert abs(over["loss"] - eager["loss"]) \
        <= TOL["atol"] + TOL["rtol"] * abs(eager["loss"])
    for r in (over, eager):
        assert r["attribution_source"] == "cost-model"
        assert set(r["collective_seconds"]) == {"all_gather",
                                                "reduce_scatter"}
    assert over["measured_speedup"] > 0


def test_gpipe_and_ring_records(world2):
    ranks, ref = world2
    (gp,) = ranks[0]["gpipe"]
    (ref_gp,) = [r for r in ref if r["config"] == "gpipe"]
    for key in ("microbatches", "analytic_bubble_fraction"):
        assert gp[key] == ref_gp[key]
    assert 0.0 <= gp["bubble_fraction"] <= 1.0
    (ring,) = ranks[0][f"ring-attention-{BENCH_SEQ // 1024}k"]
    assert ring["shape"] == bm.RING_SHAPE and ring["seq_len"] == BENCH_SEQ
    assert ring["priced_card"] == H100 and ring["priced_compute_s"] > 0
    assert ring["attribution_source"] == "cost-model"
