"""The port's dry-run entry (``kubeoperator_tpu_torch.dryrun``), the
counterpart of ``__graft_entry__.py``: the config matrix on 4 and on 8
gloo ranks prints the OK lines that the reference's
``_dryrun_multichip_impl`` prints at that world (run alongside in a JAX
process on 8 virtual CPU devices): the same configs, labels, meshes and
extras in the same order, every loss finite; its records are the
reference's but for the loss, and rank 0 writes the
``KO_DRYRUN_ARTIFACT``; ``entry()`` builds the all-zero ResNet-50 and its
zero batch; the card is needed unless the CPU is asked for."""

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubeoperator_tpu_torch import dryrun
from torch_dist_cases import spawn_group

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (4, 8)

# the reference's dry run at each world on one JAX process's 8 virtual CPU
# devices; each world's records follow its OK lines
REFERENCE = f"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {str(ROOT)!r})
import __graft_entry__
for n in {WORLDS!r}:
    records = __graft_entry__._dryrun_multichip_impl(n)
    print("records", n, json.dumps(records), flush=True)
"""


def reference_run(work: Path) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "KO_DRYRUN_ARTIFACT"}
    env.update(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE], cwd=work, env=env,
        stdout=open(work / "reference.out", "w"),
        stderr=open(work / "reference.err", "w"))


def reference_output(work: Path) -> dict:
    """{n: {"lines": OK lines, "records": records}} of the reference."""
    out = {n: {"lines": [], "records": None} for n in WORLDS}
    for line in (work / "reference.out").read_text().splitlines():
        if m := re.match(r"dryrun_multichip\((\d+)\): ", line):
            out[int(m.group(1))]["lines"].append(line)
        elif line.startswith("records "):
            _, n, js = line.split(" ", 2)
            out[int(n)]["records"] = json.loads(js)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's ranks and artifact path, the reference's output) a
    world: the reference runs while the port's ranks do."""
    work = tmp_path_factory.mktemp("dryrun")
    artifact = {n: str(work / f"dryrun{n}.json") for n in WORLDS}
    ref = reference_run(work)
    try:
        port = {}
        for n in WORLDS:
            (work / f"w{n}").mkdir()
            port[n] = (spawn_group(f"dryrun{n}", n, work / f"w{n}",
                                   {"artifact": artifact}), artifact[n])
        ref.wait(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, (work / "reference.err").read_text()[-3000:]
    reference = reference_output(work)
    return {n: (*port[n], reference[n]) for n in WORLDS}


def split_loss(line: str) -> tuple[str, float]:
    """(the OK line up to its loss, the loss)."""
    m = re.fullmatch(r"(dryrun_multichip\(\d+\): .* )loss=(\S+) OK", line)
    assert m, line
    return m.group(1), float(m.group(2))


@pytest.mark.parametrize("n", WORLDS)
def test_ok_lines_are_the_references(runs, n):
    ranks, _, ref = runs[n]
    lines = ranks[0]["dryrun"]["lines"]
    assert ref["lines"] and len(lines) == len(ref["lines"])
    for line, want in zip(lines, ref["lines"]):
        head, loss = split_loss(line)
        assert head == split_loss(want)[0]
        assert math.isfinite(loss)
    assert all(r["dryrun"]["lines"] == [] for r in ranks[1:])


@pytest.mark.parametrize("n", WORLDS)
def test_records_and_artifact(runs, n):
    ranks, artifact, ref = runs[n]
    records = ranks[0]["dryrun"]["records"]

    def but_loss(rec: dict) -> dict:
        return {k: v for k, v in rec.items() if k != "loss"}

    assert [but_loss(r) for r in records] == [
        but_loss(r) for r in ref["records"]]
    assert all(r["ok"] and math.isfinite(r["loss"]) for r in records)
    # every rank computes the global batch's loss
    for r in ranks[1:]:
        assert [x["loss"] for x in r["dryrun"]["records"]] == [
            x["loss"] for x in records]
    with open(artifact) as f:
        assert json.load(f) == {"n_devices": n, "configs": records}


def test_entry_is_the_zero_resnet50():
    forward, (model, images) = dryrun.entry("cpu")
    assert images.shape == (8, 224, 224, 3) and not images.any()
    params = list(model.parameters())
    assert any(1000 in p.shape for p in params)         # the classes
    assert sum(p.numel() for p in params) > 25_000_000
    assert not any(t.any() for t in (*params, *model.buffers()))


@pytest.mark.parametrize("call", [lambda: dryrun.entry(),
                                  lambda: dryrun.dryrun_multichip(2),
                                  lambda: dryrun.main([])])
def test_dryrun_needs_the_card_unless_asked_for_the_cpu(call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
