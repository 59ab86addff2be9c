"""The port's ``llm`` and ``vit`` job entry points on the CPU at a tiny
size: they emit loss lines (and the llm job its sampled tokens) and a done
record, and refuse the flags whose parts are not ported yet."""

import json

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.train import jobs

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--d-model", "32", "--heads", "4", "--layers", "2",
        "--d-ff", "64", "--seq-len", "16", "--vocab", "64", "--batch", "2"]


VIT_TINY = ["--device", "cpu", "--batch-per-chip", "2", "--image-size", "32",
            "--patch", "8", "--d-model", "32", "--heads", "4", "--layers",
            "2", "--classes", "10"]


def run(capsys, *argv, cmd="llm"):
    flags = TINY if cmd == "llm" else VIT_TINY
    assert jobs.main([cmd, *flags, *argv]) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_llm_trains_and_samples(capsys):
    records = run(capsys, "--steps", "3", "--sample", "5")
    losses = [r["loss"] for r in records if "loss" in r]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3]
    assert all(loss == loss and loss > 0 for loss in losses)
    sampled = next(r["sampled_tokens"] for r in records if "sampled_tokens" in r)
    assert len(sampled) == 4 + 5 and all(0 <= t < 64 for t in sampled)
    done = records[-1]
    assert done["done"] and done["steps"] == 3 and done["device"] == "cpu"


def test_llm_f32_without_sampling(capsys):
    records = run(capsys, "--steps", "1", "--no-bf16")
    assert not any("sampled_tokens" in r for r in records)
    assert records[-1]["done"]


@pytest.mark.parametrize("flag,value", [
    ("--mesh", "dp:2"), ("--experts", "4"), ("--sp-attention", "ulysses"),
    ("--ckpt-dir", "ckpt"), ("--metrics-port", "8080")])
def test_unported_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jobs.main(["llm", *TINY, "--steps", "1", flag, value])


def test_vit_trains_and_reports(capsys):
    records = run(capsys, "--steps", "5", cmd="vit")
    losses = [r["loss"] for r in records if "loss" in r]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(loss) and loss > 0 for loss in losses)
    done = records[-1]
    assert done["job"] == "vit" and done["done"] and done["steps"] == 5
    assert done["device"] == "cpu" and done["img_per_sec"] > 0


def test_vit_encoder_is_built_as_the_jax_job_builds_it(monkeypatch, capsys):
    """TransformerConfig defaults (auto attention, remat dots), d_ff 4·d,
    non-causal, seq (size/patch)²: at 16 patches auto is dense, so the
    job runs no flash op."""
    from kubeoperator_tpu_torch.workloads import vit as tvit
    seen = []
    init = tvit.ViTTrainer.__init__

    def spy(self, cfg, *a, **k):
        seen.append(cfg)
        init(self, cfg, *a, **k)

    monkeypatch.setattr(tvit.ViTTrainer, "__init__", spy)
    run(capsys, "--steps", "1", cmd="vit")
    enc = seen[0].encoder
    assert (enc.d_ff, enc.causal, enc.max_seq_len) == (128, False, 16)
    assert (enc.attention, enc.remat_policy, enc.flash_layout) == (
        "auto", "dots", "bh")
    assert (seen[0].num_classes, seen[0].image_size, seen[0].patch) == (
        10, 32, 8)


def test_vit_mesh_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jobs.main(["vit", *VIT_TINY, "--steps", "1", "--mesh", "dp:2"])
