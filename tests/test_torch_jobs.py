"""The port's ``llm``, ``resnet50`` and ``vit`` job entry points on the
CPU at a tiny size: they emit loss lines (and the llm job its sampled
tokens) and a done record, and refuse the flags whose parts are not ported
yet."""

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


RESNET_TINY = ["--device", "cpu", "--batch-per-chip", "2", "--image-size",
               "32", "--depth", "18"]


def run(capsys, *argv, cmd="llm"):
    flags = {"llm": TINY, "vit": VIT_TINY, "resnet50": RESNET_TINY}[cmd]
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


def test_resnet50_trains_on_the_synthetic_stream(capsys):
    records = run(capsys, "--steps", "3", cmd="resnet50")
    losses = [r["loss"] for r in records if "loss" in r]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3]
    assert all(np.isfinite(loss) and loss > 0 for loss in losses)
    done = records[-1]
    assert done["job"] == "resnet50" and done["done"] and done["steps"] == 3
    assert done["device"] == "cpu" and done["img_per_sec"] > 0


def test_resnet50_reads_a_data_dir(capsys, tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "images.npy",
            rng.standard_normal((6, 32, 32, 3)).astype(np.float32))
    np.save(tmp_path / "labels.npy", rng.integers(0, 1000, 6).astype(np.int32))
    records = run(capsys, "--steps", "4", "--data-dir", str(tmp_path),
                  cmd="resnet50")          # 3 batches an epoch: a second epoch
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4]
    assert records[-1]["done"] and records[-1]["steps"] == 4


@pytest.mark.parametrize("size,stem", [(32, "conv"), (64, "space_to_depth"),
                                       (65, "conv")])
def test_resnet50_config_is_the_jax_job_s(monkeypatch, capsys, size, stem):
    """TrainConfig defaults (no K7/K8 modes), s2d stem for even sizes of
    at least 64, warmup min(100, steps), batch per chip on one chip."""
    from kubeoperator_tpu_torch.workloads import train as ttrain
    seen = []
    init = ttrain.Trainer.__init__

    def spy(self, cfg, *a, **k):
        seen.append(cfg)
        init(self, cfg, *a, **k)

    monkeypatch.setattr(ttrain.Trainer, "__init__", spy)
    monkeypatch.setattr(ttrain.Trainer, "train_step",
                        lambda self, state, x, y: (
                            {**state, "step": state["step"] + 1},
                            {"loss": torch.tensor(1.0)}))
    assert jobs.main(["resnet50", "--device", "cpu", "--steps", "1",
                      "--batch-per-chip", "1", "--image-size", str(size),
                      "--depth", "18"]) == 0
    capsys.readouterr()
    cfg = seen[0]
    assert (cfg.stem, cfg.image_size, cfg.batch_size) == (stem, size, 1)
    assert (cfg.total_steps, cfg.warmup_steps, cfg.depth) == (1, 1, 18)
    assert (cfg.dw_dot_max_k, cfg.conv_bwd, cfg.fused_bn) == (0, "dot", False)


@pytest.mark.parametrize("flag,value", [("--mesh", "dp:2"),
                                        ("--ckpt-dir", "ckpt")])
def test_resnet50_unported_flags_raise(flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jobs.main(["resnet50", *RESNET_TINY, "--steps", "1", flag, value])
