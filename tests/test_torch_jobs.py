"""The port's ``llm`` job entry point on the CPU at a tiny size: it emits
loss lines, the sampled tokens and a done record, and refuses the flags
whose parts are not ported yet."""

import json

import pytest
import torch

from kubeoperator_tpu_torch.train import jobs

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--d-model", "32", "--heads", "4", "--layers", "2",
        "--d-ff", "64", "--seq-len", "16", "--vocab", "64", "--batch", "2"]


def run(capsys, *argv):
    assert jobs.main(["llm", *TINY, *argv]) == 0
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
