"""Checkpoints under a mesh (``workloads/checkpoint.py``) on 4 gloo ranks:
the LM trained 2 steps at (fsdp 2, tp 2) from JAX weights and saved, then
restored at dp 4 and on one device (this process), every tensor of the
layout-free state equal bit for bit to the file's; 2 steps, a save, a
restore into a state of another seed and 2 more steps equal 4
uninterrupted steps bit for bit, for the LM at (fsdp 2, tp 2) and the
ResNet (its BatchNorm running statistics included) at (dp 2, fsdp 2); a
checkpoint of the one-device format restores on one device and is refused
under fsdp splits."""

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.bridge import params_from_jax
from kubeoperator_tpu_torch.workloads import checkpoint
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads import train as ttrain
from kubeoperator_tpu_torch.workloads.checkpoint import WorkloadCheckpointer
from test_torch_bridge import jax_params, tokens
from test_torch_checkpoint import JCFG, lm_state
from torch_dist_cases import spawn_group

torch.set_num_threads(2)

RESNET = ttrain.TrainConfig(batch_size=4, image_size=32, num_classes=10,
                            depth=18, warmup_steps=2, total_steps=10,
                            dtype=torch.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("checkpoint")
    rng = np.random.default_rng(6)
    inputs = {"workdir": str(workdir),
              "lm_cfg": lm_state()["model"].cfg,
              "lm_params": params_from_jax(jax_params(JCFG, seed=4), JCFG),
              "tokens": torch.from_numpy(tokens(4, 16, 64, seed=2)).long(),
              "resnet_cfg": RESNET,
              "x": torch.from_numpy(rng.standard_normal(
                  (4, 32, 32, 3)).astype(np.float32)),
              "y": torch.tensor([0, 3, 6, 9])}
    ranks = spawn_group("checkpoint", 4, workdir, inputs)
    return workdir, ranks


def assert_same(got: dict, want: dict, where: str = "") -> None:
    """Two layout-free states (nested dicts of tensors and numbers) equal
    bit for bit."""
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}/{i}")
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    else:
        assert got == want, where


def saved(workdir, name: str, step: int) -> dict:
    return torch.load(workdir / name / f"step_{step}.pt", weights_only=True)


def test_a_mesh_checkpoint_restores_at_dp4_bit_for_bit(runs):
    workdir, ranks = runs
    want = saved(workdir, "lm", 2)
    assert want["step"] == 2 and want["format"] == checkpoint.FORMAT
    for r in ranks:
        assert_same(r["lm_restore_dp4"], want)


def test_a_mesh_checkpoint_restores_on_one_device_bit_for_bit(runs):
    workdir, _ = runs
    want = saved(workdir, "lm", 2)
    trainer = tlm.LMTrainer(lm_state()["model"].cfg, device="cpu")
    state = WorkloadCheckpointer(str(workdir / "lm")).restore(
        trainer.init_state(seed=3))
    assert_same(checkpoint.layout_free(state["step"], state, {}, None), want)
    # and the moments step on: AdamW's state is whole and by name
    assert {len(s) for s in state["opt"].state.values()} == {3}


@pytest.mark.parametrize("case", ["lm_fsdp2_tp2_resume",
                                  "resnet_dp2_fsdp2_resume"])
def test_two_and_two_resumed_steps_equal_four(runs, case):
    _, ranks = runs
    for r in ranks:
        got = r[case]
        assert got["resumed_losses"] == got["losses"][2:]
        assert_same(got["resumed_state"], got["state"])
    if case.startswith("resnet"):
        assert any(k.endswith("bn1.mean") for k in got["state"]["model"])


def test_a_one_device_checkpoint_restores_where_every_param_is_whole(
        tmp_path):
    """A file of the one-device format (the model's and optimizer's
    state_dicts) restores on one device; under fsdp splits it raises."""
    state = lm_state(seed=2)
    trainer = tlm.LMTrainer(state["model"].cfg, device="cpu")
    state, _ = trainer.train_step(state, torch.zeros(2, 16, dtype=torch.long))
    torch.save({"step": 1, "model": state["model"].state_dict(),
                "opt": state["opt"].state_dict()}, tmp_path / "step_1.pt")
    back = WorkloadCheckpointer(str(tmp_path)).restore(lm_state(seed=5))
    assert back["step"] == 1
    for (name, a), b in zip(state["model"].state_dict().items(),
                            back["model"].state_dict().values()):
        assert torch.equal(a, b), name
    split = WorkloadCheckpointer(str(tmp_path),
                                 placements={"embedding": (None, "fsdp")})
    with pytest.raises(ValueError, match="one-device format"):
        split.restore(lm_state(seed=5))
