"""The port's ``WorkloadCheckpointer`` (``workloads/checkpoint.py``) on
the CPU: JAX params carried by the bridge survive a save and a restore
into a fresh trainer state (the LM's logits at the JAX model's tolerance
and bit for bit against the saved model; the ResNet's eval logits with
its BatchNorm buffers), the optimizer's state and the step come back, the
newest ``max_to_keep`` are kept, and a partial save is never the
latest."""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import resnet as jrn
from kubeoperator_tpu.workloads.transformer import TransformerConfig
from kubeoperator_tpu_torch.bridge import (
    params_from_jax, resnet_params_from_jax,
)
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads import train as ttrain
from kubeoperator_tpu_torch.workloads.checkpoint import WorkloadCheckpointer
from test_torch_bridge import jax_logits, jax_params, port_cfg, tokens

torch.set_num_threads(2)

JCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq_len=16, dtype=jnp.float32,
                         remat=False, attention="dense")


def lm_state(seed=0, params=None):
    return tlm.LMTrainer(port_cfg(JCFG), device="cpu").init_state(
        params=params, seed=seed)


def test_bridged_lm_params_survive_save_and_restore(tmp_path):
    """JAX params → bridge → a trainer state, two steps (so AdamW has
    moments), save; restore into a state of another seed: the logits are
    the saved model's bit for bit, the params before training gave the
    JAX model's logits, and the step and AdamW moments come back."""
    params = jax_params(JCFG, seed=3)
    toks = tokens(2, 16, 64, seed=1)
    trainer = tlm.LMTrainer(port_cfg(JCFG), device="cpu")
    state = trainer.init_state(params=params_from_jax(params, JCFG))
    with torch.no_grad():
        fresh = state["model"](torch.from_numpy(toks).long())
    np.testing.assert_allclose(fresh.numpy(), jax_logits(JCFG, params, toks),
                               atol=1e-4, rtol=1e-4)
    batch = torch.from_numpy(toks).long()
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    ckpt = WorkloadCheckpointer(str(tmp_path))
    ckpt.save(state["step"], state)
    back = ckpt.restore(lm_state(seed=9))
    assert back["step"] == 2
    with torch.no_grad():
        assert torch.equal(back["model"](batch), state["model"](batch))
    for (p, s), (q, t) in zip(state["opt"].state.items(),
                              back["opt"].state.items()):
        assert torch.equal(p, q) and s.keys() == t.keys()
        for k in s:
            assert torch.equal(s[k], t[k]), k
    # the restored optimizer steps the restored params: both go on alike
    state, m1 = trainer.train_step(state, batch)
    back, m2 = trainer.train_step(back, batch)
    assert torch.equal(m1["loss"], m2["loss"])


def test_bridged_resnet_variables_survive_save_and_restore(tmp_path):
    """flax ResNet variables (params and batch stats) → bridge → a trainer
    state; save and restore into a fresh state: eval logits equal, the
    BatchNorm running statistics included."""
    jm = jrn.ResNet(num_classes=10, depth=18, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.key(2), jnp.zeros((1, 32, 32, 3)), train=False))
    cfg = ttrain.TrainConfig(batch_size=2, image_size=32, num_classes=10,
                             depth=18, dtype=torch.float32)
    trainer = ttrain.Trainer(cfg, device="cpu")
    state = trainer.init_state(params=resnet_params_from_jax(variables, cfg))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    state, _ = trainer.train_step(state, x, torch.tensor([1, 2]))
    ckpt = WorkloadCheckpointer(str(tmp_path))
    ckpt.save(1, state)
    back = ckpt.restore(trainer.init_state(seed=5))
    want = state["model"].eval()(x)
    assert torch.equal(back["model"].eval()(x), want)
    assert torch.equal(back["model"].stem_bn.mean, state["model"].stem_bn.mean)
    assert back["step"] == 1


def test_retention_keeps_the_newest(tmp_path):
    state = lm_state()
    ckpt = WorkloadCheckpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 5):
        ckpt.save(step, state)
    assert ckpt.steps() == [3, 5] and ckpt.latest_step() == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3.pt",
                                                          "step_5.pt"]
    ckpt.save(5, state)                     # the same step again replaces it
    assert ckpt.steps() == [3, 5]


def test_a_partial_save_is_never_the_latest(tmp_path):
    """A pod killed mid-save leaves only its temporary file: latest_step
    skips it and restore reads the last complete checkpoint."""
    state = lm_state()
    ckpt = WorkloadCheckpointer(str(tmp_path))
    ckpt.save(4, state)
    (tmp_path / ".step_8.pt.tmp123").write_bytes(b"\x80partial")
    (tmp_path / "step_8.pt.tmp").write_bytes(b"\x80partial")
    assert ckpt.latest_step() == 4
    assert ckpt.restore(lm_state(seed=1))["step"] == 4


def test_restore_needs_a_checkpoint(tmp_path):
    ckpt = WorkloadCheckpointer(str(tmp_path / "new"))
    assert (tmp_path / "new").is_dir() and ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore(lm_state())
    ckpt.close()


def test_a_save_is_synced_before_and_after_its_rename(tmp_path, monkeypatch):
    """The file is synced before the rename makes it the latest, and the
    directory after it, so the rename survives a lost node."""
    synced = []
    real = os.fsync

    def spy(fd):
        mode = os.fstat(fd).st_mode
        synced.append("dir" if stat.S_ISDIR(mode) else
                      sorted(p.name for p in tmp_path.iterdir()))
        real(fd)

    monkeypatch.setattr(os, "fsync", spy)
    WorkloadCheckpointer(str(tmp_path)).save(7, lm_state())
    tmp = f".step_7.pt.tmp{os.getpid()}"
    assert synced == [[tmp], "dir"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_7.pt"]


def test_the_first_save_sweeps_temporary_files(tmp_path):
    """Temporary files of saves cut short go at a checkpointer's first
    save; a reader that never saves leaves them, and other names stay."""
    for name in (".step_8.pt.tmp123", ".step_2.pt.tmp9"):
        (tmp_path / name).write_bytes(b"\x80partial")
    (tmp_path / "notes.txt").write_text("kept")
    ckpt = WorkloadCheckpointer(str(tmp_path))
    assert ckpt.latest_step() is None and len(list(tmp_path.iterdir())) == 3
    ckpt.save(1, lm_state())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["notes.txt",
                                                          "step_1.pt"]


def test_restore_falls_back_past_an_unreadable_latest(tmp_path):
    """A latest checkpoint that cannot be read is skipped with a warning
    for the next older one; one named by its step, or the only one left,
    raises."""
    ckpt = WorkloadCheckpointer(str(tmp_path))
    ckpt.save(2, lm_state(seed=2))
    ckpt.save(4, lm_state(seed=4))
    good = ckpt.path(4)
    with open(good, "rb") as f:
        data = f.read()
    with open(good, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.warns(UserWarning, match="step_4.pt cannot be read"):
        back = ckpt.restore(lm_state(seed=1))
    assert back["step"] == 2
    want = lm_state(seed=2)["model"].state_dict()
    for k, v in back["model"].state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises((OSError, RuntimeError)):
        ckpt.restore(lm_state(), step=4)
    os.remove(ckpt.path(2))
    with pytest.raises((OSError, RuntimeError)):
        ckpt.restore(lm_state())


def test_restore_model_reads_only_the_weights(tmp_path):
    """``restore_model`` fills a bare model with the saved weights and
    returns the step; the trainer state it came from had AdamW moments."""
    trainer = tlm.LMTrainer(port_cfg(JCFG), device="cpu")
    state = trainer.init_state(seed=3)
    batch = torch.from_numpy(tokens(2, 16, 64, seed=1)).long()
    state, _ = trainer.train_step(state, batch)
    ckpt = WorkloadCheckpointer(str(tmp_path))
    ckpt.save(state["step"], state)
    model = lm_state(seed=8)["model"]
    assert ckpt.restore_model(model) == 1
    with torch.no_grad():
        assert torch.equal(model(batch), state["model"](batch))
