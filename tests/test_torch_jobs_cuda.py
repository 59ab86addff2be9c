"""The one-device jobs' device parts on the card: the smoke job's matmul
and the dot2 conv backward (both 1×1 stride-1 gradients as products of
the library) against f32 products of the same bf16 inputs, and a
checkpoint restored onto the card. Imports no JAX, so it runs where the
card is:

    python -m pytest --noconftest -m gpu tests/test_torch_jobs_cuda.py

Without a card every test skips."""

import json

import pytest
import torch

from kubeoperator_tpu_torch.train import jobs
from kubeoperator_tpu_torch.workloads import conv_vjp as tcv
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads.checkpoint import WorkloadCheckpointer
from kubeoperator_tpu_torch.workloads.transformer import TransformerConfig

torch.set_num_threads(2)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this checks the device path")


@pytest.mark.gpu
def test_smoke_on_the_card(capsys):
    need_card()
    assert jobs.main(["smoke"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["ok"] and rec["matmul_sum"] == 16_777_216.0
    assert rec["platform"] == "gpu"
    assert rec["device_kind"] == torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,ci,co", [(25088, 256, 1024), (1000, 64, 192)])
def test_dot2_backward_on_the_card(n, ci, co):
    """dx and dW of a bf16 1×1 stride-1 conv in mode dot2 against the same
    products in f32, rounded to bf16: within a bf16 step where the f32
    sums round differently (rtol 2⁻⁷, the relative norm within 1e-2)."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 1, n, ci, device="cuda", generator=gen).bfloat16()
    w = (0.05 * torch.randn(1, 1, ci, co, device="cuda",
                            generator=gen)).bfloat16()
    g = torch.randn(1, 1, n, co, device="cuda", generator=gen).bfloat16()
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    tcv.make_conv((1, 1), "SAME", "dot2")(xg, wg).backward(g)
    dx = (g.float().reshape(n, co) @ w.float()[0, 0].t()).reshape(x.shape)
    dw = (x.float().reshape(n, ci).t() @ g.float().reshape(n, co))
    for got, want in ((xg.grad, dx), (wg.grad, dw.reshape(w.shape))):
        assert got.dtype == torch.bfloat16
        diff = (got.float() - want).abs()
        assert float((diff - 2 ** -7 * want.abs()).max()) <= 1e-2 * float(
            want.abs().max())
        assert float(diff.norm() / want.norm()) <= 1e-2


@pytest.mark.gpu
def test_checkpoint_restores_onto_the_card(tmp_path):
    """A state saved from the card and restored into a fresh state on the
    card: every tensor on the card and equal, the step back."""
    need_card()
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_seq_len=16,
                            dtype=torch.float32)
    trainer = tlm.LMTrainer(cfg)
    state = trainer.init_state(seed=1)
    tokens = trainer.synthetic_batch(2, 16)
    state, _ = trainer.train_step(state, tokens)
    ckpt = WorkloadCheckpointer(str(tmp_path))
    ckpt.save(1, state)
    back = ckpt.restore(trainer.init_state(seed=2))
    assert back["step"] == 1
    for (name, a), b in zip(state["model"].state_dict().items(),
                            back["model"].state_dict().values()):
        assert b.is_cuda and torch.equal(a, b), name
