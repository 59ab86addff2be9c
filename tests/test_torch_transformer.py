"""The port's Transformer against the JAX package's on the same params and
tokens: logits in f32 (atol 1e-4) and bf16 (atol 3e-2), causal and
bidirectional, fused and split qkv, dense and flash attention (a small
flash block so the kernel grid has several blocks); and the remat
policies, which must not change a gradient."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import transformer as jtr
from kubeoperator_tpu_torch.workloads import transformer as ttr
from test_torch_bridge import (
    JAX_TINY, jax_logits, jax_params, port_logits, port_model, tokens,
)

torch.set_num_threads(2)

TOL = {jnp.float32: 1e-4, jnp.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fused_qkv", [False, True])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_match_jax(dtype, causal, fused_qkv, attention):
    jcfg = dataclasses.replace(JAX_TINY, dtype=dtype, causal=causal,
                               fused_qkv=fused_qkv, attention=attention,
                               flash_block=32)
    params = jax_params(jcfg, seed=5)
    toks = tokens(2, 64, jcfg.vocab_size, seed=6)
    got = port_logits(port_model(jcfg, params), toks)
    assert got.dtype == np.float32 and got.shape == (2, 64, jcfg.vocab_size)
    np.testing.assert_allclose(got, jax_logits(jcfg, params, toks),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_bf16_logits_matmul_matches_jax():
    jcfg = dataclasses.replace(JAX_TINY, dtype=jnp.bfloat16, logits_bf16=True)
    params = jax_params(jcfg, seed=2)
    toks = tokens(2, 32, jcfg.vocab_size, seed=2)
    np.testing.assert_allclose(port_logits(port_model(jcfg, params), toks),
                               jax_logits(jcfg, params, toks),
                               atol=3e-2, rtol=3e-2)


def test_rope_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.arange(5, 13)
    np.testing.assert_allclose(
        ttr.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jtr.rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-6, rtol=1e-6)


def test_rmsnorm_promotes_bf16_to_f32_like_flax():
    x = torch.randn(2, 4, 8).to(torch.bfloat16)
    assert ttr.RMSNorm(8)(x).dtype == torch.float32


def test_flops_per_token_matches_jax():
    cfg = jtr.TransformerConfig(vocab_size=32_000, d_model=2048, n_heads=16,
                                n_layers=4, d_ff=8192)
    from test_torch_bridge import port_cfg
    assert ttr.flops_per_token(port_cfg(cfg), 2048) == jtr.flops_per_token(cfg, 2048)


def _grads(model, toks):
    model.zero_grad(set_to_none=True)
    logits = model(torch.as_tensor(toks, dtype=torch.long))
    (logits.float() ** 2).mean().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("policy", ["dots", "dots+attn", "attn", "all"])
def test_remat_policies_keep_gradients(attention, policy):
    """Selective checkpointing only moves work between forward and
    backward: every policy gives the no-remat gradients."""
    jcfg = dataclasses.replace(JAX_TINY, attention=attention, flash_block=32)
    params = jax_params(jcfg, seed=4)
    toks = tokens(2, 64, jcfg.vocab_size, seed=4)
    want = _grads(port_model(jcfg, params), toks)
    remat = port_model(dataclasses.replace(jcfg, remat=True,
                                           remat_policy=policy), params)
    got = _grads(remat, toks)
    for name in want:
        torch.testing.assert_close(got[name], want[name], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("policy,forward_runs", [
    ("dots+attn", 1), ("attn", 1), ("dots", 2), ("all", 2)])
def test_attn_policies_save_the_flash_output(monkeypatch, policy, forward_runs):
    """Under a policy naming attn the backward reuses the saved flash
    output; the others run the flash forward again in the recompute."""
    from kubeoperator_tpu_torch.workloads import flash_attention as tfa
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    jcfg = dataclasses.replace(JAX_TINY, attention="flash", flash_block=32,
                               remat=True, remat_policy=policy)
    model = port_model(jcfg, jax_params(jcfg, seed=1))
    _grads(model, tokens(1, 64, jcfg.vocab_size))
    assert len(calls) == forward_runs * jcfg.n_layers


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(ttr.TransformerConfig(), remat_policy="dots+mlp")
    with pytest.raises(ValueError, match="remat_policy"):
        ttr.Transformer(cfg)


def test_auto_attention_takes_dense_path_on_cpu():
    attn = ttr.Attention(ttr.TransformerConfig(attention="auto"))
    assert attn.flash_block(2048, on_cuda=False) is None
    assert attn.flash_block(2048, on_cuda=True) == 512
    assert attn.flash_block(1024, on_cuda=True) is None
    flash = ttr.Attention(ttr.TransformerConfig(attention="flash"))
    assert flash.flash_block(196, on_cuda=False) == 128


def test_moe_is_not_ported():
    """MoE is ported: a config with experts builds ``MoEMlp`` FFNs in
    place of the dense ``Mlp`` (JAX transformer.py:246-256), its forward
    returns the summed aux beside the logits, and ``flops_per_token``
    counts top_k SwiGLUs plus the router (JAX transformer.py:333-345)."""
    cfg = ttr.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, moe_experts=4,
                                dtype=torch.float32, remat=False)
    model = ttr.Transformer(cfg).reset_parameters(0)
    assert all(hasattr(b, "moe") and not hasattr(b, "mlp")
               for b in model.layers)
    assert model.layers[0].moe.w_gate.shape == (4, 32, 64)
    toks = torch.as_tensor(tokens(2, 16, 64, seed=1), dtype=torch.long)
    logits, aux = model(toks, return_aux=True)
    assert logits.shape == (2, 16, 64) and aux.dim() == 0 and aux > 0
    assert torch.equal(model(toks), logits)
    want = jtr.flops_per_token(
        jtr.TransformerConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64,
                              vocab_size=64, moe_experts=4), 16)
    assert ttr.flops_per_token(cfg, 16) == want
