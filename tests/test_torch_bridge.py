"""Param bridge of the PyTorch port: flax Transformer params (stacked or
unrolled layers, fused or split qkv) load into the port's Transformer and
give the JAX logits. Also holds the helpers the other test_torch_* files
share."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeoperator_tpu.workloads import transformer as jtr
from kubeoperator_tpu_torch.bridge import params_from_jax
from kubeoperator_tpu_torch.workloads import transformer as ttr

torch.set_num_threads(2)

JAX_TINY = jtr.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                 n_layers=2, d_ff=128, max_seq_len=128,
                                 dtype=jnp.float32, remat=False,
                                 attention="dense")

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_cfg(jcfg: jtr.TransformerConfig) -> ttr.TransformerConfig:
    """The port's config with the same fields as a JAX config."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ttr.TransformerConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    return ttr.TransformerConfig(**fields)


def jax_params(jcfg: jtr.TransformerConfig, seed: int = 0) -> dict:
    """Unboxed flax params of ``Transformer(jcfg)`` from a seed, as numpy."""
    model = jtr.Transformer(jcfg)
    tokens = jnp.zeros((1, 8), jnp.int32)
    params = nn.unbox(model.init(jax.random.key(seed), tokens)["params"])
    return jax.tree.map(np.asarray, params)


def port_model(jcfg: jtr.TransformerConfig, params: dict) -> ttr.Transformer:
    model = ttr.Transformer(port_cfg(jcfg))
    model.load_state_dict(params_from_jax(params, jcfg))
    return model


def tokens(b: int, t: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def jax_logits(jcfg, params, toks) -> np.ndarray:
    return np.asarray(jtr.Transformer(jcfg).apply({"params": params},
                                                  jnp.asarray(toks)))


def port_logits(model, toks) -> np.ndarray:
    with torch.no_grad():
        return model(torch.as_tensor(toks, dtype=torch.long)).numpy()


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("fused_qkv", [False, True])
def test_bridged_params_give_jax_logits(scan_layers, fused_qkv):
    jcfg = dataclasses.replace(JAX_TINY, scan_layers=scan_layers,
                               fused_qkv=fused_qkv)
    params = jax_params(jcfg, seed=3)
    model = port_model(jcfg, params)
    toks = tokens(2, 16, jcfg.vocab_size, seed=1)
    np.testing.assert_allclose(port_logits(model, toks),
                               jax_logits(jcfg, params, toks),
                               atol=1e-4, rtol=1e-4)


def test_stacked_and_unrolled_trees_bridge_alike():
    """Unstacking the scan tree by hand into layers_{i} gives the same
    state dict: the bridge reads both layouts the same way."""
    params = jax_params(JAX_TINY, seed=0)
    unrolled = dict(params)
    unrolled["layers"] = {
        f"layers_{i}": jax.tree.map(lambda x: x[i], params["layers"])
        for i in range(JAX_TINY.n_layers)}
    a = params_from_jax(params, JAX_TINY)
    b = params_from_jax(unrolled, JAX_TINY)
    assert a.keys() == b.keys()
    for key in a:
        torch.testing.assert_close(a[key], b[key], atol=0, rtol=0)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_state_dict_names_and_shapes_match_the_port(fused_qkv):
    jcfg = dataclasses.replace(JAX_TINY, fused_qkv=fused_qkv)
    sd = params_from_jax(jax_params(jcfg), jcfg)
    want = ttr.Transformer(port_cfg(jcfg)).state_dict()
    assert sd.keys() == want.keys()
    for key, value in sd.items():
        assert value.shape == want[key].shape, key
        assert value.dtype == torch.float32, key


@pytest.mark.parametrize("scan_layers", [True, False])
def test_moe_tree_is_refused(scan_layers):
    """MoE trees are bridged now: ``moe/router/kernel``, ``moe/w_gate``,
    ``moe/w_up`` and ``moe/w_down`` of the stacked and the unrolled tree
    land on the port's ``MoEMlp`` names and shapes, and the logits are
    JAX's."""
    jcfg = dataclasses.replace(JAX_TINY, moe_experts=4,
                               scan_layers=scan_layers)
    params = jax_params(jcfg, seed=4)
    sd = params_from_jax(params, jcfg)
    want = ttr.Transformer(port_cfg(jcfg)).state_dict()
    assert sd.keys() == want.keys()
    assert {k for k in sd if ".moe." in k} == {
        f"layers.{i}.moe.{n}" for i in range(2)
        for n in ("router", "w_gate", "w_up", "w_down")}
    for key, value in sd.items():
        assert value.shape == want[key].shape, key
    toks = tokens(2, 16, jcfg.vocab_size, seed=1)
    np.testing.assert_allclose(port_logits(port_model(jcfg, params), toks),
                               jax_logits(jcfg, params, toks),
                               atol=1e-4, rtol=1e-4)
