"""The port's flash attention against the JAX package's (Pallas kernels in
interpret mode on the CPU), forward and gradients, at the tolerances of
tests/test_flash.py. The CUDA kernels against their plain versions are in
test_torch_flash_cuda.py, which runs on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads.flash_attention import (
    flash_attention as jax_flash,
)
from kubeoperator_tpu_torch.workloads import flash_attention as tfa
from kubeoperator_tpu_torch.workloads.ring_attention import reference_attention

torch.set_num_threads(2)


def qkv(b=2, t=256, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def port_forward(arrays, causal, block):
    q, k, v = (torch.from_numpy(x) for x in arrays)
    return tfa.flash_attention(q, k, v, causal=causal, block=block).numpy()


def jax_forward(arrays, causal, block):
    q, k, v = (jnp.asarray(x) for x in arrays)
    return np.asarray(jax_flash(q, k, v, causal=causal, block=block))


def port_grads(arrays, causal, block):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in arrays)
    (tfa.flash_attention(q, k, v, causal=causal, block=block) ** 2).sum().backward()
    return [x.grad.numpy() for x in (q, k, v)]


def jax_grads(arrays, causal, block):
    def loss(q, k, v):
        return (jax_flash(q, k, v, causal=causal, block=block) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in arrays))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal):
    arrays = qkv()
    np.testing.assert_allclose(port_forward(arrays, causal, 128),
                               jax_forward(arrays, causal, 128),
                               atol=2e-5, rtol=2e-5)


def test_forward_multi_block_matches_jax():
    arrays = qkv(t=512)
    np.testing.assert_allclose(port_forward(arrays, True, 128),
                               jax_forward(arrays, True, 128),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    arrays = qkv(b=1, t=128, h=2, d=32, seed=1)
    for name, a, b in zip("qkv", port_grads(arrays, causal, 64),
                          jax_grads(arrays, causal, 64)):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [196, 100])
def test_ragged_forward_matches_jax(causal, t):
    """Ragged T is padded to the tile grid with the padded keys masked:
    the result equals JAX's (and the unpadded attention)."""
    arrays = qkv(t=t, seed=2)
    got = port_forward(arrays, causal, 128)
    np.testing.assert_allclose(got, jax_forward(arrays, causal, 128),
                               atol=2e-5, rtol=2e-5)
    dense = reference_attention(*(torch.from_numpy(x) for x in arrays),
                                causal=causal).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_gradients_match_jax(causal):
    arrays = qkv(b=1, t=100, h=2, d=32, seed=3)
    for name, a, b in zip("qkv", port_grads(arrays, causal, 64),
                          jax_grads(arrays, causal, 64)):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name} mismatch")


def test_plain_lse_is_logsumexp_of_masked_scores():
    q, k, v = (torch.from_numpy(x[:, :, 0]) for x in qkv(b=3, t=128, d=16))
    scale = 0.25
    _, lse = tfa.flash_fwd_plain(q, k, v, scale, True, 100)
    s = (q @ k.transpose(1, 2)) * scale
    keep = torch.ones(128, 128, dtype=torch.bool).tril()
    keep[:, 100:] = False
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), -1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    tfa.reset_launches()
    arrays = qkv(b=1, t=128, h=2, d=64)
    port_grads(arrays, True, 64)
    assert set(tfa.LAUNCHES) >= {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)


def test_padded_len_covers_block_and_tile():
    assert tfa.padded_len(2048, 512, 64) == 2048
    assert tfa.padded_len(196, 128, 64) == 256
    assert tfa.padded_len(100, 64, 64) == 128
    assert tfa.padded_len(100, 96, 64) == 192       # 192 = 2·96, tile-aligned

