"""Ring and Ulysses attention of the port on 4 gloo ranks, causal at (dp 2,
sp 2) and non-causal at sp 4, against the JAX package's
sharded_ring_attention / sharded_ulysses_attention on the same inputs (to
2e-5, the reference's own tolerance in tests/test_lm.py), and their
gradients against the port's reference_attention (to 5e-4); blockwise
attention and the one-rank ring in this process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import ring_attention as jra
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu.workloads.sharding import build_mesh as jbuild_mesh
from kubeoperator_tpu_torch.workloads import ring_attention as ra
from torch_dist_cases import spawn_group

torch.set_num_threads(2)

B, T, H, D = 4, 32, 4, 16
# case → (the JAX mesh, the JAX function, causal)
CASES = {
    "ring_dp2_sp2": (JMeshSpec(dp=2, sp=2), jra.sharded_ring_attention, True),
    "ulysses_dp2_sp2": (JMeshSpec(dp=2, sp=2), jra.sharded_ulysses_attention,
                        True),
    "ring_sp4_noncausal": (JMeshSpec(sp=4), jra.sharded_ring_attention,
                           False),
    "ulysses_sp4_noncausal": (JMeshSpec(sp=4), jra.sharded_ulysses_attention,
                              False),
}


def arrays(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((B, T, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "dout")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    a = arrays()
    res = spawn_group("ring", 4, tmp_path_factory.mktemp("ring"),
                      {n: torch.from_numpy(x) for n, x in a.items()})
    return a, res


def assemble(res: list, name: str, key: str) -> torch.Tensor:
    """The whole [B, T, H, D] tensor from the ranks' (dp, sp) blocks."""
    out = torch.empty(B, T, H, D)
    for r in res:
        blk, c = r[name][key], r[name]["coords"]
        rows, cols = blk.shape[0], blk.shape[1]
        out[c["dp"] * rows:(c["dp"] + 1) * rows,
            c["sp"] * cols:(c["sp"] + 1) * cols] = blk
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_matches_the_jax_sharded_attention(ranks, name):
    a, res = ranks
    spec, fn, causal = CASES[name]
    mesh = jbuild_mesh(spec, jax.devices()[:4])
    want = fn(mesh, *(jnp.asarray(a[n]) for n in "qkv"), causal=causal)
    np.testing.assert_allclose(assemble(res, name, "out").numpy(),
                               np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_reference_attention(ranks, name):
    a, res = ranks
    causal = CASES[name][2]
    q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in "qkv")
    out = ra.reference_attention(q, k, v, causal=causal)
    (out * torch.from_numpy(a["dout"])).sum().backward()
    for key, want in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        torch.testing.assert_close(assemble(res, name, key), want,
                                   atol=5e-4, rtol=5e-4,
                                   msg=lambda m: f"{key}: {m}")


def test_ulysses_refuses_heads_that_sp_does_not_divide(ranks):
    err = ranks[1][0]["ulysses_heads_indivisible"]["error"]
    assert err == "ulysses needs heads (3) divisible by sp (4)"


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax(causal):
    """K/V in chunks of 8 over T 32: the online-softmax merge of four
    blocks, against JAX's blockwise_attention and reference_attention."""
    a = arrays(1)
    got = ra.blockwise_attention(*(torch.from_numpy(a[n]) for n in "qkv"),
                                 causal=causal, chunk=8)
    jq, jk, jv = (jnp.asarray(a[n]) for n in "qkv")
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jra.blockwise_attention(jq, jk, jv, causal,
                                                        chunk=8)),
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jra.reference_attention(jq, jk, jv, causal)),
        atol=2e-5, rtol=2e-5)


def test_one_rank_ring_and_ulysses_are_plain_attention():
    a = arrays(2)
    q, k, v = (torch.from_numpy(a[n]) for n in "qkv")
    want = ra.reference_attention(q, k, v)
    torch.testing.assert_close(ra.ring_attention(q, k, v, None), want,
                               atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(ra.ulysses_attention(q, k, v, None), want,
                               atol=2e-5, rtol=2e-5)
