"""The port's KV-cached generate() against the JAX package's in f32: greedy
tokens equal for uniform prompts, mixed prompt_lens with prefill_len, and
max_new_tokens=0. Sampling is checked within the port: deterministic per
(seed, row, position) and blind to appended pad rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads.generate import generate as jax_generate
from kubeoperator_tpu.workloads.transformer import TransformerConfig
from kubeoperator_tpu_torch.workloads.generate import generate, row_seed
from test_torch_bridge import jax_params, port_cfg, port_model

torch.set_num_threads(2)

JCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq_len=24, dtype=jnp.float32,
                         remat=False, attention="dense")
CFG = port_cfg(JCFG)


@pytest.fixture(scope="module", params=[False, True], ids=["split", "fused"])
def pair(request):
    jcfg = dataclasses.replace(JCFG, fused_qkv=request.param)
    params = jax_params(jcfg, seed=7)
    return jcfg, params, port_model(jcfg, params)


def both(pair, prompt, max_new, **kw):
    jcfg, params, model = pair
    params = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jax_generate(jcfg, params, jnp.asarray(prompt, jnp.int32),
                                   max_new_tokens=max_new, **kw))
    kw = {k: (np.asarray(v).tolist() if k == "prompt_lens" else v)
          for k, v in kw.items()}
    got = generate(port_cfg(jcfg), model, prompt, max_new_tokens=max_new,
                   device="cpu", **kw).numpy()
    return got, want


def test_greedy_uniform_prompts_match_jax(pair):
    prompt = np.array([[3, 11, 5, 22], [9, 2, 40, 1]])
    got, want = both(pair, prompt, 8)
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prefill_len", [1, 2])
def test_greedy_mixed_prompt_lens_match_jax(pair, prefill_len):
    prompt = np.array([[3, 11, 5, 22, 7], [9, 2, 0, 0, 0], [4, 4, 8, 0, 0]])
    lens = jnp.asarray([5, 2, 3], jnp.int32)
    got, want = both(pair, prompt, 6, prompt_lens=lens,
                     prefill_len=prefill_len)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :5], prompt[0])


def test_zero_new_tokens_returns_the_prompt(pair):
    prompt = np.array([[3, 11, 5], [9, 2, 40]])
    got, want = both(pair, prompt, 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, prompt)


def test_greedy_tokens_are_argmax_of_the_full_forward(pair):
    _, _, model = pair
    prompt = np.array([[5, 6, 7], [1, 2, 3]])
    out = generate(CFG, model, prompt, max_new_tokens=5, device="cpu")
    with torch.no_grad():
        for t in range(3, 8):
            logits = model(out[:, :t])
            assert torch.equal(out[:, t], logits[:, -1].argmax(-1))


def _sample(model, prompt, seed, **kw):
    return generate(CFG, model, prompt, max_new_tokens=8, temperature=0.8,
                    seed=seed, device="cpu", **kw).numpy()


def test_sampling_is_deterministic_per_seed(pair):
    _, _, model = pair
    prompt = np.array([[1, 2], [3, 4]])
    a, b = _sample(model, prompt, 5), _sample(model, prompt, 5)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and (a < CFG.vocab_size).all()
    assert not np.array_equal(a, _sample(model, prompt, 6))


def test_sampling_ignores_appended_pad_rows(pair):
    _, _, model = pair
    prompt = np.array([[1, 2, 9], [3, 4, 0]])
    lens = [3, 2]
    alone = _sample(model, prompt, 3, prompt_lens=lens)
    padded = _sample(model, np.concatenate([prompt, np.zeros((2, 3), int)]), 3,
                     prompt_lens=lens + [1, 1])
    np.testing.assert_array_equal(padded[:2], alone)


def test_row_seed_depends_on_each_of_seed_row_position():
    base = row_seed(1, 2, 3)
    assert base == row_seed(1, 2, 3)
    assert len({base, row_seed(0, 2, 3), row_seed(1, 1, 3),
                row_seed(1, 2, 4)}) == 4


def test_guards(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="exceed max_seq_len"):
        generate(CFG, model, np.zeros((1, 20), int), max_new_tokens=10,
                 device="cpu")
    with pytest.raises(ValueError, match="outside"):
        generate(CFG, model, np.zeros((1, 4), int), max_new_tokens=2,
                 prefill_len=5, device="cpu")
    with pytest.raises(ValueError, match="shortest prompt"):
        generate(CFG, model, np.zeros((2, 4), int), max_new_tokens=2,
                 prompt_lens=[4, 2], prefill_len=3, device="cpu")
