"""The port's ViT against the JAX package's on the same params and images:
logits in f32 (1e-4, dense and flash-packed attention) and bf16 (3e-2),
the patch embedding against flax ``nn.Conv``, ``flops_per_image``, one
AdamW train step (loss, gradients and params at 1e-5 against optax), the
param bridge for stacked and unrolled layer trees, bidirectional
attention, and the remat policy that keeps the packed flash output."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from kubeoperator_tpu.workloads import vit as jvit
from kubeoperator_tpu.workloads.sharding import MeshSpec as JaxMeshSpec
from kubeoperator_tpu.workloads.transformer import TransformerConfig
from kubeoperator_tpu_torch.bridge import vit_params_from_jax
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads import vit as tvit
from test_torch_bridge import port_cfg

torch.set_num_threads(2)

# tests/test_vit.py's TINY: 32x32 images, 8x8 patches (T = 16), d64, 4
# heads, 2 layers
TINY = jvit.ViTConfig(num_classes=10, image_size=32, patch=8,
                      encoder=TransformerConfig(d_model=64, n_heads=4,
                                                n_layers=2, d_ff=128,
                                                causal=False, max_seq_len=16,
                                                dtype=jnp.float32,
                                                remat=False))
TOL = {jnp.float32: 1e-4, jnp.bfloat16: 3e-2}


def jax_cfg(dtype=jnp.float32, attention="dense", **enc) -> jvit.ViTConfig:
    """TINY with another encoder dtype and attention; ``flash`` is the
    packed layout at block 128 (T = 16 padded to 128)."""
    extra = ({"attention": "flash", "flash_layout": "packed",
              "flash_block": 128} if attention == "flash"
             else {"attention": attention})
    return dataclasses.replace(TINY, encoder=dataclasses.replace(
        TINY.encoder, dtype=dtype, **extra, **enc))


def vit_port_cfg(jcfg: jvit.ViTConfig) -> tvit.ViTConfig:
    return tvit.ViTConfig(num_classes=jcfg.num_classes,
                          image_size=jcfg.image_size, patch=jcfg.patch,
                          encoder=port_cfg(jcfg.encoder))


def images(b=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def jax_params(jcfg, seed=0):
    model = jvit.VisionTransformer(jcfg)
    dummy = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3), jnp.float32)
    params = nn.unbox(model.init(jax.random.key(seed), dummy,
                                 train=False)["params"])
    return jax.tree.map(np.asarray, params)


def jax_logits(jcfg, params, x):
    return np.asarray(jvit.VisionTransformer(jcfg).apply(
        {"params": params}, jnp.asarray(x)), np.float32)


def port_model(jcfg, params):
    model = tvit.VisionTransformer(vit_port_cfg(jcfg))
    model.load_state_dict(vit_params_from_jax(params, jcfg))
    return model


def port_logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_match_jax(dtype, attention):
    jcfg = jax_cfg(dtype, attention)
    params = jax_params(jcfg, seed=1)
    x = images(seed=2)
    got = port_logits(port_model(jcfg, params), x)
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got, jax_logits(jcfg, params, x),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("size", [32, 36])
def test_patch_embed_matches_flax_conv(size):
    """One matmul over (ph, pw, c)-ordered patches equals the stride-p
    VALID conv with bias, patches flattened row-major; a size that is not
    a multiple of the patch drops the same edge."""
    p, d = 8, 16
    conv = nn.Conv(d, (p, p), strides=(p, p), padding="VALID")
    x = images(size=size, seed=3)
    cp = conv.init(jax.random.key(4), jnp.asarray(x))["params"]
    cp = {"kernel": np.asarray(cp["kernel"]),
          "bias": np.random.default_rng(5).standard_normal(d).astype(np.float32)}
    want = np.asarray(conv.apply({"params": cp}, jnp.asarray(x)))
    want = want.reshape(x.shape[0], -1, d)
    embed = tvit.DenseBias((p, p, 3, d), d)
    embed.load_state_dict({k: torch.tensor(v) for k, v in cp.items()})
    with torch.no_grad():
        got = embed(tvit.patchify(torch.from_numpy(x), p), torch.float32)
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("jcfg", [jvit.ViTConfig(), TINY], ids=["b16", "tiny"])
def test_flops_per_image_matches_jax(jcfg):
    assert (tvit.flops_per_image(vit_port_cfg(jcfg))
            == jvit.flops_per_image(jcfg))


def test_default_config_is_vit_b16_on_the_packed_kernels():
    enc = tvit.ViTConfig().encoder
    jenc = jvit.ViTConfig().encoder
    for f in ("d_model", "n_heads", "n_layers", "d_ff", "causal",
              "max_seq_len", "attention", "flash_block", "remat_policy",
              "flash_layout", "scan_layers", "remat"):
        assert getattr(enc, f) == getattr(jenc, f), f
    assert enc.dtype == torch.bfloat16 and tvit.ViTConfig().seq_len == 196


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
def test_bridge_names_and_shapes(scan_layers):
    jcfg = jax_cfg(scan_layers=scan_layers)
    params = jax_params(jcfg)
    layers = params["layers"]
    assert ("layers_0" in layers) is not scan_layers
    sd = vit_params_from_jax(params, jcfg)
    want = tvit.VisionTransformer(vit_port_cfg(jcfg)).state_dict()
    assert set(sd) == set(want)
    for name, t in sd.items():
        assert t.shape == want[name].shape and t.dtype == torch.float32, name
    np.testing.assert_array_equal(sd["patch_embed.kernel"].numpy(),
                                  params["patch_embed"]["kernel"])
    assert sd["patch_embed.kernel"].shape == (8, 8, 3, 64)
    assert sd["head.kernel"].shape == (64, 10)


def test_attention_is_bidirectional():
    """Mirror of tests/test_vit.py: the same params under a causal mask
    give other logits, so the encoder does see the whole patch sequence."""
    jcfg = jax_cfg()
    params = jax_params(jcfg, seed=1)
    x = images(b=1)
    a = port_logits(port_model(jcfg, params), x)
    causal_cfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, causal=True))
    b = port_logits(port_model(causal_cfg, params), x)
    assert not np.allclose(a, b)
    np.testing.assert_allclose(b, jax_logits(causal_cfg, params, x),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("policy,forward_runs", [("dots+attn", 1),
                                                 ("dots", 2)])
def test_remat_policy_saves_the_packed_flash_output(monkeypatch, policy,
                                                    forward_runs):
    """Under ``dots+attn`` the backward reuses the saved packed flash
    output; ``dots`` runs K4 (here its plain version) again in the
    recompute. Both give the no-remat gradients."""
    from kubeoperator_tpu_torch.workloads import flash_attention as tfa
    jcfg = jax_cfg(attention="flash")
    params = jax_params(jcfg, seed=2)
    x = torch.from_numpy(images(seed=3))

    def grads(cfg):
        model = port_model(cfg, params)
        model(x).square().sum().backward()
        return {n: p.grad for n, p in model.named_parameters()}

    want = grads(jcfg)
    calls = []
    plain = tfa.flash_fwd_packed_plain
    monkeypatch.setattr(tfa, "flash_fwd_packed_plain",
                        lambda *a: calls.append(1) or plain(*a))
    got = grads(dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, remat=True, remat_policy=policy)))
    assert len(calls) == forward_runs * jcfg.encoder.n_layers
    for name in want:
        torch.testing.assert_close(got[name], want[name], atol=1e-6,
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def step_pair():
    """One f32 train step of the JAX ViTTrainer and of the port's, from
    the same params and batch."""
    jcfg = TINY
    x = images(b=4, seed=9)
    y = np.array([1, 7, 3, 3], np.int32)
    jt = jvit.ViTTrainer(jcfg, JaxMeshSpec(), devices=jax.devices()[:1])
    state = jt.init_state(jax.random.key(11))
    params = jax.tree.map(np.asarray, state["params"])

    def loss_fn(p):
        logits = jt.model.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jgrads = jax.tree.map(np.asarray, jax.grad(loss_fn)(state["params"]))
    new_state, metrics = jt.train_step(state, jnp.asarray(x), jnp.asarray(y))
    jnew = jax.tree.map(np.asarray, new_state["params"])

    pt = tvit.ViTTrainer(vit_port_cfg(jcfg), device="cpu")
    pstate = pt.init_state(params=vit_params_from_jax(params, jcfg))
    model = pstate["model"]
    px, py = torch.from_numpy(x), torch.from_numpy(y)
    ploss, _ = pt.loss(model, px, py)
    ploss.backward()
    pgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    pstate, pmetrics = pt.train_step(pstate, px, py)
    return dict(jcfg=jcfg, jloss=float(metrics["loss"]),
                jacc=float(metrics["accuracy"]), jgrads=jgrads, jnew=jnew,
                ploss=float(pmetrics["loss"]),
                pacc=float(pmetrics["accuracy"]), pgrads=pgrads,
                pnew=model.state_dict(), pstep=pstate["step"])


def test_train_loss_and_accuracy_match_jax(step_pair):
    np.testing.assert_allclose(step_pair["ploss"], step_pair["jloss"],
                               rtol=1e-5)
    assert step_pair["pacc"] == step_pair["jacc"]


def test_train_gradients_match_jax(step_pair):
    want = vit_params_from_jax(step_pair["jgrads"], step_pair["jcfg"])
    for name, g in step_pair["pgrads"].items():
        torch.testing.assert_close(g, want[name], atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


def test_adamw_step_matches_optax(step_pair):
    want = vit_params_from_jax(step_pair["jnew"], step_pair["jcfg"])
    for name, p in step_pair["pnew"].items():
        torch.testing.assert_close(p, want[name], atol=1e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")
    assert step_pair["pstep"] == 1


def test_multi_step_runs_k_steps_and_reduces_loss():
    tr = tvit.ViTTrainer(vit_port_cfg(TINY), device="cpu",
                         learning_rate=1e-3)
    state = tr.init_state(seed=1)
    x, y = tr.synthetic_batch(8, seed=2)
    state, first = tr.train_step(state, x, y)
    state, metrics = tr.multi_step(6)(state, x, y)
    assert state["step"] == 7
    assert float(metrics["loss"]) < float(first["loss"])


def test_synthetic_batch_is_seeded_and_shaped():
    tr = tvit.ViTTrainer(vit_port_cfg(TINY), device="cpu")
    (xa, ya), (xb, yb) = tr.synthetic_batch(3, seed=1), tr.synthetic_batch(3, seed=1)
    assert xa.shape == (3, 32, 32, 3) and ya.shape == (3,)
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert int(ya.min()) >= 0 and int(ya.max()) < 10


def test_seeded_init_is_deterministic_with_zero_biases():
    a = tvit.VisionTransformer(vit_port_cfg(TINY)).reset_parameters(3)
    b = tvit.VisionTransformer(vit_port_cfg(TINY)).reset_parameters(3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert not a.patch_embed.bias.any() and not a.head.bias.any()
    bound = 2 * (1 / (8 * 8 * 3)) ** 0.5 / 0.87962566103423978
    assert float(a.patch_embed.kernel.detach().abs().max()) <= bound + 1e-6


def test_mesh_beyond_one_device_is_refused():
    with pytest.raises(NotImplementedError, match="multi-device"):
        tvit.ViTTrainer(vit_port_cfg(TINY), spec=tlm.MeshSpec(dp=2),
                        device="cpu")


def test_measure_needs_the_card():
    tr = tvit.ViTTrainer(vit_port_cfg(TINY), device="cpu")
    with pytest.raises(ValueError, match="no published peak"):
        tr.measure(batch=1, steps=1, warmup=1, steps_per_call=2, repeats=1)
