"""The port's ResNet and its trainer against the JAX package's
(``workloads/resnet.py``, ``workloads/train.py``), on the CPU in f32, on
the same variables carried by ``bridge.resnet_params_from_jax``: logits
and batch statistics for both stems at depths 18 and 50, XLA's SAME
padding at odd sizes, whole-model gradients in the configuration that runs
K7 and K8 (the reference's Pallas kernels running in interpret mode),
three trainer steps, and the optimizer and schedule against optax."""

import collections
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from kubeoperator_tpu.workloads import resnet as jrn
from kubeoperator_tpu.workloads import train as jtrain
from kubeoperator_tpu_torch.bridge import resnet_params_from_jax
from kubeoperator_tpu_torch.workloads import bn_fused as tbn
from kubeoperator_tpu_torch.workloads import conv_vjp as tcv
from kubeoperator_tpu_torch.workloads import resnet as trn
from kubeoperator_tpu_torch.workloads import train as ttrain

torch.set_num_threads(2)

# the slice's configuration: bench.py's ResNet-50 with both kernel modes on
SLICE = dict(stem="space_to_depth", dw_dot_max_k=1, conv_bwd="pallas",
             fused_bn=True)


def jax_variables(model, size: int, seed: int = 0) -> dict:
    """flax variables of ``model`` at size² images, filled from a numpy
    seed (kernels N(0, 1/fan_in), BN scales 1 ± 0.2, biases, running mean
    and head ±0.1, running var 1-1.1): no init is compiled, and no scale
    is zero, so every block's branch carries gradient."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            std = 1 / np.sqrt(np.prod(s.shape[:-1]))
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (1 + 0.1 * rng.random(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_model(variables, size, depth, **kw) -> trn.ResNet:
    model = trn.ResNet(num_classes=10, depth=depth, width=8,
                       dtype=torch.float32, image_size=size, **kw)
    model.load_state_dict(resnet_params_from_jax(
        variables, ttrain.TrainConfig(depth=depth)))
    return model


@pytest.mark.parametrize("depth,stem,size", [
    (18, "conv", 32), (18, "space_to_depth", 32),
    # depth 50 at 64²: at 32² its last stage is 1×1, and batch statistics
    # over 4 values make f32 logits ill-conditioned
    (50, "conv", 64), (50, "space_to_depth", 64),
    (18, "conv", 33)])              # odd: asymmetric SAME pads on the stem
def test_logits_and_batch_stats_match_flax(depth, stem, size):
    jm = jrn.ResNet(num_classes=10, depth=depth, width=8, dtype=jnp.float32,
                    stem=stem)
    v = jax_variables(jm, size)
    x = np.random.default_rng(1).standard_normal(
        (4, size, size, 3)).astype(np.float32)
    run = jax.jit(lambda v, x: (jm.apply(v, x, train=True,
                                         mutable=["batch_stats"]),
                                jm.apply(v, x, train=False)))
    (want, upd), want_eval = run(v, x)
    pm = port_model(v, size, depth, stem=stem)
    pm.eval()
    got_eval = pm(torch.from_numpy(x))
    pm.train()
    got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.detach().numpy(), want_eval,
                               atol=1e-5, rtol=1e-5)
    # batch statistics amplify f32 rounding through 16 blocks: depth 50's
    # train-mode logits differ by up to 6e-4 here (depth 18's by 1e-5),
    # and by 3e-7 when both sides run in float64
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-3,
                               rtol=2e-3)
    stats = resnet_params_from_jax({"params": {}, **upd},
                                   ttrain.TrainConfig(depth=depth))
    sd = pm.state_dict()
    for name, value in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), value.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("size", [9, 10, 33, 112])
def test_max_pool_pads_like_xla(size):
    y = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)

    def f(t):
        return (nn.max_pool(t, (3, 3), strides=(2, 2), padding="SAME")
                ** 2).sum()

    want, want_grad = nn.max_pool(y, (3, 3), strides=(2, 2),
                                  padding="SAME"), jax.grad(f)(y)
    yt = torch.from_numpy(y).requires_grad_()
    got = trn.max_pool_same(yt, 3, 2)
    (got ** 2).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(yt.grad.numpy(), want_grad, atol=1e-6)


def test_whole_model_grads_in_the_k7_k8_configuration(monkeypatch):
    """Depth 50, width 8, 224², batch 8: N % 128 == 0 at 56² and 28², so
    the reference's Pallas kernels (and the port's K7/K8 routes) run there
    and the dot fallbacks at 14² and 7². In float64 the two agree to 3e-7;
    in f32 flax's own gradients are 4-6% (relative norm, worst parameter)
    away from its float64 ones at this size, and the port's are closer to
    them than that: the limit allows that conditioning, and a gradient
    taken by the wrong route is off by O(1)."""
    calls = {"k7": 0, "k8": 0}
    k7, k8 = tcv.conv1x1_bwd, tbn.conv_bn_relu_bwd

    def spy(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tcv, "conv1x1_bwd", spy("k7", k7))
    monkeypatch.setattr(tbn, "conv_bn_relu_bwd", spy("k8", k8))
    jm = jrn.ResNet(num_classes=10, depth=50, width=8, dtype=jnp.float32,
                    **SLICE)
    v = jax_variables(jm, 224, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)

    def loss(p):
        logits, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                             x, train=True, mutable=["batch_stats"])
        return jtrain.cross_entropy(logits, y, 0.1)

    assert str(jax.make_jaxpr(jax.grad(loss))(v["params"])).count(
        "pallas_call") == 16                 # 7 of K7, 9 of K8
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(v["params"])
    pm = port_model(v, 224, 50, **SLICE)
    # the gradient reaching each K7/K8 unit is a contiguous NHWC tensor, so
    # its [N, C] view costs no copy
    contiguous = []

    def watch(module, inputs, out):
        out.register_hook(lambda g: contiguous.append(g.is_contiguous()))

    for m in pm.modules():
        if isinstance(m, tbn.FusedConvBN) or getattr(m, "bwd_impl", None):
            m.register_forward_hook(watch)
    assert sum(isinstance(m, tbn.FusedConvBN) for m in pm.modules()) == 9
    got_loss = ttrain.cross_entropy(pm(torch.from_numpy(x)),
                                    torch.from_numpy(y), 0.1)
    got_loss.backward()
    assert calls == {"k7": 7, "k8": 9}
    assert contiguous and all(contiguous)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = resnet_params_from_jax({"params": want_grads},
                                  ttrain.TrainConfig(depth=50))
    for name, p in pm.named_parameters():
        err = float((p.grad - want[name]).norm() / want[name].norm())
        assert err < 0.15, f"{name}: relative norm error {err}"


def test_whole_model_grads_agree_in_float64():
    """The same model and bridge in float64, both sides: depth 50 with the
    dot-form 1×1 backward (K7's and K8's plain versions accumulate in f32
    by design, as the Pallas kernels do, so they stay out of this test;
    the head is f32 in both, as flax's ``Dense(dtype=float32)`` is). What
    the f32 tests above allow for conditioning is not there."""
    fields = dict(num_classes=10, depth=50, width=8, stem="space_to_depth",
                  dw_dot_max_k=1, conv_bwd="dot")
    jm = jrn.ResNet(dtype=jnp.float64, **fields)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 64, 64, 3))
    y = rng.integers(0, 10, 4).astype(np.int32)
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: a.astype(np.float64),
                         jax_variables(jm, 64, seed=7))

        def loss(p):
            logits, _ = jm.apply({"params": p,
                                  "batch_stats": v["batch_stats"]}, x,
                                 train=True, mutable=["batch_stats"])
            return jtrain.cross_entropy(logits, y, 0.1)

        want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(
            v["params"])
        want_grads = jax.tree.map(np.asarray, want_grads)
    pm = trn.ResNet(dtype=torch.float64, image_size=64, **fields).double()
    pm.load_state_dict({k: t.double() for k, t in resnet_params_from_jax(
        v, ttrain.TrainConfig(depth=50)).items()})
    got_loss = ttrain.cross_entropy(pm(torch.from_numpy(x)),
                                    torch.from_numpy(y), 0.1)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    want = {k: t.double() for k, t in resnet_params_from_jax(
        {"params": jax.tree.map(lambda a: a.astype(np.float64), want_grads)},
        ttrain.TrainConfig(depth=50)).items()}
    for name, p in pm.named_parameters():
        err = float((p.grad - want[name]).norm() / want[name].norm())
        assert err < 1e-5, f"{name}: relative norm error {err}"


@pytest.fixture(scope="module")
def three_steps():
    """Three f32 steps of the JAX Trainer and of the port's on one batch,
    ResNet-18 at 32² with the custom-backward 1×1 convs (K7 mode), from
    the same initial variables."""
    fields = dict(batch_size=4, image_size=32, num_classes=10, depth=18,
                  warmup_steps=2, total_steps=10, dw_dot_max_k=1,
                  conv_bwd="pallas")
    jt = jtrain.Trainer(jtrain.TrainConfig(dtype=jnp.float32, **fields),
                        devices=jax.devices()[:1])
    state = jt.init_state(jax.random.key(0))
    start = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = np.array([1, 3, 5, 7], np.int32)
    jlosses = []
    for _ in range(3):
        state, metrics = jt.train_step(state, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(metrics["loss"]))
    cfg = ttrain.TrainConfig(dtype=torch.float32, **fields)
    pt = ttrain.Trainer(cfg, device="cpu")
    pstate = pt.init_state(params=resnet_params_from_jax(start, cfg))
    plosses = []
    for _ in range(3):
        pstate, pmetrics = pt.train_step(pstate, torch.from_numpy(x),
                                         torch.from_numpy(y))
        plosses.append(float(pmetrics["loss"]))
    want = resnet_params_from_jax(
        jax.tree.map(np.asarray, {"params": state.params,
                                  "batch_stats": state.batch_stats}), cfg)
    return dict(jlosses=jlosses, plosses=plosses, want=want,
                got=pstate["model"].state_dict(), step=pstate["step"],
                jstep=int(state.step))


def test_trainer_losses_match_jax(three_steps):
    np.testing.assert_allclose(three_steps["plosses"], three_steps["jlosses"],
                               rtol=1e-5)
    assert three_steps["step"] == three_steps["jstep"] == 3


def test_trainer_params_and_batch_stats_match_jax(three_steps):
    got, want = three_steps["got"], three_steps["want"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_nesterov_sgd_with_masked_decay_matches_optax():
    """optax's chain(add_decayed_weights(mask ndim > 1), sgd(schedule,
    momentum, nesterov=True)) and the port's SGD over four steps, the
    learning rate set per step from the schedule."""
    cfg = ttrain.TrainConfig(batch_size=512, warmup_steps=2, total_steps=6,
                             weight_decay=0.05)
    jcfg = jtrain.TrainConfig(batch_size=512, warmup_steps=2, total_steps=6,
                              weight_decay=0.05)
    rng = np.random.default_rng(5)
    params = {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
              "scale": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    tx = jtrain.make_optimizer(jcfg)
    jp, opt_state = jax.tree.map(jnp.asarray, params), None
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = ttrain.make_optimizer(cfg, tp.values())
    schedule = ttrain.lr_schedule(cfg)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(5, 20), (500, 50_000), (3, 2)])
def test_lr_schedule_matches_optax(warmup, total):
    fields = dict(batch_size=128, warmup_steps=warmup, total_steps=total)
    want = jtrain.lr_schedule(jtrain.TrainConfig(**fields))
    got = ttrain.lr_schedule(ttrain.TrainConfig(**fields))
    # optax takes the warmup as (0 − base)·(1 − t/w) + base in f32, which
    # cancels at small t (2e-5 relative at t = 1, w = 500)
    for step in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total,
                 total + 7):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-4,
                                   atol=1e-9)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 5).astype(np.int32)
    want = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 0.1)
    got = ttrain.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), 0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("depth,stem,size", [(50, "conv", 224),
                                             (50, "space_to_depth", 224),
                                             (18, "conv", 32)])
def test_flops_per_image_matches_jax(depth, stem, size):
    assert trn.flops_per_image(depth, size, 1000, stem=stem) == \
        jrn.flops_per_image(depth, size, 1000, stem=stem)


def test_trainer_config_is_the_jax_one():
    jf = {f.name: f.default for f in dataclasses.fields(jtrain.TrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttrain.TrainConfig)}
    jf.pop("dtype"), tf.pop("dtype")
    assert jf == tf
    assert ttrain.TrainConfig().dtype == torch.bfloat16


def test_unported_and_invalid_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trn.ResNet(pad_min_channels=128)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.Trainer(ttrain.TrainConfig(pad_min_channels=128), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trn.ResNet(depth=18, width=8, image_size=32, dw_dot_max_k=1,
                   conv_bwd="dot2")
    with pytest.raises(ValueError, match="depth >= 50"):
        trn.ResNet(depth=18, fused_bn=True)
    with pytest.raises(NotImplementedError, match="multi-device"):
        ttrain.Trainer(spec=ttrain.MeshSpec(dp=2), device="cpu")
    model = trn.ResNet(num_classes=4, depth=18, width=8, image_size=32)
    with pytest.raises(ValueError, match="built for 32"):
        model(torch.zeros(1, 64, 64, 3))


def test_fused_units_sit_where_the_jax_model_puts_them():
    """At 224² with fused_bn: stage 0 and block 0 of stage 1 (block input
    H·W ≥ 3136), the stride-1 projection fused, the strided one not."""
    model = trn.ResNet(num_classes=10, depth=50, width=8, image_size=224,
                       **SLICE)
    fused = [i for i, b in enumerate(model.blocks) if b.fused]
    assert fused == [0, 1, 2, 3]
    assert model.blocks[0].fused_proj and not model.blocks[3].fused_proj
    assert model.blocks[3].project


def test_fused_units_are_chip_smokes_k8_sites():
    """ResNet-50 at 224² with fused_bn, built and not run: its FusedConvBN
    units at batch 128, as (rows, ci, co, relu) with their count a step,
    are the K8 sites that chip_smoke.py times (``K8_SITES``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = trn.ResNet(num_classes=10, depth=50, image_size=224, **SLICE)
    batch, hw = 128, trn._after((112, 112), 2)     # s2d stem, max pool
    sites = collections.Counter()
    for blk in model.blocks:
        out_hw = trn._after(hw, blk.conv2.strides[0])
        units = ([(blk.fused1, hw), (blk.fused3, out_hw)]
                 + ([(blk.proj_fused, hw)] if blk.fused_proj else [])
                 if blk.fused else [])
        for unit, (h, w) in units:
            _, _, ci, co = unit.kernel.shape
            sites[(batch * h * w, ci, co, unit.relu)] += 1
        hw = out_hw
    assert dict(sites) == {s[:4]: s[4] for s in smoke.K8_SITES}


def test_trainer_synthetic_batch_and_seeded_init():
    cfg = ttrain.TrainConfig(batch_size=3, image_size=32, num_classes=10,
                             depth=18, dtype=torch.float32)
    tr = ttrain.Trainer(cfg, device="cpu")
    (xa, ya), (xb, yb) = tr.synthetic_batch(seed=1), tr.synthetic_batch(seed=1)
    assert xa.shape == (3, 32, 32, 3) and torch.equal(xa, xb)
    assert torch.equal(ya, yb) and int(ya.max()) < 10
    a, b = tr.init_state(seed=3)["model"], tr.init_state(seed=3)["model"]
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert not a.blocks[0].bn2.scale.any()            # zero-init last BN
    assert tr.flops_per_step() == 3 * trn.flops_per_image(
        18, 32, 10, stem="conv") * 3


def test_multi_step_runs_k_steps():
    cfg = ttrain.TrainConfig(batch_size=4, image_size=32, num_classes=10,
                             depth=18, dtype=torch.float32, warmup_steps=1,
                             learning_rate=0.5)
    tr = ttrain.Trainer(cfg, device="cpu")
    state = tr.init_state(seed=1)
    x, y = tr.synthetic_batch(seed=2)
    state, first = tr.train_step(state, x, y)
    state, metrics = tr.multi_step(5)(state, x, y)
    assert state["step"] == 6
    assert float(metrics["loss"]) < float(first["loss"])


def test_measure_needs_the_card():
    cfg = ttrain.TrainConfig(batch_size=2, image_size=32, num_classes=10,
                             depth=18, dtype=torch.float32)
    with pytest.raises(ValueError, match="no published peak"):
        ttrain.Trainer(cfg, device="cpu").measure(steps=1, warmup=1)
