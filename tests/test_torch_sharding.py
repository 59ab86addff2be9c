"""The port's mesh and placement policy (workloads/sharding.py) against the
JAX package's: MeshSpec, the logical axis rules, place_by_shape over the
reference's own LM and ResNet-50 parameter trees, pack_stages, and the
multi-slice layout (``mesh_ranks`` against the reference's ``build_mesh``
on virtual slices, contiguous and interleaved, and its refusals); on 4
gloo ranks the built meshes (axis order, each rank's batch block, the
raise on a count mismatch), a tp psum over two slices, the refusals
before any collective, two ResNet-18 steps at (dp 2, fsdp 2) over two
slices against the JAX ``Trainer`` on the same virtual slices (1e-5, as
tests/test_torch_resnet_mesh.py), and the overlapped ZeRO-3 loss with
prefetch on and off, at fsdp 4 and (dp 2, fsdp 2), against the eager
step's loss (1e-6) and gradients (1e-5), as tests/test_overlap_fsdp.py
pins the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeoperator_tpu.workloads import resnet as jresnet
from kubeoperator_tpu.workloads import sharding as js
from kubeoperator_tpu.workloads import train as jtrain
from kubeoperator_tpu.workloads import transformer as jtr
from kubeoperator_tpu_torch.bridge import (
    resnet_params_from_jax, stage_params_from_jax,
)
from kubeoperator_tpu_torch.workloads import sharding as ts
from kubeoperator_tpu_torch.workloads import train as ttrain
from test_torch_bridge import JAX_TINY
from torch_dist_cases import spawn_group

torch.set_num_threads(2)

SPECS = [dict(), dict(dp=8), dict(fsdp=8), dict(dp=2, fsdp=4),
         dict(fsdp=2, tp=2, sp=2), dict(dp=2, pp=2, ep=2), dict(tp=4, sp=2)]
OVERLAP = ["fsdp4_prefetch", "fsdp4_serial", "dp2_fsdp2_prefetch",
           "dp2_fsdp2_serial"]
LAYOUTS = {"MeshSpec(dp=2, fsdp=1, pp=1, ep=1, tp=2, sp=1)": dict(dp=2, tp=2),
           "MeshSpec(dp=1, fsdp=2, pp=1, ep=1, tp=1, sp=2)": dict(fsdp=2,
                                                                  sp=2),
           "MeshSpec(dp=1, fsdp=1, pp=4, ep=1, tp=1, sp=1)": dict(pp=4),
           "MeshSpec(dp=4, fsdp=1, pp=1, ep=1, tp=1, sp=1)": dict(dp=4)}


# the multi-slice layouts of tests/test_workloads.py's hybrid-mesh test,
# over 8 ranks in two slices, contiguous and interleaved
SLICED = [dict(dp=2, tp=4), dict(dp=2, fsdp=2, tp=2), dict(fsdp=4, tp=2),
          dict(dp=4, tp=2), dict(dp=2, fsdp=4)]
SLICE_IDS = {"contiguous": [0, 0, 0, 0, 1, 1, 1, 1],
             "interleaved": [0, 1, 0, 1, 0, 1, 0, 1],
             "reversed": [1, 1, 1, 1, 0, 0, 0, 0]}
# (case, spec, slices) the reference refuses: a model axis outermost, an
# outermost data axis that the slice count does not divide
REFUSALS = [("tp_outer", dict(tp=2, sp=2), [0, 0, 1, 1]),
            ("tp_outer_interleaved", dict(tp=4), [0, 1, 0, 1]),
            ("dp_indivisible", dict(dp=2, tp=2), [0, 1, 2, 2])]
# the multi-slice ResNet case: ResNet-18 at 32², batch 8, custom-backward
# 1x1 convs (tests/test_torch_resnet_mesh.py's fields), two steps at
# (dp 2, fsdp 2) over interleaved slices
RESNET_SLICES = [0, 1, 0, 1]
RESNET_FIELDS = dict(batch_size=8, image_size=32, num_classes=10, depth=18,
                     warmup_steps=2, total_steps=10, dw_dot_max_k=1,
                     conv_bwd="pallas")


def virtual(devices, slices):
    return [js.VirtualSliceDevice(d, s) for d, s in zip(devices, slices)]


def reference_refusal(sizes, slices) -> str:
    with pytest.raises(ValueError) as e:
        js.build_mesh(js.MeshSpec(**sizes),
                      virtual(jax.devices()[:len(slices)], slices))
    return str(e.value)


@pytest.mark.parametrize("kind", list(SLICE_IDS))
@pytest.mark.parametrize("sizes", SLICED, ids=str)
def test_mesh_ranks_are_the_reference_s_over_slices(sizes, kind):
    """The rows of the outermost axis hold the ranks the reference's
    build_mesh (its real create_hybrid_device_mesh) puts in them, each
    from one slice, in the order of their lowest rank, so that ranks
    ascend along every axis as torch's process groups number them. Where
    the reference's layout ascends so (contiguous slice ids, as
    with_virtual_slices and torchrun's nodes give them), the two are the
    same rank for rank."""
    slices = SLICE_IDS[kind]
    mesh = js.build_mesh(js.MeshSpec(**sizes),
                         virtual(jax.devices()[:8], slices))
    want = np.vectorize(lambda d: d.id)(mesh.devices)
    got = ts.mesh_ranks(ts.MeshSpec(**sizes), slices)
    assert got.shape == want.shape
    rows = [tuple(r.ravel()) for r in got]
    assert rows == sorted(rows) == sorted(tuple(r.ravel()) for r in want)
    for row in got:
        assert len({slices[r] for r in row.flat}) == 1
    for axis in range(got.ndim):
        assert (np.diff(got, axis=axis) > 0).all()
    if all((np.diff(want, axis=a) > 0).all() for a in range(want.ndim)):
        np.testing.assert_array_equal(got, want)
    if kind == "contiguous":
        np.testing.assert_array_equal(got.ravel(), np.arange(8))


def test_mesh_ranks_refuse_slices_no_layout_can_order():
    """Slices {0, 3} and {1, 2}: whichever comes first, a dp column runs
    down in rank order, which a process group cannot number; slices of
    unequal size have no layout either."""
    with pytest.raises(ValueError, match="interleave their ranks, so dp's "
                                         "ranks cannot ascend"):
        ts.mesh_ranks(ts.MeshSpec(dp=2, tp=2), [0, 1, 1, 0])
    with pytest.raises(ValueError, match=r"slices of \[1, 3\] ranks"):
        ts.mesh_ranks(ts.MeshSpec(dp=2, tp=2), [0, 0, 0, 1])


def test_with_virtual_slices_is_the_reference_s():
    devs = js.with_virtual_slices(jax.devices()[:8], 2)
    assert ts.with_virtual_slices(8, 2) == [d.slice_index for d in devs]
    assert ts.with_virtual_slices(4, 4) == [0, 1, 2, 3]
    with pytest.raises(ValueError) as want:
        js.with_virtual_slices(jax.devices()[:6], 4)
    with pytest.raises(ValueError) as got:
        ts.with_virtual_slices(6, 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,sizes,slices", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_mesh_ranks_refuse_what_the_reference_refuses(name, sizes, slices):
    with pytest.raises(ValueError) as got:
        ts.mesh_ranks(ts.MeshSpec(**sizes), slices)
    assert str(got.value) == reference_refusal(sizes, slices)


def test_one_slice_is_the_row_major_layout():
    for sizes in SPECS[1:] + SLICED:
        spec = ts.MeshSpec(**sizes)
        got = ts.mesh_ranks(spec, [0] * spec.n_devices)
        np.testing.assert_array_equal(
            got.ravel(), np.arange(spec.n_devices))
    assert ts.mesh_ranks(ts.MeshSpec(), [0]).tolist() == [0]
    # a model axis outermost is fine within one slice
    assert ts.mesh_ranks(ts.MeshSpec(tp=2), [3, 3]).tolist() == [0, 1]
    assert ts.node_slices() == [0]


@pytest.mark.parametrize("sizes", SPECS, ids=str)
def test_mesh_spec_is_the_reference_s(sizes):
    got, want = ts.MeshSpec(**sizes), js.MeshSpec(**sizes)
    assert got.sizes() == want.sizes()
    assert (got.axis_names, got.n_devices, got.data_axes) == (
        want.axis_names, want.n_devices, want.data_axes)
    assert ts.logical_axis_rules(got) == js.logical_axis_rules(want)


@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, dict(model_parallel=2)), (8, dict(sequence_parallel=4)),
    (8, dict(model_parallel=2, expert_parallel=2, zero3=False))])
def test_for_devices_is_the_reference_s(n, kw):
    assert ts.MeshSpec.for_devices(n, **kw).sizes() == (
        js.MeshSpec.for_devices(n, **kw).sizes())


def test_for_devices_refuses_an_indivisible_count():
    with pytest.raises(ValueError, match="not divisible"):
        ts.MeshSpec.for_devices(6, model_parallel=4)


def jax_trees() -> dict:
    """The reference's own parameter trees: the tiny LM unrolled (so each
    leaf has the port's per-layer shape) and ResNet-50's variables."""
    lm_cfg = JAX_TINY.__class__(**{**JAX_TINY.__dict__, "scan_layers": False})
    lm = nn.unbox(jtr.Transformer(lm_cfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    rn = jax.eval_shape(lambda: jresnet.ResNet(num_classes=1000, depth=50).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    return {"lm": lm, "resnet": rn}


@pytest.mark.parametrize("fsdp,min_size", [(2, 2 ** 14), (4, 2 ** 14),
                                           (8, 64), (1, 64)])
@pytest.mark.parametrize("tree", ["lm", "resnet"])
def test_place_by_shape_is_the_reference_s(tree, fsdp, min_size):
    params = jax_trees()[tree]
    jspec = js.MeshSpec(fsdp=fsdp)
    mesh = js.build_mesh(jspec, jax.devices()[:fsdp])
    want = js.shard_params_fsdp(params, mesh, jspec, min_size)
    spec = ts.MeshSpec(fsdp=fsdp)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    placed = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    assert len(leaves) == len(placed) > 10
    sharded = 0
    for (path, leaf), shd in zip(leaves, placed):
        got = ts.place_by_shape(tuple(leaf.shape), spec, min_size)
        assert got == tuple(shd.spec), jax.tree_util.keystr(path)
        sharded += "fsdp" in got
    assert (sharded > 0) == (fsdp > 1)


def test_shard_params_fsdp_maps_a_flat_dict():
    spec = ts.MeshSpec(fsdp=2)
    got = ts.shard_params_fsdp({"big": torch.zeros(256, 128),
                                "tie": torch.zeros(128, 128),
                                "odd": torch.zeros(129, 129),
                                "small": torch.zeros(8)}, spec)
    assert got == {"big": ("fsdp", None), "tie": (None, "fsdp"), "odd": (),
                   "small": ()}


def overlap_problem() -> dict:
    """tests/test_overlap_fsdp.py's problem (D 8, H 16, L 4, B 16), drawn
    with numpy; embed and head as matrices."""
    rng = np.random.default_rng(3)
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return {"embed": f(8, 16), "head": f(16, 8),
            "stages": [{"w1": f(16, 16), "w2": f(16, 16)} for _ in range(4)],
            "x": rng.standard_normal((16, 8)).astype(np.float32),
            "y": rng.standard_normal((16, 8)).astype(np.float32)}


def jax_eager(p: dict):
    """The eager step's loss and gradients in JAX: layer by layer."""
    def loss(params):
        h = jnp.asarray(p["x"]) @ params["embed"]
        for s in params["stages"]:
            h = jnp.tanh(h @ s["w1"]) @ s["w2"] + h
        return jnp.mean(jnp.mean((h @ params["head"] - p["y"]) ** 2, -1))
    params = jax.tree.map(jnp.asarray, {k: p[k] for k in
                                        ("embed", "head", "stages")})
    return jax.value_and_grad(loss)(params)


def jax_resnet_multislice(x, y) -> dict:
    """Two steps of the JAX Trainer at (dp 2, fsdp 2) on four virtual
    devices in ``RESNET_SLICES``: its start, losses and end."""
    jt = jtrain.Trainer(jtrain.TrainConfig(dtype=jnp.float32,
                                           **RESNET_FIELDS),
                        js.MeshSpec(dp=2, fsdp=2),
                        devices=virtual(jax.devices()[:4], RESNET_SLICES))
    state = jt.init_state(jax.random.key(0))
    start = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    losses = []
    for _ in range(2):
        state, metrics = jt.train_step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(metrics["loss"]))
    end = jax.tree.map(np.asarray, {"params": state.params,
                                    "batch_stats": state.batch_stats})
    return {"start": start, "losses": losses, "end": end}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    p = overlap_problem()
    tree = stage_params_from_jax(p)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = np.array([1, 3, 5, 7, 0, 2, 4, 6], np.int32)
    resnet = jax_resnet_multislice(x, y)
    cfg = ttrain.TrainConfig(dtype=torch.float32, **RESNET_FIELDS)
    inputs = {"overlap": {**tree, "x": torch.from_numpy(p["x"]),
                          "y": torch.from_numpy(p["y"])},
              "refusals": [(name, ts.MeshSpec(**sizes), slices)
                           for name, sizes, slices in REFUSALS],
              "resnet_multislice": {
                  "cfg": cfg, "params": resnet_params_from_jax(
                      resnet["start"], cfg),
                  "x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}}
    ranks = spawn_group("sharding", 4, tmp_path_factory.mktemp("sharding"),
                        inputs)
    resnet["cfg"] = cfg
    return p, ranks, resnet


@pytest.mark.parametrize("name", OVERLAP)
def test_overlapped_zero3_matches_the_eager_step(ranks, name):
    p, res, _ = ranks
    loss, grads = jax_eager(p)
    for r in res:
        got = r[name]
        assert abs(got["loss"] - float(loss)) < 1e-6
        for part in ("embed", "head"):
            np.testing.assert_allclose(got[part].numpy(),
                                       np.asarray(grads[part]), atol=1e-5,
                                       err_msg=part)
        for i, want in enumerate(grads["stages"]):
            for k in want:
                np.testing.assert_allclose(got["stages"][i][k].numpy(),
                                           np.asarray(want[k]), atol=1e-5,
                                           err_msg=f"stage {i} {k}")


@pytest.mark.parametrize("key", list(LAYOUTS))
def test_built_mesh_has_the_reference_s_axes(ranks, key):
    """Axis names in the reference's order, each rank at its coordinates
    in a row-major layout, and its rows of an 8-row batch: dp outer, fsdp
    inner, nothing split over the model axes."""
    sizes = LAYOUTS[key]
    want_names = js.build_mesh(js.MeshSpec(**sizes),
                               jax.devices()[:4]).axis_names
    names = tuple(n for n in ts.AXES if sizes.get(n, 1) > 1)
    blocks = sizes.get("dp", 1) * sizes.get("fsdp", 1)
    for rank, r in enumerate(ranks[1]):
        got = r["mesh_layouts"][key]
        assert got["names"] == tuple(want_names) == names
        coords = np.unravel_index(rank, [sizes[n] for n in names])
        assert {n: int(c) for n, c in zip(names, coords)} == {
            n: got["coords"][n] for n in names}
        block = got["coords"]["dp"] * sizes.get("fsdp", 1) + got[
            "coords"]["fsdp"]
        per = 8 // blocks
        assert got["rows"] == list(range(block * per, (block + 1) * per))


def test_build_mesh_refuses_a_count_mismatch(ranks):
    assert {r["mesh_layouts"]["mismatch"] for r in ranks[1]} == {
        "MeshSpec wants 2 devices, got 4"}


@pytest.mark.parametrize("case,slices", [
    ("multislice_psum", [0, 0, 1, 1]),
    ("multislice_psum_interleaved", [1, 0, 1, 0])])
def test_tp_psum_over_two_slices(ranks, case, slices):
    """dp spans the slices, tp stays inside one: each rank's tp group
    sums the ranks of its slice, and its dp coordinate picks its rows."""
    want = ts.mesh_ranks(ts.MeshSpec(dp=2, tp=2), slices)
    for rank, r in enumerate(ranks[1]):
        got = r[case]
        assert got["mesh"] == want.tolist()
        dp, tp = map(int, np.argwhere(want == rank)[0])
        assert (got["coords"]["dp"], got["coords"]["tp"]) == (dp, tp)
        assert got["tp_sum"] == float(sum(want[dp] + 1))
        assert {slices[q] for q in want[dp]} == {slices[rank]}
        assert got["rows"] == list(range(4 * dp, 4 * dp + 4))


def test_multislice_refusals_come_before_any_collective(ranks):
    """Rank 0 alone built each refused layout (a process group made
    first would have waited on the others): the reference's messages."""
    got = ranks[1][0]["multislice_refusals"]
    for name, sizes, slices in REFUSALS:
        assert got[name] == reference_refusal(sizes, slices), name
    assert all(r["multislice_refusals"] == {} for r in ranks[1][1:])


def test_torchrun_nodes_are_the_default_slices(ranks):
    """Under torchrun each rank's slice is its node (GROUP_RANK, gathered
    when the world spans nodes): nodes whose ranks interleave give dp
    rows of one node each."""
    for r in ranks[1]:
        assert r["node_slices"] == {"slices": [0, 1, 0, 1],
                                    "mesh": [[0, 2], [1, 3]]}


def test_resnet_over_two_slices_matches_jax(ranks):
    _, res, want = ranks
    end = resnet_params_from_jax(want["end"], want["cfg"])
    mesh = ts.mesh_ranks(ts.MeshSpec(dp=2, fsdp=2), RESNET_SLICES)
    for rank, r in enumerate(res):
        got = r["resnet_multislice"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["step"] == 2
        dp, fsdp = map(int, np.argwhere(mesh == rank)[0])
        assert (got["coords"]["dp"], got["coords"]["fsdp"]) == (dp, fsdp)
        state = {**got["params"], **got["buffers"]}
        assert set(state) == set(end)
        for name in end:
            np.testing.assert_allclose(state[name].numpy(),
                                       end[name].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=name)


def test_one_process_is_a_world_of_one():
    """No process group: a one-device spec gives no mesh (every axis one
    rank, every collective the identity), any other raises as the
    reference's build_mesh does."""
    assert ts.world_size() == 1
    assert ts.build_mesh(ts.MeshSpec()) is None
    with pytest.raises(ValueError, match="wants 4 devices, got 1"):
        ts.build_mesh(ts.MeshSpec(dp=2, tp=2))
    x = torch.arange(12).reshape(3, 4)
    assert torch.equal(ts.shard_batch(None, x, seq_dim=1), x)
    assert ts.axis_size(None, "tp") == 1 and ts.axis_group(None, "sp") is None


@pytest.mark.parametrize("multiple", [1, 7])
def test_pack_stages_is_the_reference_s(multiple):
    """Same flat layout as ravel_pytree (sorted names), right-padded to the
    multiple; unpack inverts it exactly."""
    st = overlap_problem()["stages"]
    want, junpack = js.pack_stages([jax.tree.map(jnp.asarray, s) for s in st],
                                   multiple=multiple)
    got, unpack = ts.pack_stages([{k: torch.from_numpy(v) for k, v in
                                   s.items()} for s in st], multiple=multiple)
    assert got.shape == want.shape and got.shape[1] % multiple == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, orig in enumerate(st):
        back = unpack(got[i])
        for k in orig:
            np.testing.assert_array_equal(back[k].numpy(), orig[k])
    with pytest.raises(ValueError, match="share parameter shapes"):
        ts.pack_stages([{"w": torch.zeros(2)}, {"w": torch.zeros(3)}])


def test_overlapped_shardings_cover_the_param_tree(monkeypatch):
    assert ts.fsdp_overlapped_shardings(None) == {
        "embed": (), "stages": (None, None), "head": ()}
    # a world of one device: every axis has one rank (the dry run's and
    # the bench's fsdp-overlap at n = 1); over several ranks the mesh must
    # have the axis, as the reference's must
    assert callable(ts.fsdp_overlapped_loss_fn(None, None, None, None, None,
                                               None))
    monkeypatch.setattr(ts, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="no 'fsdp' axis"):
        ts.fsdp_overlapped_loss_fn(None, None, None, None, None, None)
