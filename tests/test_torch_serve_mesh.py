"""The port's slot pool over a serving mesh on gloo ranks, f32 at the tiny
sizes of tests/test_torch_decode_loop.py and tests/test_torch_moe.py: the
pool at dp 2, at tp 2 and at (dp 2, tp 2), and the MoE pool at (dp 2,
ep 2), every rank making the engine calls; their greedy rows against the
JAX engine at the same mesh (built with ``compile_cache=None``) and
against the port's one-device pool, bit for bit (sampled and
speculative rows against the one-device pool's), the MoE pool's
``expert_load()`` against the one-device pool's, and the prefix cache
and spill tier of each dp shard against the JAX engine's host state
after every wave. Then the host protocol:
``ContinuousBatcher`` on rank 0 over an ``EngineLeader`` with the other
rank following, admitting across two shards with per-shard gauges, and
the ``serve --mesh`` job over HTTP, and the prefill→decode handoff at dp
2 and tp 2 in both directions (the JAX engine's tokens, every rank's
host state alike). ``validate_serve_mesh`` against the reference's
accept and refuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import decode_loop as jdl
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu_torch.workloads import decode_loop as tdl
from kubeoperator_tpu_torch.workloads.generate import generate
from kubeoperator_tpu_torch.workloads.serving import ContinuousBatcher
from kubeoperator_tpu_torch.workloads.train import MeshSpec
from kubeoperator_tpu_torch.workloads.transformer import (
    Transformer, TransformerConfig,
)
from test_torch_bridge import jax_params, port_cfg, port_model
from test_torch_decode_loop import JCFG
from test_torch_moe import JCFG as MOE_JCFG
from torch_dist_cases import (
    HANDOFF_PROMPT, POOL_MIXED, POOL_MOE, POOL_SAMPLED, _drain, spawn_group,
)

torch.set_num_threads(2)

MID = ([(0, [5, 6, 7, 8, 9, 10], 10, 0.0, 3)], [(2, [11, 12, 13], 8, 0.0, 4)])
MESHES = {"pool_dp2": dict(dp=2), "pool_tp2": dict(tp=2),
          "pool_dp2_tp2": dict(dp=2, tp=2)}


def jax_rows(params, jcfg, spec, entries, segment, later=()):
    """The JAX engine's rows for the same script as ``_drain``."""
    eng = jdl.SlotPoolEngine(jcfg, jax.tree.map(jnp.asarray, params),
                             slots=4, segment=segment, compile_cache=None,
                             mesh_spec=spec,
                             devices=jax.devices()[:spec.n_devices])
    return _drain(eng, entries, list(later))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dense, moe = jax_params(JCFG, seed=7), jax_params(MOE_JCFG, seed=11)
    inputs = {"dense": {"cfg": port_cfg(JCFG),
                        "params": port_model(JCFG, dense).state_dict()},
              "moe": {"cfg": port_cfg(MOE_JCFG),
                      "params": port_model(MOE_JCFG, moe).state_dict()}}
    ranks = {}
    for world in (2, 4):
        out = spawn_group(f"serve{world}", world,
                          tmp_path_factory.mktemp(f"serve{world}"), inputs)
        for name in out[0]:
            ranks[name] = [r[name] for r in out]
    return {"dense": dense, "moe": moe}, ranks, inputs


def one_device(inputs, key: str, **kw):
    from torch_dist_cases import _pool_model

    cfg, model = _pool_model(inputs, key)
    return tdl.SlotPoolEngine(cfg, model, slots=4, device="cpu", **kw)


@pytest.mark.parametrize("name", list(MESHES))
def test_greedy_rows_match_the_jax_engine_and_the_one_device_pool(runs,
                                                                  name):
    """Mixed prompt lengths (pow2 and not) and max_tokens, one request a
    slot, so both dp shards hold rows: every rank returns every slot's
    row, equal to the JAX engine's at the same mesh and to the port's
    one-device pool's."""
    params, ranks, inputs = runs
    got = ranks[name][0]["mixed"]
    assert all(r["mixed"] == got for r in ranks[name])
    assert got == _drain(one_device(inputs, "dense", segment=3), POOL_MIXED)
    assert got == jax_rows(params["dense"], JCFG,
                           JMeshSpec(**MESHES[name]), POOL_MIXED, 3)
    assert ranks[name][0]["dp"] == MESHES[name].get("dp", 1)


@pytest.mark.parametrize("name", ["pool_dp2", "pool_tp2"])
def test_mid_flight_admission_on_the_other_shard(runs, name):
    """Slot 2 (the other dp shard at dp 2) admitted while slot 0 is
    mid-decode: neither row moves, against the JAX engine at the mesh and
    the one-device pool."""
    params, ranks, inputs = runs
    got = ranks[name][0]["mid"]
    assert got == _drain(one_device(inputs, "dense", segment=2), *MID)
    assert got == jax_rows(params["dense"], JCFG,
                           JMeshSpec(**MESHES[name]), MID[0], 2, MID[1])


@pytest.mark.parametrize("name", ["pool_dp2", "pool_tp2"])
def test_sampled_row_is_the_one_device_pool_s(runs, name):
    """A sampled row co-batched with a greedy one: its draws are keyed by
    (seed, position) and made from the whole vocabulary on its own rank,
    so the mesh gives the one-device pool's tokens (sampling is not
    compared with JAX: the RNG streams differ)."""
    _, ranks, inputs = runs
    got = ranks[name][0]["sampled"]
    assert got == _drain(one_device(inputs, "dense", segment=3),
                         POOL_SAMPLED)
    assert all(0 <= t < JCFG.vocab_size for t in got[0])


@pytest.mark.parametrize("name", ["pool_dp2", "pool_tp2"])
def test_speculative_pool_is_the_one_device_pool_s(runs, name):
    """Speculative decoding (``spec_k`` 2, the first layer as the draft)
    on the mesh: ``poll_spec`` gathers each shard's positions and sums
    their counts, and the greedy rows equal the one-device speculative
    pool's."""
    from torch_dist_cases import _drain_spec

    _, ranks, inputs = runs
    want = _drain_spec(one_device(inputs, "dense", segment=1, spec_k=2,
                                  draft_layers=1, pages=40), POOL_MIXED)
    assert all(r["spec"] == want for r in ranks[name])


def test_moe_pool_over_dp_and_ep(runs):
    """The MoE pool at (dp 2, ep 2): each ep rank runs 2 of the 4
    experts, routing whole; pow2 prompts (capacity depends on the pass's
    width). Greedy rows equal the JAX engine's at (dp 2, ep 2) and the
    one-device pool's, and ``expert_load()``, summed over the dp shards,
    equals the one-device pool's."""
    params, ranks, inputs = runs
    got = ranks["moe_dp2_ep2"]
    one = one_device(inputs, "moe", segment=2)
    assert all(r["moe"] == got[0]["moe"] for r in got)
    assert got[0]["moe"] == _drain(one, POOL_MOE)
    assert got[0]["moe"] == jax_rows(params["moe"], MOE_JCFG,
                                     JMeshSpec(dp=2, ep=2), POOL_MOE, 2)
    for r in got:
        np.testing.assert_array_equal(r["expert_load"], one.expert_load())
    assert one.expert_load().sum() > 0


def test_prefix_cache_and_spill_tier_per_shard_are_the_reference_s(runs):
    """Prefix hits, LRU eviction with demotion to the host tier and a
    promotion, on both shards of a dp 2 pool of 6 pages a shard with a
    2-page spill tier: after every wave the counters, each shard's free,
    evictable, used and spilled pages, the wave's plans and the block
    tables equal the JAX engine's at dp 2, and so do the rows."""
    from torch_dist_cases import prefix_spill_script

    params, ranks, _ = runs
    want = prefix_spill_script(jdl.SlotPoolEngine(
        JCFG, jax.tree.map(jnp.asarray, params["dense"]), slots=4,
        segment=4, page=8, pages=12, spill_pages=2, compile_cache=None,
        mesh_spec=JMeshSpec(dp=2), devices=jax.devices()[:2]))
    got = ranks["prefix_spill_dp2"]
    assert all(r == got[0] for r in got[1:])
    assert len(got[0]["states"]) == len(want["states"]) == 8
    for i, (a, b) in enumerate(zip(got[0]["states"], want["states"])):
        assert a == b, f"after step {i}"
    assert got[0]["rows"] == want["rows"]
    final = got[0]["states"][-1]["counters"]
    assert final["prefix_hits"] > 0 and final["demotions"] > 0


def test_batcher_admits_across_two_shards(runs):
    """``ContinuousBatcher`` over ``EngineLeader`` at dp 2 with 3 usable
    pages a shard: four concurrent requests (2, 2, 2 and 3 pages) admit
    wherever a shard has a free slot and the pages, wait otherwise, and
    all come back equal to the one-device pool's rows; the gauges carry a
    series per shard."""
    _, ranks, inputs = runs
    got = ranks["batcher_dp2"][0]
    assert got["batcher_dp"] == 2
    assert got["replies"] == _drain(one_device(inputs, "dense", segment=2),
                                    POOL_MIXED)
    for gauge in ("slot_occupancy", "kv_pages_used"):
        for shard in (0, 1):
            assert f'ko_serve_{gauge}{{shard="{shard}"}}' in got["prometheus"]
    assert 'ko_serve_slot_occupancy{shard="0"} 0' in got["prometheus"]
    assert [s["free"] + s["used"] for s in got["shards"]] == [3, 3]
    assert ranks["batcher_dp2"][1] == {}


def job_rows(moe: int = 0) -> list:
    """``generate()`` on the serve job's own model (seed 0, the widths of
    ``SERVE_TINY``) for ``POOL_MIXED``'s prompts."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=int(32 * 8 / 3 / 32) * 32, max_seq_len=24,
                            moe_experts=moe, dtype=torch.float32)
    model = Transformer(cfg).reset_parameters(0).eval()
    return [generate(cfg, model, [pr], mt, device="cpu")[0].tolist()
            for _s, pr, mt, _t, _d in POOL_MIXED]


@pytest.mark.parametrize("name,moe", [("job_dp2", 0),
                                      ("job_moe_dp2_ep2", 4)])
def test_serve_job_over_the_mesh(runs, name, moe):
    """``serve --mesh`` (``build_server`` on every rank): rank 0 answers
    over HTTP with the tokens ``generate()`` gives on one device and
    reports the mesh; the other ranks serve nothing and return when it
    stops them."""
    _, ranks, _ = runs
    got = ranks[name]
    assert got[0]["server"] and all(r == {"server": None} for r in got[1:])
    if moe:     # capacity depends on the width: pow2 prompts only
        pow2 = [i for i, (_s, pr, *_r) in enumerate(POOL_MIXED)
                if len(pr) & (len(pr) - 1) == 0]
        assert pow2 and [got[0]["replies"][i] for i in pow2] == [
            job_rows(moe)[i] for i in pow2]
    else:
        assert got[0]["replies"] == job_rows()
    mesh = next(r["mesh"] for r in got[0]["records"] if "mesh" in r)
    assert {k: v for k, v in mesh.items() if v > 1} == (
        {"dp": 2, "ep": 2} if moe else {"dp": 2})


@pytest.mark.parametrize("spec,kw", [
    (dict(dp=2, ep=2, tp=2), dict(slots=8, n_heads=4, moe_experts=4)),
    (dict(dp=2, ep=2, tp=2), dict(slots=8, n_heads=4)),
    (dict(dp=2, ep=4), dict(slots=8, n_heads=4, moe_experts=6)),
    (dict(dp=4, tp=2), dict(slots=6, n_heads=4)),
    (dict(dp=1, tp=8), dict(slots=8, n_heads=4)),
    (dict(dp=2, sp=4), dict(slots=8, n_heads=4)),
    (dict(dp=2, tp=4), dict(slots=8, n_heads=4, page=6, pages=8,
                            max_seq_len=24)),
    (dict(dp=2, tp=4), dict(slots=8, n_heads=4, page=8, pages=8,
                            max_seq_len=24)),
    (dict(dp=2), dict(slots=4, n_heads=4, page=8, pages=9, max_seq_len=24))])
def test_validate_serve_mesh_is_the_reference_s(spec, kw):
    """tests/test_continuous.py's accepted and refused layouts
    (``test_moe_mesh_validation``, ``test_mesh_divisibility_rejections``,
    the paged cases): the same outcome and message."""
    def outcome(fn, mesh):
        try:
            fn(mesh, **kw)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jdl.validate_serve_mesh, JMeshSpec(**spec))
    assert outcome(tdl.validate_serve_mesh, MeshSpec(**spec)) == want


class _ShardedEngine:
    """The accounting a batcher reads from a dp 2 engine: 4 slots, free
    pages per shard, nothing evictable."""
    slots, segment, max_total, dp = 4, 1, 24, 2
    pages, page, max_request_pages = 8, 8, 3

    def __init__(self, free):
        self.free = free

    def pages_for(self, plen, mt):
        return -(-(plen + mt) // self.page)

    def free_pages(self, shard=0):
        return self.free[shard]

    def evictable_pages(self, shard=0):
        return 0


def test_admission_picks_a_shard_with_room():
    """A request needs one shard with a free slot and its pages: with
    shard 0 full it takes shard 1's first free slot; a wave's promised
    pages count against their shard; a head that fits nowhere stops the
    wave."""
    cb = ContinuousBatcher.__new__(ContinuousBatcher)
    cb.engine = _ShardedEngine({0: 1, 1: 3})
    cb._dp, cb._shard_slots = 2, 2
    cb._free = [0, 1, 2, 3]
    from collections import deque

    from kubeoperator_tpu_torch.workloads.serving import _Pending
    cb._queue = deque(_Pending([1] * n, 4, 0.0, 0) for n in (4, 4, 1))
    picks = cb._admit_wave_locked()
    # 8 tokens -> 1 page fits shard 0; then 1 page more fits only shard 1
    assert [slot for slot, _ in picks] == [0, 2, 3]
    cb.engine = _ShardedEngine({0: 0, 1: 2})
    cb._free = [1, 3]
    cb._queue = deque([_Pending([1] * 20, 4, 0.0, 0)])     # 3 pages
    assert cb._admit_wave_locked() == [] and len(cb._queue) == 1


@pytest.mark.parametrize("name", ["handoff_dp2", "handoff_tp2"])
def test_meshed_handoff_both_ways(runs, name):
    """The prefill→decode handoff over the pool at dp 2 (the slot on the
    shard of rank 1) and at tp 2 (each rank half the heads): the mesh's
    export is rank 0's whole payload (two pages of every head, the other
    rank's None), which a one-device engine lands and decodes over; rank
    0's one-device export lands in the mesh (once: the second import is a
    no-op); and over an ``EngineLeader`` the ``PrefillWorker`` and the
    batcher's ``handoff`` lever run unchanged, the control group carrying
    no tensor. Every decode is a prefix hit with the JAX engine's greedy
    tokens, and every rank ends with the same host state."""
    params, ranks, _ = runs
    got = ranks[name]
    jeng = jdl.SlotPoolEngine(JCFG, jax.tree.map(jnp.asarray,
                                                 params["dense"]),
                              slots=4, segment=3, compile_cache=None)
    want = _drain(jeng, [(0, HANDOFF_PROMPT, 6, 0.0, 0)])
    head = got[0]
    shape = (2, 8, JCFG.n_heads, JCFG.d_model // JCFG.n_heads)
    assert head["export_payload"] == [(shape, shape, "torch.float32",
                                       "cpu")] * JCFG.n_layers
    assert got[1]["export_payload"] is None
    assert (head["export_pages"], head["export_hits"]) == (2, 1)
    assert head["export_rows"] == want
    for r in got:
        assert r["import_pages"] == [2, 0]
        assert r["import_rows"] == want
        assert r["import_state"]["counters"]["prefix_hits"] == 1
        for key in ("export_state", "import_state", "decode_state"):
            assert r[key] == head[key], key
    assert head["leader_pages"] == 2
    assert [head["leader_reply"]] == want
    assert head["decode_state"]["counters"]["prefix_hits"] == 1
    assert {"export_prefix", "import_prefix"} <= set(head["commands"])
    assert head["command_tensors"] == 0
