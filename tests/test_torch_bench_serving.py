"""The serving bench's real arms on the port's slot pool
(``kubeoperator_tpu_torch.bench_serving``), on the CPU: the speculative
arm on the reference's tiny f32 config against a JAX ``SlotPoolEngine``
driven by the same script on the same weights (carried across with
``bridge.py``), tokens and the drafted/accepted counts; the scaling arm
over a world of 2 gloo ranks, larger shapes ``skipped``; the bring-up arm
through a fresh ``CompileCache`` (the pool builds nothing) and the
reference's autoscale replay; and the refusals without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.workloads import decode_loop as jdl
from kubeoperator_tpu_torch import bench_serving as bs
from test_torch_bridge import jax_params, port_cfg, port_model
from test_torch_decode_loop import JCFG

torch.set_num_threads(2)


def jax_drain(eng, prompts, max_tokens):
    """The reference arm's drain on a JAX engine."""
    eng.admit([(s, p, max_tokens, 0.0, 0) for s, p in enumerate(prompts)])
    for _ in range(16 * max_tokens):
        _, pos = eng.poll()
        if all(pos[s] >= len(p) + max_tokens - 1
               for s, p in enumerate(prompts)):
            break
        eng.run_segment()
        if getattr(eng, "spec_k", 0):
            eng.poll_spec()
    buf, _ = eng.poll()
    return [np.asarray(buf)[s, :len(p) + max_tokens].tolist()
            for s, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def weights():
    return jax_params(JCFG, seed=0)


def test_spec_config_is_the_references():
    assert bs.spec_config() == port_cfg(JCFG)


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_arm_equals_the_jax_engine(weights, spec_k):
    """Rows of the plain and the speculative engine and the acceptance
    counters equal a JAX engine's (compile_cache=None: the conftest routes
    bare JAX engines through a session-shared AOT cache) on the same
    weights, greedy."""
    jp = jax.tree.map(jnp.asarray, weights)
    jplain = jdl.SlotPoolEngine(JCFG, jp, slots=4, segment=4,
                                compile_cache=None)
    jbase = jax_drain(jplain, bs.SPEC_PROMPTS, 8)
    jspec = jdl.SlotPoolEngine(JCFG, jp, slots=4, segment=4, pages=25,
                               spec_k=spec_k, draft_layers=1,
                               compile_cache=None)
    jrows = jax_drain(jspec, bs.SPEC_PROMPTS, 8)
    got = bs.bench_spec_real(port_cfg(JCFG), port_model(JCFG, weights),
                             spec_k=spec_k, device="cpu")
    assert got["plain_rows"] == jbase
    assert got["rows"] == jrows
    assert got["bit_identical"] == (jrows == jbase) is True
    assert (got["drafted"], got["accepted"]) == (
        int(jspec.spec_draft_tokens), int(jspec.spec_accepted_tokens))
    assert 0 < got["drafted"] and 0 <= got["accepted"] <= got["drafted"]
    assert got["acceptance"] == round(got["accepted"] / got["drafted"], 3)
    assert got["device_kind"] == "cpu"


def test_scaling_arm_over_two_gloo_ranks():
    got = bs.bench_scaling_real(device="cpu", world=2)
    assert got["world"] == 2
    ran, skipped = got["curve"][:2], got["curve"][2:]
    assert [(p["dp"], p["tp"]) for p in ran] == [(1, 1), (2, 1)]
    for p in ran:
        assert p["tok_s"] > 0 and p["compile_counts"] == {}
    assert skipped == [
        {"n_devices": 4, "dp": 2, "tp": 2, "skipped": "only 2 devices"},
        {"n_devices": 8, "dp": 4, "tp": 2, "skipped": "only 2 devices"}]


def test_scaling_arm_defaults_to_one_cpu_rank():
    got = bs.bench_scaling_real(shapes=((1, 1), (2, 1)), device="cpu")
    assert got["world"] == 1
    assert got["curve"][1]["skipped"] == "only 1 devices"


def test_bringup_arm_reports_no_build():
    got = bs.bench_bringup(device="cpu")
    ab, rp = got["bringup_ab"], got["autoscale_replay"]
    for arm in (ab["cold"], ab["warm"]):
        assert arm["compiles"] == 0 and arm["hit"] is True
        assert (arm["source"], arm["fingerprint"]) == ("none", "none")
    assert (rp["detect_s"], rp["schedule_s"], rp["overload_rps"],
            rp["drain_rps"]) == (1.0, 2.0, 4.0, 8.0)
    for arm, key in (("cold", "cold_breach_close_s"),
                     ("warm", "warm_breach_close_s")):
        waiting = 3.0 + ab[arm]["seconds"]
        assert rp[key] == pytest.approx(waiting * 1.5, abs=1e-4)


def test_cli_bringup_on_the_cpu(capsys):
    assert bs.main(["--bringup", "--device", "cpu"]) == 0
    import json

    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bringup_ab"]["cold"]["source"] == "none"


@pytest.mark.parametrize("arm", [bs.bench_spec_real, bs.bench_scaling_real,
                                 bs.bench_bringup])
def test_arms_need_the_card_unless_asked_for_the_cpu(arm):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arm()
