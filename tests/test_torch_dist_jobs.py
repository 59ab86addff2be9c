"""The port's multi-device job entry points as ``--device cpu`` JSON lines on
2 gloo ranks, in three spawns (llm, vision, mlp): smoke's psum, llm over
dp, sp (Ulysses) and tp (then sampling from the gathered weights) and
the MoE llm over ep against the one-device job's losses,
the fsdp job with and without overlap, the pipeline job, llm's
``--ckpt-dir`` under a mesh (saved, resumed, then served by ``serve
--ckpt-dir`` in this process), resnet50 over dp and over fsdp (the same
losses; fsdp resumed from its checkpoint) and vit over dp and tp (tp
against the one-device job on the same global batch). In this
process: ``parse_mesh`` against the reference's, the launcher without
``torchrun``'s environment, and the cost model the fsdp job attributes
with against the reference's on the same link."""

import json

import numpy as np
import pytest
import torch

from kubeoperator_tpu.train import jobs as jjobs
from kubeoperator_tpu.workloads import costmodel as jcm
from kubeoperator_tpu_torch.train import jobs
from kubeoperator_tpu_torch.workloads import costmodel as cm
from torch_dist_cases import LLM_TINY, VIT_TINY, spawn_group

torch.set_num_threads(2)

MESHED_LLM = ["llm_dp2", "llm_sp2_ulysses", "llm_tp2_sample"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("jobs")


def spawned(group: str, workdir):
    return spawn_group(group, 2, workdir, {"workdir": str(workdir)})


# three spawns: a case that fails fails its own tests only
@pytest.fixture(scope="module")
def llm_ranks(workdir):
    return spawned("jobs_llm", workdir)


@pytest.fixture(scope="module")
def vision_ranks(workdir):
    return spawned("jobs_vision", workdir)


@pytest.fixture(scope="module")
def mlp_ranks(workdir):
    return spawned("jobs_mlp", workdir)


def losses(records: list) -> list:
    return [r["loss"] for r in records if "loss" in r and "step" in r]


def test_smoke_psum_is_the_world(llm_ranks):
    rec = llm_ranks[0]["smoke"]
    assert rec["rc"] == 0 and len(rec["records"]) == 1
    assert rec["records"][0] == {
        "job": "smoke", "devices": 2, "device_kind": "cpu", "platform": "cpu",
        "matmul_sum": 16_777_216.0, "psum": 2.0, "process_id": 0,
        "num_processes": 2, "ok": True}
    assert llm_ranks[1]["smoke"] == {"rc": 0, "records": []}   # rank 0 prints


@pytest.mark.parametrize("name", MESHED_LLM)
def test_meshed_llm_matches_the_one_device_job(llm_ranks, name, capsys):
    """The same global batch and weights on one device and over the mesh:
    the same losses (the records round to 4 places)."""
    assert jobs.main(["llm", *LLM_TINY]) == 0
    one = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rec = llm_ranks[0][name]
    assert rec["rc"] == 0 and llm_ranks[1][name]["rc"] == 0
    np.testing.assert_allclose(losses(rec["records"]), losses(one),
                               atol=1.5e-4)
    done = rec["records"][-1]
    axis = {"llm_dp2": "dp", "llm_sp2_ulysses": "sp",
            "llm_tp2_sample": "tp"}[name]
    assert done["done"] and done["chips"] == 2 and done["mesh"][axis] == 2
    assert done["num_processes"] == 2 and done["step_time_ms"] > 0
    assert done["mfu"] is None                 # no device peak on the CPU


def test_moe_llm_over_ep_is_the_one_device_job(llm_ranks, capsys):
    """``llm --experts 4 --mesh ep:auto``: each rank holds 2 of the 4
    experts of a layer and the same global batch, so the losses (the aux
    included) are the one-device job's, and it samples from the gathered
    weights."""
    assert jobs.main(["llm", *LLM_TINY, "--experts", "4"]) == 0
    one = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rec = llm_ranks[0]["llm_moe_ep2"]
    assert rec["rc"] == 0 and llm_ranks[1]["llm_moe_ep2"]["records"] == []
    np.testing.assert_allclose(losses(rec["records"]), losses(one),
                               atol=1.5e-4)
    assert rec["records"][-1]["mesh"]["ep"] == 2
    assert any("sampled_tokens" in r for r in rec["records"])


def test_meshed_llm_samples_from_the_gathered_weights(llm_ranks):
    sampled = next(r["sampled_tokens"] for r in
                   llm_ranks[0]["llm_tp2_sample"]["records"]
                   if "sampled_tokens" in r)
    assert len(sampled) == 4 + 3 and all(0 <= t < 64 for t in sampled)


def test_ckpt_dir_under_a_mesh_names_its_roadmap_item(llm_ranks, workdir,
                                                     capsys):
    """``--ckpt-dir`` under a mesh, once refused as ROADMAP item 14f, now
    ported: the job saves every step at dp 2, a rerun resumes at step 2
    and runs step 3, and ``serve --ckpt-dir`` in this process serves the
    saved weights: its greedy reply is ``generate()``'s on the restored
    model."""
    from kubeoperator_tpu_torch.workloads.checkpoint import (
        WorkloadCheckpointer,
    )
    from kubeoperator_tpu_torch.workloads.generate import generate
    from kubeoperator_tpu_torch.workloads.transformer import (
        Transformer, TransformerConfig,
    )
    from test_torch_jobs import call, serving

    first, again = llm_ranks[0]["llm_ckpt_under_mesh"]
    assert first["rc"] == again["rc"] == 0
    assert again["records"][0] == {"job": "llm", "resumed_at": 2}
    assert [r["step"] for r in again["records"] if "step" in r] == [3]
    assert again["records"][-1]["steps"] == 3
    assert llm_ranks[1]["llm_ckpt_under_mesh"][1]["records"] == []
    ckpt = str(workdir / "llm_ckpt")
    assert WorkloadCheckpointer(ckpt).steps() == [1, 2, 3]
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_seq_len=32, dtype=torch.float32)
    model = Transformer(cfg)
    assert WorkloadCheckpointer(ckpt).restore_model(model) == 3
    prompt = [5, 9, 2, 6]
    want = generate(cfg, model.eval(), [prompt], 6, device="cpu")[0].tolist()
    capsys.readouterr()
    with serving("--ckpt-dir", ckpt) as (url, _):
        status, body = call(url + "/generate", {"prompt_ids": prompt,
                                                "max_tokens": 6})
    assert status == 200 and json.loads(body)["tokens"] == want
    assert json.loads(capsys.readouterr().out.splitlines()[0])[
        "weights"] == "checkpoint step 3"


def test_resnet50_over_dp_and_over_fsdp_take_the_same_steps(vision_ranks):
    """The same global batch (each rank its block, seeded by the block)
    over dp 2 and over fsdp 2, 2 steps saved, then resumed to a third
    (whose schedule, as the reference job's, spans the new ``--steps``):
    the same losses, to the records' 4 places, and only rank 0 prints."""
    runs = {}
    for axis in ("dp", "fsdp"):
        first, again = vision_ranks[0][f"resnet50_{axis}2_ckpt"]
        assert first["rc"] == again["rc"] == 0
        assert again["records"][0] == {"job": "resnet50", "resumed_at": 2}
        runs[axis] = losses(first["records"]) + losses(again["records"])
        assert len(runs[axis]) == 3 and all(np.isfinite(runs[axis]))
        done = again["records"][-1]
        assert done["done"] and done["chips"] == 2 and done["steps"] == 3
        assert {k: v for k, v in done["mesh"].items() if v > 1} == {axis: 2}
        assert done["img_per_sec_per_chip"] == pytest.approx(
            done["img_per_sec"] / 2, abs=0.1)
        assert all(r["records"] == [] for r in
                   vision_ranks[1][f"resnet50_{axis}2_ckpt"])
    np.testing.assert_allclose(runs["fsdp"], runs["dp"], atol=2e-4)


def test_vit_over_tp_is_the_one_device_job_on_its_global_batch(
        vision_ranks, capsys):
    """tp 2 has one block of the batch: both ranks train on the stream of
    seed 0 at the global batch of 2 × 2, as the one-device job at 4 a
    chip does. The job runs bf16, as the reference's, and tp sums the
    heads' and the MLP's partial products in another order: the losses
    agree to within a bf16 step (rtol 5e-3; measured 9e-4)."""
    flags = [f for f in VIT_TINY]
    flags[flags.index("--batch-per-chip") + 1] = "4"
    assert jobs.main(["vit", *flags]) == 0
    one = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    for name in ("vit_tp2", "vit_dp2"):
        rec = vision_ranks[0][name]
        assert rec["rc"] == 0 and vision_ranks[1][name]["records"] == []
        done = rec["records"][-1]
        assert done["done"] and done["chips"] == 2 and done["steps"] == 3
        assert done["mesh"][name[4:6]] == 2
        assert all(np.isfinite(losses(rec["records"])))
    np.testing.assert_allclose(losses(vision_ranks[0]["vit_tp2"]["records"]),
                               losses(one), rtol=5e-3)


@pytest.mark.parametrize("name", ["fsdp", "fsdp_no_overlap"])
def test_fsdp_job_trains(mlp_ranks, name):
    rec = mlp_ranks[0][name]
    assert rec["rc"] == 0
    ls = losses(rec["records"])
    assert len(ls) == 4 and all(np.isfinite(ls)) and ls[-1] < ls[0]
    done = rec["records"][-1]
    assert done["done"] and done["mesh"]["fsdp"] == 2 and done["layers"] == 3
    assert done["overlap"] == (name == "fsdp") and done["step_time_s"] > 0
    assert done["attribution_source"] is None and done["mfu"] is None


def test_fsdp_aot_cache_emits_the_aot_record(mlp_ranks, workdir):
    """``fsdp --aot-cache DIR`` consults the compile cache before the
    first step and emits the reference's ``aot`` record from rank 0 only;
    the MLP launches no kernel library, so nothing is built or written."""
    recs = [r["fsdp_aot_cache"] for r in mlp_ranks]
    assert [r["rc"] for r in recs] == [0, 0]
    assert recs[0]["records"][0] == {"job": "fsdp", "aot": {
        "hit": True, "fingerprint": "none", "seconds": 0.0}}
    assert not any("aot" in x for x in recs[1]["records"])
    assert recs[0]["records"][-1]["done"]
    assert (workdir / "aot").is_dir() and not any((workdir / "aot").iterdir())


def test_fsdp_overlap_is_a_schedule_not_a_result(mlp_ranks):
    assert losses(mlp_ranks[0]["fsdp"]["records"]) == losses(
        mlp_ranks[0]["fsdp_no_overlap"]["records"])


def test_pipeline_job_trains(mlp_ranks):
    rec = mlp_ranks[0]["pipeline"]
    assert rec["rc"] == 0
    ls = losses(rec["records"])
    assert len(ls) == 3 and ls[-1] < ls[0]
    done = rec["records"][-1]
    assert (done["stages"], done["microbatches"], done["bubble_fraction"]) == (
        2, 4, 0.2)
    assert done["mesh"]["pp"] == 2 and done["num_processes"] == 2


@pytest.mark.parametrize("arg,n", [(None, 1), (None, 8), ("dp:auto", 8),
                                   ("dp:2,tp:2,sp:2", 8), ("fsdp:auto,tp:2", 8),
                                   ("pp:4", 4), ("dp:2,sp:auto", 8)])
def test_parse_mesh_is_the_reference_s(arg, n):
    assert jobs.parse_mesh(arg, n).sizes() == jjobs.parse_mesh(arg, n).sizes()


@pytest.mark.parametrize("arg,msg", [("xp:2", "unknown mesh axis"),
                                     ("dp:auto,tp:auto", "only one"),
                                     ("dp:auto,tp:3", "not divisible")])
def test_parse_mesh_refuses_what_the_reference_refuses(arg, msg):
    with pytest.raises(SystemExit, match=msg):
        jobs.parse_mesh(arg, 8)


def test_one_process_without_torchrun_is_a_world_of_one(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert jobs.maybe_initialize_distributed("cpu") == {
        "process_id": 0, "num_processes": 1}


@pytest.mark.parametrize("cmd,msg", [("fsdp", "needs an fsdp axis"),
                                     ("pipeline", "needs a pp axis")])
def test_fsdp_and_pipeline_jobs_need_their_axis(cmd, msg):
    with pytest.raises(SystemExit, match=msg):
        jobs.main([cmd, "--device", "cpu"])


def test_cost_model_is_the_reference_s_on_the_same_link():
    link = cm.link_for("NVIDIA H100 80GB HBM3")
    jlink = jcm.LinkModel(latency_s=link.latency_s,
                          bytes_per_s=link.bytes_per_s)
    for kind in cm.COLLECTIVES:
        for n in (1, 2, 8):
            assert cm.ici_hops(kind, n) == jcm.ici_hops(kind, n)
            assert cm.collective_seconds(kind, 1e8, n, link) == (
                jcm.collective_seconds(kind, 1e8, n, jlink))
    for overlap in (True, False):
        kw = dict(n_layers=4, layer_param_bytes=4e8,
                  fwd_flops_per_layer=2e12, n_fsdp=8, peak_flops=989e12,
                  overlap=overlap)
        got = cm.fsdp_step_model(link=link, **kw)
        want = jcm.fsdp_step_model(link=jlink, **kw)
        assert got.as_dict() == want.as_dict()
        assert cm.attribute(0.5, got).as_dict() == (
            jcm.attribute(0.5, want).as_dict())


def test_link_table_names_no_tpu_rate_and_refuses_unknown_cards():
    assert cm.link_for("NVIDIA H100 80GB HBM3").bytes_per_s == 450e9
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5e"):
        with pytest.raises(ValueError, match="no NVLink rate"):
            cm.link_for(name)


def test_profiled_collective_seconds_is_none_on_the_cpu():
    x = torch.ones(4)
    assert cm.profiled_collective_seconds(lambda a: a * 2, x) is None
    assert cm.profiled_collective_seconds(lambda p: p, {"w": x}) is None
