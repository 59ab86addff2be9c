"""The port's bench (``kubeoperator_tpu_torch/bench.py``) on the CPU, by
its pure parts and with the trainers' ``measure`` replaced by fixed
results: ``config_record`` against the JAX package's, the suspect-run
retry, ``stats_brief``, the line's keys against the repo's ``bench.py``
(read from its source), the points and their settings, the out-of-memory
fallback, and the failures that must end the run."""

import ast
import json
from pathlib import Path

import pytest
import torch

from kubeoperator_tpu.workloads import costmodel as jcost
from kubeoperator_tpu_torch import bench
from kubeoperator_tpu_torch.workloads import costmodel as tcost
from kubeoperator_tpu_torch.workloads import lm as tlm
from kubeoperator_tpu_torch.workloads import train as ttrain
from kubeoperator_tpu_torch.workloads import vit as tvit

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kw", [
    {"config": "resnet", "n_devices": 1},
    {"config": "llm", "n_devices": 1, "step_time_s": 0.12345678,
     "mfu": 0.27512345678, "step_ms": {"min_ms": 1.0}},
    {"config": "x", "n_devices": 4, "mesh": {"dp": 4, "tp": 1},
     "attribution": {"step_time_s": 0.5, "compute_s": 0.4},
     "compile_counts": {"step": 1}, "error": "boom", "extra": [1, 2]},
    {"config": "y", "n_devices": 2, "ok": False, "mfu": 0}])
def test_config_record_is_the_jax_one(kw):
    assert tcost.config_record(**kw) == jcost.config_record(**kw)


def run_of(*mfus, suspect=(False, False)):
    """A measure() thunk returning one result per call."""
    calls = []

    def run():
        i = len(calls)
        calls.append(i)
        return {"mfu": mfus[i], "step_stats": {
            "min_ms": 1.0, "median_ms": 2.0, "max_ms": 9.0 if suspect[i]
            else 3.0, "suspect": suspect[i]}}

    return run, calls


def test_guarded_keeps_a_sound_first_run():
    run, calls = run_of(0.3)
    out = {}
    assert bench.guarded("llm", run, out)["mfu"] == 0.3
    assert calls == [0] and "remeasured" not in out


@pytest.mark.parametrize("mfus,want", [((0.2, 0.3), 0.3), ((0.3, 0.2), 0.3)])
def test_guarded_retries_a_suspect_run_and_keeps_the_better(mfus, want):
    run, calls = run_of(*mfus, suspect=(True, False))
    out = {"remeasured": ["vit"]}
    assert bench.guarded("llm", run, out)["mfu"] == want
    assert calls == [0, 1] and out["remeasured"] == ["llm", "vit"]


def test_guarded_lets_a_failed_retry_end_the_run():
    results = iter([{"mfu": 0.3, "step_stats": {"suspect": True}}])

    def run():
        try:
            return next(results)
        except StopIteration:
            raise RuntimeError("kernel launch failed") from None

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench.guarded("llm", run, {})


def test_stats_brief():
    assert bench.stats_brief({"step_stats": {
        "min_ms": 1.234, "median_ms": 2.345, "max_ms": 9.876,
        "mean_ms": 3.0, "suspect": True}}) == {
        "min_ms": 1.23, "median_ms": 2.35, "max_ms": 9.88, "suspect": True}
    assert bench.stats_brief({"step_stats": {"median_ms": 2.0,
                                             "suspect": False}}) == {
        "median_ms": 2.0}
    assert bench.stats_brief({}) == {}


def bench_py_keys() -> set[str]:
    """The keys ``bench.py``'s main puts in its line: those of the dict
    merged into ``out`` and those assigned as ``out[...]``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if (isinstance(node, ast.AugAssign) and isinstance(node.value,
                                                           ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and getattr(node.value, "id", None) == "out"):
            keys.add(node.slice.value)
    return keys | {"configs"}


def fake_result(mfu: float, batch: int = 0, **extra) -> dict:
    return {"mfu": mfu, "img_per_sec_per_chip": 1000.0 + batch,
            "achieved_tflops": mfu * 989, "chips": 1, "batch": batch,
            "step_time_ms": 100.0, "tokens_per_sec": 50_000.0,
            "step_stats": {"min_ms": 99.0, "median_ms": 100.0,
                           "max_ms": 101.0, "suspect": False}, **extra}


@pytest.fixture
def fake_card(monkeypatch):
    """The card's peak and name, and every trainer's measure() replaced by
    a recorder that returns a fixed result."""
    calls = []
    monkeypatch.setattr(ttrain, "peak_flops_per_chip", lambda *a: 989e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)

    def resnet(self, **kw):
        calls.append(("resnet", self.cfg, kw))
        return fake_result(0.4, self.cfg.batch_size)

    def lm(self, **kw):
        calls.append(("lm", self.cfg, kw))
        return fake_result(0.3)

    def vit(self, **kw):
        calls.append(("vit", self.cfg, kw))
        return fake_result(0.2, kw["batch"])

    monkeypatch.setattr(ttrain.Trainer, "measure", resnet)
    monkeypatch.setattr(tlm.LMTrainer, "measure", lm)
    monkeypatch.setattr(tvit.ViTTrainer, "measure", vit)
    for module in (ttrain, tlm, tvit):
        monkeypatch.setattr(module, "resolve_device",
                            lambda d: torch.device("cpu"))
    return calls


def test_the_line_has_bench_py_s_keys(fake_card, capsys):
    seen = []
    assert bench.main(on_point=lambda n, r: seen.append(n)) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == bench_py_keys()
    assert line["metric"] == "resnet50_img_per_sec_per_chip"
    assert line["vs_baseline"] == round(line["mfu"] / 0.6, 4) == 0.6667
    assert (line["value"], line["batch_per_chip"], line["image_size"]) == (
        1128.0, 128, 224)
    assert line["peak_tflops_per_chip"] == 989.0
    assert line["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert [c["config"] for c in line["configs"]] == [
        "resnet", "llm", "llm4k", "llm8k", "vit"]
    assert line["configs"][0] == tcost.config_record(
        config="resnet", n_devices=1, step_time_s=0.1, mfu=0.4,
        step_ms={"min_ms": 99.0, "median_ms": 100.0, "max_ms": 101.0})
    assert line["llm_mfu_seq4k"] == line["llm_mfu_seq8k"] == 0.3
    assert seen == ["resnet", "llm", "llm4k", "llm8k", "vit"]


def test_the_points_are_bench_py_s(fake_card, capsys):
    """ResNet-50 at 224², s2d stem, dw_dot_max_k 1 and no kernel mode; the
    bench LM at 2k (dots+attn), 4k and 8k (dots); ViT-B/16 packed."""
    bench.main()
    capsys.readouterr()
    kinds = [c[0] for c in fake_card]
    assert kinds == ["resnet", "lm", "lm", "lm", "vit"]
    _, rcfg, rkw = fake_card[0]
    assert (rcfg.batch_size, rcfg.image_size, rcfg.stem, rcfg.dw_dot_max_k,
            rcfg.conv_bwd, rcfg.fused_bn, rcfg.depth) == (
        128, 224, "space_to_depth", 1, "dot", False, 50)
    assert rkw == {"steps": 6, "warmup": 2, "steps_per_call": 8}
    lms = [(c.max_seq_len, c.remat_policy, kw["batch"], kw["seq_len"],
            kw["steps"], kw["warmup"]) for _, c, kw in fake_card[1:4]]
    assert lms == [(2048, "dots+attn", 8, 2048, 6, 2),
                   (4096, "dots", 4, 4096, 4, 2),
                   (8192, "dots", 2, 8192, 4, 2)]
    cfg = fake_card[1][1]
    assert (cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff, cfg.dtype,
            cfg.logits_bf16) == (2048, 16, 4, 8192, torch.bfloat16, True)
    _, vcfg, vkw = fake_card[4]
    assert vcfg == tvit.ViTConfig()
    assert vcfg.encoder.flash_layout == "packed"
    assert vkw == {"batch": 128, "steps": 4, "warmup": 2, "steps_per_call": 8}


def test_only_running_out_of_memory_moves_to_a_smaller_batch(
        fake_card, monkeypatch, capsys):
    measure = ttrain.Trainer.measure

    def oom_at_128(self, **kw):
        if self.cfg.batch_size == 128:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return measure(self, **kw)

    monkeypatch.setattr(ttrain.Trainer, "measure", oom_at_128)
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["batch_per_chip"] == 64

    def broken(self, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ttrain.Trainer, "measure", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench.main()


def test_every_batch_out_of_memory_prints_the_error_line(fake_card,
                                                         monkeypatch,
                                                         capsys):
    def oom(self, **kw):
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(ttrain.Trainer, "measure", oom)
    assert bench.main() == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "out of memory" in line["error"]


@pytest.mark.parametrize("point", ["lm", "vit"])
def test_a_failed_secondary_point_ends_the_run(fake_card, monkeypatch,
                                               capsys, point):
    def broken(self, **kw):
        raise RuntimeError("kernel launch failed")

    cls = tlm.LMTrainer if point == "lm" else tvit.ViTTrainer
    monkeypatch.setattr(cls, "measure", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_the_bench_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("with a card the bench runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()


def test_points_measured_by_the_caller_are_not_measured_again(fake_card,
                                                              capsys):
    """chip_smoke.py's train and vit_train phases measure the 2k LM and
    ViT-B/16 with the bench's settings; the bench takes those numbers."""
    seen = {}
    given = {"llm": fake_result(0.35), "vit": fake_result(0.25, 128)}
    assert bench.main(on_point=seen.__setitem__, measured=given) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [c[0] for c in fake_card] == ["resnet", "lm", "lm"]
    assert [c[1].max_seq_len for c in fake_card[1:]] == [4096, 8192]
    assert seen["llm"] is given["llm"] and seen["vit"] is given["vit"]
    assert (line["llm_mfu"], line["vit_mfu"]) == (0.35, 0.25)
