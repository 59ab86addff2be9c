"""The port's compile-artifact cache (``kubeoperator_tpu_torch/aot``) and
compile-count guard (``analysis/compile_guard.py``) on the CPU: the
counterparts of tests/test_aot.py's tests.

The port's artifacts are its nvcc-built kernel libraries. The CPU
tests run without nvcc, so every cache here takes a stand-in builder that writes a
file of known bytes, and a stand-in toolkit (the card and nvcc fields of
the key); tests/test_torch_aot_cuda.py runs the real build on the card.
A cache installs its library into ``kernels`` (a path, opened at the
first launch), so each test restores ``kernels``' installed paths after
it."""

import json
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from kubeoperator_tpu.aot import CompileCache as JaxCompileCache
from kubeoperator_tpu.aot import cache as jcache
from kubeoperator_tpu.telemetry import metrics as jmetrics
from kubeoperator_tpu.workloads.sharding import MeshSpec as JMeshSpec
from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.analysis import compile_count_guard
from kubeoperator_tpu_torch.aot import CATALOG, CompileCache, warm
from kubeoperator_tpu_torch.aot import __main__ as cli
from kubeoperator_tpu_torch.aot import cache as tcache
from kubeoperator_tpu_torch.telemetry import metrics as tmetrics
from kubeoperator_tpu_torch.workloads.sharding import MeshSpec
from test_torch_bridge import jax_params, port_model
from test_torch_decode_loop import JCFG, engine, mixed_run

torch.set_num_threads(2)

TOOLKIT = {"device_kind": "NVIDIA H100 80GB HBM3 sm_90",
           "nvcc_version": "Cuda compilation tools, release 12.8, V12.8.93",
           "torch_cuda": "12.8"}
LIBS = sorted(kernels.SIGNATURES)


class Builder:
    """A stand-in for nvcc: writes ``library <name>`` to the output file
    and counts its calls by library."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self._lock = threading.Lock()

    def __call__(self, name: str, out: Path) -> str:
        with self._lock:
            self.calls[name] = self.calls.get(name, 0) + 1
        Path(out).write_bytes(f"library {name}".encode())
        return ""


def make_cache(root, toolkit=None, builder=None) -> CompileCache:
    tk = dict(TOOLKIT, **(toolkit or {}))
    return CompileCache(str(root), builder=builder or Builder(),
                        toolkit=lambda: tk)


@pytest.fixture(autouse=True)
def restore_installed():
    saved = dict(kernels._installed)
    yield
    kernels._installed.clear()
    kernels._installed.update(saved)


def entry_dir(cache, name):
    rows = [r for r in cache.entries() if r["name"] == name]
    assert len(rows) == 1
    return Path(cache.root, name, rows[0]["fingerprint"])


# ---------------------------------------------------------------------------
# key anatomy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["name", "device_kind", "source_digest",
                                   "nvcc_flags", "nvcc_version",
                                   "torch_cuda"])
def test_cache_key_rolls_on_each_field(tmp_path, field):
    cache = make_cache(tmp_path)
    base = cache.key_for("conv_bwd")
    assert base.fingerprint() == make_cache(tmp_path).key_for(
        "conv_bwd").fingerprint()
    if field == "name":
        other = cache.key_for("flash_attention")
    elif field in TOOLKIT:
        other = make_cache(tmp_path, {field: "other"}).key_for("conv_bwd")
    else:
        value = ("0" * 16 if field == "source_digest"
                 else (*base.nvcc_flags, "-lineinfo"))
        other = tcache.CacheKey(**{**base.__dict__, field: value})
    assert other.fingerprint() != base.fingerprint()
    assert set(base.payload()) == {"name", "device_kind", "source_digest",
                                   "nvcc_flags", "nvcc_version",
                                   "torch_cuda"}


def test_cache_key_holds_the_library_s_source(tmp_path):
    """The source digest is the one ``kernels.lib_path`` keys the build
    with: the .cu file, every .cuh header and the flags."""
    key = make_cache(tmp_path).key_for("flash_attention")
    assert key.source_digest == kernels.source_digest("flash_attention")
    assert kernels.lib_path("flash_attention").name == (
        f"libflash_attention_{key.source_digest}.so")
    assert list(key.nvcc_flags) == kernels.NVCC_FLAGS
    with pytest.raises(KeyError, match="no kernel library"):
        make_cache(tmp_path).key_for("segment_body")


@pytest.mark.parametrize("sizes", [None, dict(), dict(dp=2, tp=4),
                                   dict(fsdp=8), dict(dp=1, tp=1)], ids=str)
def test_mesh_signature_is_the_reference_s(sizes):
    got = tcache.mesh_signature(None if sizes is None else MeshSpec(**sizes))
    want = jcache.mesh_signature(None if sizes is None
                                 else JMeshSpec(**sizes))
    assert got == want


def test_default_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("KO_AOT_CACHE", str(tmp_path / "env"))
    assert tcache.default_cache_dir() == str(tmp_path / "env")
    monkeypatch.delenv("KO_AOT_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tcache.default_cache_dir() == str(
        tmp_path / ".cache" / "kubeoperator-tpu-torch" / "aot")
    assert tcache.default_cache_dir() != jcache.default_cache_dir()


# ---------------------------------------------------------------------------
# cold and warm bring-up
# ---------------------------------------------------------------------------

def test_cold_builds_each_library_once_warm_builds_none(tmp_path):
    builder = Builder()
    cache = make_cache(tmp_path, builder=builder)
    with compile_count_guard() as guard:
        cold = cache.consult("Trainer", LIBS, mesh_spec=MeshSpec())
    assert not cold.hit and cold.source == "compile"
    assert [r.name for r in cold.libraries] == LIBS
    assert all(not r.hit and r.source == "compile" for r in cold.libraries)
    guard.assert_single_compile()
    assert guard.by_function() == {n: {"signatures": 1, "traces": 1}
                                   for n in LIBS}
    assert builder.calls == {n: 1 for n in LIBS}
    for r in cold.libraries:                  # installed for the wrappers
        assert kernels._installed[r.name] == Path(r.path).resolve()
        assert Path(r.path).read_bytes() == f"library {r.name}".encode()

    again = make_cache(tmp_path, builder=builder)
    with compile_count_guard() as guard:
        warm_ = again.consult("Trainer", LIBS)
    guard.assert_zero_compiles()
    assert warm_.hit and warm_.source == "cache"
    assert warm_.fingerprint == cold.fingerprint
    assert [r.path for r in warm_.libraries] == [r.path
                                                 for r in cold.libraries]
    assert builder.calls == {n: 1 for n in LIBS}
    assert (cache.misses, again.hits) == (len(LIBS), len(LIBS))


def test_a_consumer_with_no_library_builds_and_writes_nothing(tmp_path):
    cache = make_cache(tmp_path)
    with compile_count_guard() as guard:
        res = cache.consult("SlotPoolEngine", [])
    guard.assert_zero_compiles()
    assert (res.hit, res.source, res.libraries, res.fingerprint) == (
        True, "none", (), "none")
    assert os.listdir(tmp_path) == [] and cache.entries() == []


def test_the_mesh_goes_into_the_meta_only(tmp_path):
    cache = make_cache(tmp_path)
    solo = cache.load_or_compile("conv_bwd")
    meshed = cache.load_or_compile("conv_bwd", mesh_spec=MeshSpec(dp=2,
                                                                  tp=4))
    assert meshed.fingerprint == solo.fingerprint and meshed.hit
    row, = cache.entries()
    assert cache.meta(row)["mesh"] == "solo"
    assert "mesh" not in row["key"]


# ---------------------------------------------------------------------------
# failure semantics: a bad entry is quarantined, rebuilt, and a miss
# ---------------------------------------------------------------------------

def rebuilt_after(tmp_path, damage) -> tuple:
    builder = Builder()
    cache = make_cache(tmp_path, builder=builder)
    cache.load_or_compile("conv_bwd")
    entry = entry_dir(cache, "conv_bwd")
    damage(entry)
    with compile_count_guard() as guard:
        res = cache.load_or_compile("conv_bwd")
    return cache, builder, guard, res, entry


def test_corrupt_artifact_is_quarantined_rebuilt_and_a_miss(tmp_path):
    def corrupt(entry):
        (entry / "artifact.so").write_bytes(b"\x00not a library")

    cache, builder, guard, res, entry = rebuilt_after(tmp_path, corrupt)
    assert not res.hit and res.source == "compile"
    assert (cache.misses, cache.hits) == (2, 0)
    assert guard.total("conv_bwd") == 1 and builder.calls["conv_bwd"] == 2
    assert (entry / "artifact.so").read_bytes() == b"library conv_bwd"
    assert any(".corrupt-" in d for d in os.listdir(entry.parent))
    # the rebuilt entry serves the next bring-up
    assert cache.load_or_compile("conv_bwd").hit


@pytest.mark.parametrize("field", ["nvcc_version", "torch_cuda",
                                   "device_kind", "source_digest"])
def test_toolkit_mismatch_is_quarantined_and_rebuilt(tmp_path, field):
    def skew(entry):
        meta = json.loads((entry / "meta.json").read_text())
        meta["key"][field] = "something else"
        (entry / "meta.json").write_text(json.dumps(meta))

    cache, builder, guard, res, entry = rebuilt_after(tmp_path, skew)
    assert not res.hit and cache.misses == 2
    assert guard.total() == 1 and builder.calls["conv_bwd"] == 2
    assert any(".corrupt-" in d for d in os.listdir(entry.parent))
    meta = json.loads((entry / "meta.json").read_text())
    assert meta["key"][field] == cache.key_for("conv_bwd").payload()[field]


def test_wrong_kind_or_schema_is_rebuilt(tmp_path):
    def relabel(entry):
        meta = json.loads((entry / "meta.json").read_text())
        meta["kind"], meta["schema"] = "executable", 0
        (entry / "meta.json").write_text(json.dumps(meta))

    cache, _, guard, res, _ = rebuilt_after(tmp_path, relabel)
    assert not res.hit and guard.total() == 1


def test_a_failed_build_raises_and_publishes_nothing(tmp_path):
    def broken(name, out):
        raise RuntimeError(f"nvcc failed for {name}")

    cache = make_cache(tmp_path, builder=broken)
    with compile_count_guard() as guard:
        with pytest.raises(RuntimeError, match="nvcc failed for conv_bwd"):
            cache.consult("Trainer", ["conv_bwd"])
    assert guard.total() == 0 and cache.entries() == []
    assert os.listdir(tmp_path / "conv_bwd") == []
    assert all(tmp_path not in p.parents for p in kernels._installed.values())


# ---------------------------------------------------------------------------
# concurrency: one cache directory, one published entry
# ---------------------------------------------------------------------------

def test_concurrent_bring_up_publishes_one_winner(tmp_path):
    builder = Builder()
    results, errors = [], []
    start = threading.Barrier(4)

    def bring_up():
        try:
            start.wait(timeout=30)
            results.append(make_cache(tmp_path, builder=builder)
                           .load_or_compile("conv_bwd"))
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=bring_up) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    cache = make_cache(tmp_path, builder=builder)
    assert len(cache.entries()) == 1
    assert [d for d in os.listdir(tmp_path / "conv_bwd") if ".tmp-" in d
            ] == []
    assert {r.path for r in results} == {str(entry_dir(cache, "conv_bwd")
                                              / "artifact.so")}
    assert (entry_dir(cache, "conv_bwd") / "artifact.so").read_bytes() == (
        b"library conv_bwd")
    assert cache.load_or_compile("conv_bwd").hit


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

def test_guard_counts_each_build_by_library_and_digest():
    with compile_count_guard() as outer:
        with compile_count_guard() as inner:
            kernels.report_compile("conv_bwd")
        kernels.report_compile("flash_attention")
        kernels.report_compile("flash_attention")
    assert kernels.guards == []
    digest = kernels.source_digest("conv_bwd")
    assert inner.counts == {("conv_bwd", digest): 1}
    assert inner.traces_for("conv_bwd") == [1] and inner.total() == 1
    assert outer.total() == 2 and outer.traces_for("flash_attention") == [2]
    inner.assert_single_compile()
    with pytest.raises(AssertionError, match="rebuild detected"):
        outer.assert_single_compile()
    outer.assert_single_compile("conv_bwd")
    with pytest.raises(AssertionError, match="expected zero nvcc builds"):
        inner.assert_zero_compiles()
    inner.assert_zero_compiles("flash_attention")
    assert outer.signature_names() == {"flash_attention"}
    kernels.report_compile("conv_bwd")          # no guard: nothing counts
    assert outer.total() == 2


def test_guard_baseline_is_the_declared_libraries():
    with compile_count_guard() as guard:
        for name in kernels.SIGNATURES:
            guard.record_aot_compile(name, "d")
    guard.assert_within_baseline()
    guard.record_aot_compile("segment_body", "d")
    with pytest.raises(AssertionError, match="segment_body"):
        guard.assert_within_baseline()
    guard.assert_within_baseline(names={"conv_bwd"})


def test_the_guard_patches_nothing_at_import():
    import importlib

    from kubeoperator_tpu_torch.analysis import compile_guard

    build, load = kernels.build, kernels.load
    importlib.reload(compile_guard)
    assert (kernels.build, kernels.load, kernels.guards) == (build, load, [])
    assert compile_guard.active_guard() is None
    with compile_guard.compile_count_guard() as g:
        assert compile_guard.active_guard() is g
    assert compile_guard.active_guard() is None


# ---------------------------------------------------------------------------
# installing a library into kernels
# ---------------------------------------------------------------------------

def test_install_points_the_next_load_at_the_cache_s_file(tmp_path,
                                                          monkeypatch):
    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)

        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_lib_paths", {})
    res = make_cache(tmp_path).load_or_compile("conv_bwd")
    lib = kernels.load("conv_bwd")
    assert kernels.load("conv_bwd") is lib           # one handle
    assert kernels.loaded_path("conv_bwd") == Path(res.path).resolve()
    again = make_cache(tmp_path).load_or_compile("conv_bwd")
    assert again.hit and kernels.load("conv_bwd") is lib
    assert opened == [str(Path(res.path).resolve())]
    with pytest.raises(KeyError, match="no kernel library"):
        kernels.install("nope", res.path)


# ---------------------------------------------------------------------------
# consumers: the engine, the trainers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return port_model(JCFG, jax_params(JCFG, seed=7))


def test_engine_with_a_cache_is_bit_equal_and_builds_nothing(model,
                                                             tmp_path):
    want = mixed_run(engine(model, slots=4, segment=3))
    cache = make_cache(tmp_path)
    with compile_count_guard() as guard:
        eng = engine(model, slots=4, segment=3, compile_cache=cache)
        got = mixed_run(eng)
    guard.assert_zero_compiles()
    assert got == want
    assert (eng.aot.hit, eng.aot.source, eng.aot.libraries) == (True, "none",
                                                                ())
    assert eng.aot.name == "SlotPoolEngine" and cache.entries() == []


def test_trainers_consult_for_the_libraries_they_launch(tmp_path):
    """On the CPU every kernel runs its plain version, so no trainer
    launches a library there; on the card the K7/K8 ResNet takes
    ``conv_bwd`` and ``batch_norm``, the flash LM and ViT
    ``flash_attention``, the bf16 ResNet at the reference's defaults
    ``batch_norm`` (tests/test_torch_aot_cuda.py)."""
    from kubeoperator_tpu_torch.profile_lm import RESNET_K7_K8
    from kubeoperator_tpu_torch.workloads.lm import LMTrainer
    from kubeoperator_tpu_torch.workloads.train import Trainer
    from kubeoperator_tpu_torch.workloads.transformer import (
        TransformerConfig,
    )
    from kubeoperator_tpu_torch.workloads.vit import ViTConfig, ViTTrainer

    cache = make_cache(tmp_path)
    for tr in (Trainer(RESNET_K7_K8, compile_cache=cache, device="cpu"),
               LMTrainer(TransformerConfig(attention="flash"),
                         compile_cache=cache, device="cpu"),
               ViTTrainer(ViTConfig(), compile_cache=cache, device="cpu")):
        assert (tr.aot.name, tr.aot.source) == (type(tr).__name__, "none")
    assert Trainer(RESNET_K7_K8, device="cpu").aot is None
    assert cache.entries() == []


# ---------------------------------------------------------------------------
# control plane: warm catalog, purge refusal, status, metrics, the CLI
# ---------------------------------------------------------------------------

def test_catalog_keeps_the_reference_s_entries():
    from kubeoperator_tpu.aot import CATALOG as JCATALOG

    for name, (_, kwargs) in JCATALOG.items():
        assert CATALOG[name][1] == kwargs, name
    assert set(CATALOG) - set(JCATALOG) == {"train-k7k8", "lm-bench"}


def test_warm_then_all_hits(tmp_path, monkeypatch):
    """The catalog through a stand-in cache on the CPU, whose consumers
    launch no library there: the card's entries are held to their
    libraries by faking the card (``train-k7k8`` → ``conv_bwd`` and
    ``batch_norm``, ``lm-bench`` → ``flash_attention``; nothing is built on
    a device)."""
    import kubeoperator_tpu_torch.workloads.train as ttrain

    rows = warm(make_cache(tmp_path), device="cpu")
    assert [(r["entry"], r["function"], r["source"], r["hit"])
            for r in rows] == [("serve-smoke", "SlotPoolEngine", "none",
                                True), ("train-smoke", "Trainer", "none",
                                        True)]
    # the card's configurations: a trainer built for "cuda" allocates
    # nothing at construction, so a fake card is enough to consult
    monkeypatch.setattr(ttrain.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ttrain.torch.cuda, "current_device", lambda: 0)
    cold = warm(make_cache(tmp_path), ["train-k7k8", "lm-bench"])
    assert [(r["entry"], r["libraries"], r["hit"], r["source"])
            for r in cold] == [("train-k7k8", ["conv_bwd", "batch_norm"],
                                False, "compile"),
                               ("lm-bench", ["flash_attention"], False,
                                "compile")]
    again = warm(make_cache(tmp_path), ["train-k7k8", "lm-bench"])
    assert all(r["hit"] and r["source"] == "cache" for r in again)
    assert [r["fingerprint"] for r in again] == [r["fingerprint"]
                                                  for r in cold]
    with pytest.raises(KeyError, match="no-such-entry"):
        warm(make_cache(tmp_path), ["no-such-entry"])


def test_purge_refuses_in_use_entries(tmp_path):
    cache = make_cache(tmp_path)
    fp = cache.load_or_compile("conv_bwd").fingerprint
    assert cache.purge() == {"removed": [], "refused": [fp]}
    # the refusal is cross-process: a fresh cache object (no in-process
    # set) still sees the live pid marker
    other = make_cache(tmp_path)
    assert other.purge(fp)["refused"] == [fp]
    assert other.purge(fp, force=True)["removed"] == [fp]
    assert other.entries() == []


def test_a_dead_holder_does_not_hold_an_entry(tmp_path):
    cache = make_cache(tmp_path)
    fp = cache.load_or_compile("conv_bwd").fingerprint
    marker = entry_dir(cache, "conv_bwd") / "in_use.json"
    marker.write_text(json.dumps({"pid": 2 ** 22 + 12345, "at": 0}))
    other = make_cache(tmp_path)
    row, = other.entries()
    assert (row["in_use"], row["holder_pid"]) == (False, None)
    assert other.purge()["removed"] == [fp]


def test_entries_rows_have_the_reference_s_fields(tmp_path):
    jc = JaxCompileCache(str(tmp_path / "jax"))
    jc.load_or_compile("f", jax.jit(lambda x: x + 1),
                       (jnp.zeros((2,), jnp.float32),))
    cache = make_cache(tmp_path / "port")
    cache.load_or_compile("conv_bwd")
    want, got = jc.entries()[0], cache.entries()[0]
    assert set(got) == set(want)
    assert got["kind"] == "library" and got["size_bytes"] > len(
        b"library conv_bwd")
    assert (got["in_use"], got["holder_pid"]) == (True, os.getpid())
    assert set(cache.status()) == set(jc.status())


def test_status_and_metrics_flow(tmp_path):
    before = tmetrics.REGISTRY.render()
    cache = make_cache(tmp_path)
    cache.consult("Trainer", ["conv_bwd"])
    make_cache(tmp_path).consult("Trainer", ["conv_bwd"])
    st = cache.status()
    assert st["root"] == str(tmp_path)
    assert (st["count"], st["misses"], st["hits"]) == (1, 1, 0)
    assert st["total_bytes"] > 0
    text = tmetrics.REGISTRY.render()
    for name in ('ko_aot_cache_misses_total{fn="conv_bwd"}',
                 'ko_aot_cache_hits_total{fn="conv_bwd"}'):
        n_before = sum(float(line.split()[-1]) for line in before.splitlines()
                       if line.startswith(name))
        n_after = sum(float(line.split()[-1]) for line in text.splitlines()
                      if line.startswith(name))
        assert n_after == n_before + 1, name
    assert ('ko_aot_bringup_seconds_bucket{fn="conv_bwd",outcome="hit"'
            in text)


def test_aot_families_are_the_reference_s():
    got = tmetrics.declare_aot_metrics(tmetrics.Registry())
    want = jmetrics.declare_aot_metrics(jmetrics.Registry())
    assert set(got) == set(want)
    for k in want:
        assert (got[k].name, got[k].type, got[k].labels) == (
            want[k].name, want[k].type, want[k].labels)
    assert got["bringup"].buckets == want["bringup"].buckets
    assert tmetrics.AOT_BRINGUP_BUCKETS == jmetrics.AOT_BRINGUP_BUCKETS
    names = set(tmetrics.REGISTRY.names())
    assert {f.name for f in got.values()} <= names


def test_cli_list_status_purge(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tcache, "card_toolkit", lambda: TOOLKIT)
    cache = make_cache(tmp_path)
    fp = cache.load_or_compile("conv_bwd",
                               mesh_spec=MeshSpec(dp=2)).fingerprint
    assert cli.main(["list", "--cache", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["NAME", "FINGERPRINT", "KIND", "MESH", "KIB",
                              "IN_USE"]
    assert out[1].split()[:4] == ["conv_bwd", fp, "library", "dp2"]
    assert cli.main(["status", "--cache", str(tmp_path)]) == 0
    assert capsys.readouterr().out.startswith(
        f"{tmp_path}: 1 artifact(s), ")
    assert cli.main(["purge", "--cache", str(tmp_path)]) == 1
    assert f"refused {fp}" in capsys.readouterr().err
    assert cli.main(["purge", fp, "--cache", str(tmp_path), "--force"]) == 0
    assert capsys.readouterr().out == f"removed {fp}\n"
    assert cli.main(["list", "--cache", str(tmp_path)]) == 0
    assert capsys.readouterr().out == "(none)\n"


def test_cli_warm_needs_nvcc(tmp_path, monkeypatch):
    """Without nvcc (``which`` finds none, as on the CPU test hosts)
    ``warm`` raises ``kernels._nvcc``'s error before building anything."""
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc not found: the CUDA "
                                           "kernels are built on the machine"):
        cli.main(["warm", "train-k7k8", "--cache", str(tmp_path)])
