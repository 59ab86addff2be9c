"""``BENCHMARK.json`` against the contract it is written to, and every
file it names resolved by the harness."""

import json
import math
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head_size|expansion|experts_per_tok|width")


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench).encode()) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (spec.ROOT / p).is_dir()
    named = [w for w in bench["command"] if w.endswith(".py")]
    assert named and all(any(w.startswith(p + "/") for p in bench["paths"])
                         for w in named)


def test_run_seconds_fit_the_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # 24 cells: 2 + 14·24 runs of rs + 60 s, 2·90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
            assert key in body


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    names = [w["name"] for w in cells]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(len(cells) * 0.25))
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        cell = spec.resolve(bench, w["name"])
        assert cell.module().OP_RANGES is not None
        assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_metrics(bench):
    e2e, per = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    assert "setup_s" in names
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in e2e}
        assert line(m["layer"])
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert callable(spec.metric_reader(m["name"]))
    for m in per:
        mover = next(e for e in e2e if e["name"] == m["moves"])
        assert all(spec.applies(mover, w) for w in m.get("workloads", cells))
    for w in cells:
        here = [m for m in e2e + per if spec.applies(m, w)]
        kinds = {("e2e" if m in e2e else "layer") for m in here}
        assert kinds == {"e2e", "layer"}
        assert len([m for m in here if m in e2e]) >= 2


def test_layers_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"trainer", "model", "conv backward kernels",
                      "attention kernels", "mesh", "device"}


def test_resolve_refuses_an_unknown_cell(bench):
    with pytest.raises(KeyError):
        spec.resolve(bench, "no.such.cell")
