"""``BENCHMARK.json`` and the files it names.

Everything a cell needs is found by a name in ``BENCHMARK.json``:

- the configuration ``<config>``: its sizes in the file the entry names
  (``configs/<config>.json``) and, beside it, ``configs/<config>.py``:
  how to build the port's trainer, make the weights, count the FLOPs and
  bound the kernels' work, with the plain reference it imports;
- the traffic mix ``<traffic>``: ``traffic/<traffic>.json``, read by the
  one generator (``harness/traffic.py``);
- each metric ``<name>``: ``metrics/<name>.py`` with ``read(run)``;
- the cell's correctness limits: ``limits/<workload>.json``.

A later cell, mix or metric is added as files and entries; no file of the
harness changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, kind: str):
    """The module at ``path``, imported once per process under a name made
    from ``kind`` and the path (a metric's or configuration's name may hold
    dots and dashes, which a module's name may not)."""
    digest = hashlib.sha256(str(path.resolve()).encode()).hexdigest()[:16]
    name = f"portbench_{kind}_{digest}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``'s ``read``."""
    mod = load_module(bench_dir / "metrics" / f"{name}.py", "metric")
    return mod.read


@dataclass
class Cell:
    """One entry of ``workloads``, with what it names resolved."""
    name: str
    chips: int
    config_name: str
    config: dict
    config_path: Path
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    limits: dict = field(default_factory=dict)

    def module(self):
        """The configuration's module, ``configs/<config>.py`` beside its
        file of sizes."""
        return load_module(self.config_path.with_suffix(".py"), "config")

    @property
    def global_batch(self) -> int:
        return self.traffic["batch_per_chip"] * self.chips


def applies(metric: dict, workload: str) -> bool:
    """Whether ``metric`` is reported in ``workload``: every cell, or
    those its ``workloads`` key lists."""
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(spec: dict, workload: str, root: Path = ROOT,
            bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named ``workload``; raises KeyError for a name the spec
    does not hold and FileNotFoundError for a file it names and lacks."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    config_path = root / conf["file"]
    limits_path = bench_dir / "limits" / f"{workload}.json"
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=conf["name"],
        config=load_json(config_path), config_path=config_path,
        traffic_name=w["traffic"],
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if applies(m, workload)],
        limits=load_json(limits_path))
