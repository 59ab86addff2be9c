"""The multi-rank test harness (``torch_dist_cases.spawn_group``) on 2
gloo ranks: a case that raises on one rank, while the other waits in a
collective, fails its own tests with that rank's traceback, and the cases
after it still run, on a new spawn; each rank logs when each case ran."""

import json

import pytest
import torch

from torch_dist_cases import CaseFailed, spawn_group

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("harness")
    return workdir, spawn_group("harness", 2, workdir, {})


@pytest.mark.parametrize("case", ["before", "after"])
def test_the_cases_around_a_failure_pass(run, case):
    _, ranks = run
    assert [r[case] for r in ranks] == [{"sum": 3.0}] * 2


def test_the_failing_case_reports_the_rank_s_traceback(run):
    _, ranks = run
    for r in ranks:
        with pytest.raises(CaseFailed, match="rank 1 fails on purpose"):
            r["fails"]["anything"]
    with pytest.raises(CaseFailed, match=r"-- rank 1:\nTraceback"):
        list(ranks[0]["fails"])


def test_each_rank_logs_its_cases_times(run):
    workdir, _ = run
    for rank in (0, 1):
        lines = (workdir / f"harness.rank{rank}.times.jsonl").read_text()
        rows = [json.loads(x) for x in lines.splitlines()]
        assert [r["case"] for r in rows] == ["before", "after"]
        assert all(r["end"] >= r["start"] for r in rows)
