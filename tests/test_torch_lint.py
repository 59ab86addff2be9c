"""The port's hot-path lint (``kubeoperator_tpu_torch.analysis.lint``):
each rule fires on a bad snippet and stays quiet on its good twin, the
pragma's reason is mandatory (KO000) and names a known rule (KO001), a
pragma with its reason suppresses, and the port's tree and
``chip_smoke.py`` are clean at ``warning`` with every suppression
giving its reason. The rules are the counterparts of the reference's
tests/test_lint.py cases for KO101, KO102 and KO121-KO123."""

import json
import textwrap
from pathlib import Path

import pytest
import torch

from kubeoperator_tpu_torch.analysis import lint

torch.set_num_threads(2)


def rules_of(src: str) -> list[str]:
    found, _ = lint.lint_source("snippet.py", textwrap.dedent(src))
    return sorted(f.rule for f in found)


ENGINE_HEAD = """
import torch

class Engine:
    def _page_write(self, pool, pages, offsets, vals):
        pool[pages, offsets] = vals

    def _page_copy(self, pool, dst, src):
        pool[dst] = pool[src]

    def _gather_kv(self, pool, scale, idx):
        return pool[idx]

    def _rewind(self, pos0, adv, last, live):
        self._pos.copy_(torch.where(live, torch.minimum(pos0 + adv, last),
                                    pos0))
"""

# rule -> (bad, good): each snippet a whole module
CASES = {
    "KO101": (
        """
        import torch
        def admit(rows, dev):
            for row in rows:
                t = torch.as_tensor(row, device=dev)
        def land(payload, dev):
            while payload:
                x = payload.pop().to(dev)
        """,
        """
        import numpy as np
        import torch
        def admit(rows, dev):
            t = torch.as_tensor(np.stack(rows), device=dev)
            for i in range(len(rows)):
                y = t[i].to(torch.float32)
        """),
    "KO102": (
        """
        import torch
        def drain(eng, dev):
            pos = torch.zeros(4, device=dev)
            for _ in range(8):
                eng.step()
                if int(pos[0]) > 3 or pos.max().item() > 5:
                    break
                rows = eng.buf.cpu()
        """,
        """
        import torch
        def drain(eng, rows):
            pos = torch.zeros(4)
            host = pos.tolist()
            for r in rows:
                n = len(r.tolist()) + int(host[0])
        """),
    "KO121": (
        ENGINE_HEAD + """
    def admit(self, pages, vals):
        self._pools[0][0][pages] = vals
        pool = self._pools[1][1]
        pool.index_copy_(0, pages, vals)
""",
        ENGINE_HEAD + """
    def admit(self, pages, offsets, vals):
        for kp, vp in self._pools:
            self._page_write(kp, pages, offsets, vals)
        self._pools[0] = (vals, vals)
"""),
    "KO122": (
        ENGINE_HEAD + """
    def forward(self, idx):
        return self._pools[0][0][idx] + self.k_pool[idx]
""",
        ENGINE_HEAD + """
    def forward(self, idx):
        h = self._pools[0][0].shape[2]
        first = self._pools[:1]
        return self._gather_kv(self._pools[0][0], None, idx), h, first
"""),
    "KO123": (
        ENGINE_HEAD + """
    def step(self, last, slot):
        self._pos = torch.minimum(self._pos, last)
        self._pos.clamp_(max=7)
        self._bt_np[slot, :] = 0
""",
        ENGINE_HEAD + """
    def step(self, last, live, adv):
        nxt = (self._pos + 1).clamp(max=7)
        self._pos += live
        self._rewind(self._pos.clone(), adv, last, live)

    def release(self, slot, trash):
        self._bt_np[slot, :] = trash
"""),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_on_the_bad_snippet(rule):
    bad, _ = CASES[rule]
    got = rules_of(bad)
    assert got and set(got) == {rule}, got


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_quiet_on_the_good_twin(rule):
    _, good = CASES[rule]
    assert rules_of(good) == []


def test_bad_snippets_count_every_site():
    """KO101 twice (an as_tensor and a .to), KO102 three times (int(),
    .item(), .cpu()), KO121 twice, KO122 twice, KO123 three times."""
    counts = {rule: len(rules_of(bad)) for rule, (bad, _) in CASES.items()}
    assert counts == {"KO101": 2, "KO102": 3, "KO121": 2, "KO122": 2,
                      "KO123": 3}


def test_modules_without_torch_are_not_linted():
    assert rules_of("""
        import numpy as np
        def f(rows):
            for r in rows:
                r.cpu()
        """) == []


def test_pragma_needs_a_reason_and_a_known_rule():
    bare = """
        import torch
        def f(rows, dev):
            for r in rows:
                x = torch.as_tensor(r, device=dev)  # ko: lint-ok[KO101]
        """
    assert rules_of(bare) == ["KO000"]               # suppressed, but bare
    unknown = """
        import torch
        def f(rows, dev):
            for r in rows:
                x = torch.as_tensor(r, device=dev)  # ko: lint-ok[KO999] why
        """
    assert rules_of(unknown) == ["KO001", "KO101"]
    reasoned = """
        import torch
        def f(rows, dev):
            for r in rows:
                # ko: lint-ok[KO101] a test's setup, once a case
                x = torch.as_tensor(
                    r, device=dev)
        """
    found, suppressed = lint.lint_source("snippet.py",
                                         textwrap.dedent(reasoned))
    assert (found, suppressed) == ([], 1)


def test_the_port_tree_is_clean_and_every_suppression_says_why():
    result = lint.lint_paths(lint.default_paths())
    assert result.files >= 40
    assert result.failing() == [], [f.format() for f in result.findings]
    pragmas = [p for path in lint._iter_files(lint.default_paths())
               for p in lint.scan_pragmas(Path(path).read_text().splitlines())]
    assert pragmas and all(p.reason for p in pragmas)
    assert result.suppressed == len(pragmas)


def test_cli_exit_codes_and_json(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(CASES["KO102"][0]))
    assert lint.main([str(bad), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["warning"] == 3
    assert {f["rule"] for f in report["findings"]} == {"KO102"}
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent(CASES["KO102"][1]))
    assert lint.main([str(good)]) == 0
    assert sorted(lint.RULES) == sorted(CASES)
