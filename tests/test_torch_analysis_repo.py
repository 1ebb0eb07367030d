"""The port's static-analysis suite on the port's real tree: clean
against its committed baseline, every waiver and baseline entry
reasoned, the catalog, and the suite's own imports. The counterparts
of the integration tests of ``tests/test_analysis.py``; the CLI's are
in ``tests/test_torch_analysis_cli.py``.
"""

import ast
import os

from rafiki_torch.analysis import core
from rafiki_torch.analysis.catalog import CATALOG
from rafiki_torch.analysis.core import load_baseline, run_suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("torch", "triton", "numpy", "rafiki_tpu", "jax")


def test_the_port_is_clean_against_its_baseline():
    baseline = load_baseline(core.baseline_path())
    report = run_suite(REPO, baseline=baseline)
    assert report.new == [], "\n".join(f.render() for f in report.new)
    assert report.stale_baseline == []
    assert "aliasing" in report.checkers and "flow" in report.timings
    # Every finding is settled one by one, with a reason.
    for f in report.findings:
        assert f.status in ("waived", "baselined"), f.render()
        assert len(f.reason) > 15, f.render()
    # The operator-only routes are waived at their tuples.
    assert "RTA702" in {f.code for f in report.findings
                        if f.status == "waived"}


def test_the_committed_baseline_is_short_and_reasoned():
    baseline = load_baseline(core.baseline_path())
    assert 0 < len(baseline) <= 25
    for ident, reason in baseline.items():
        assert ident.split(":")[1].startswith("rafiki_torch/"), ident
        assert reason and not reason.startswith("UNREVIEWED"), ident
        assert len(reason) > 15, f"{ident}: reason too thin"


def test_catalog_covers_every_registered_code():
    codes = {c for ch in core.all_checkers() for c in ch.codes}
    codes |= {"RTA000", "RTA001", "RTA002", "RTA003"}
    assert codes <= set(CATALOG), sorted(codes - set(CATALOG))
    assert "torch" in CATALOG["RTA602"]["flags"]
    assert "CUDA graph" in CATALOG["RTA402"]["title"]


def test_the_suite_imports_only_the_standard_library():
    """``rafiki_torch/analysis/`` names no torch, numpy or reference
    import anywhere in its source."""
    import ast

    pkg = os.path.join(REPO, "rafiki_torch", "analysis")
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for name in names:
                    assert name.split(".")[0] not in BLOCKED + (
                        "rafiki_torch",), (fn, name)
