"""The port's static-analysis suite against the reference's, on the
reference's framework-neutral fixture trees and on the CLI.

Each fixture of ``tests/analysis_fixtures/`` (guarded, thread, series,
drift, concurrency, flow, stale_waiver; true-positive and false-positive
form) is copied into two tmp trees: as it is under ``rafiki_tpu/``, and
under ``rafiki_torch/`` with the module paths of its imports rewritten
(metric names and ``RAFIKI_TPU_*`` literals stay, as the port keeps
them). Both suites run in full, and the findings' (code, path inside
the package, line, anchor) must be the same sets. The jax and torch
fixtures (donation, imports) differ by design; the port's own are in
``tests/torch_analysis_fixtures/``.
"""

import pytest

from _torch_analysis import KINDS, fixture_tree
from rafiki_torch.analysis import __main__ as pmain
from rafiki_torch.analysis import core as pcore
from rafiki_tpu.analysis import __main__ as rmain
from rafiki_tpu.analysis import core as rcore


def _key(report, pkg):
    return {(f.code, f.path.replace(pkg + "/", "", 1), f.line,
             f.anchor.replace(pkg + ".", "")) for f in report.findings}


@pytest.mark.parametrize("form", ["tp", "fp"])
@pytest.mark.parametrize("kind", KINDS)
def test_the_port_finds_what_the_reference_finds(kind, form, tmp_path):
    fixture = f"{kind}_{form}"
    ref = rcore.run_suite(fixture_tree(fixture, str(tmp_path / "r"),
                                       "rafiki_tpu"))
    port = pcore.run_suite(fixture_tree(fixture, str(tmp_path / "p")))
    got, want = _key(port, "rafiki_torch"), _key(ref, "rafiki_tpu")
    assert got == want, (sorted(got - want), sorted(want - got))
    if form == "tp":
        assert want - {k for k in want if k[3] == "load"}


def _parsed(main_mod, core_mod, argv, monkeypatch):
    """What ``main(argv)`` hands the suite, or how it exits."""
    seen = []

    class Stop(Exception):
        pass

    def run_suite(root, changed=None, baseline=None, only=None):
        seen.append({"root": root, "changed": changed,
                     "baseline": baseline, "only": only})
        raise Stop

    monkeypatch.setattr(core_mod, "repo_root", lambda: "/checkout")
    monkeypatch.setattr(core_mod, "baseline_path", lambda: "/baseline")
    monkeypatch.setattr(core_mod, "load_baseline",
                        lambda path: {"from": path})
    monkeypatch.setattr(core_mod, "changed_files",
                        lambda root, base=None: {root, str(base)})
    monkeypatch.setattr(core_mod, "run_suite", run_suite)
    try:
        main_mod.main(argv)
    except SystemExit as e:
        return ("exit", e.code)
    except Stop:
        pass
    return seen


@pytest.mark.parametrize("argv", [
    [], ["--json"], ["--root", "/r"], ["--changed"], ["--diff", "HEAD~2"],
    ["--baseline", "/b.json"], ["--no-baseline"],
    ["--checker", "flow"], ["--checker", "drift", "--checker", "flow"],
    ["--checker", "nope"], ["--changed", "--diff", "HEAD"],
    ["--update-baseline", "--changed"], ["--update-baseline", "--diff", "X"],
    ["--update-baseline", "--checker", "flow"], ["--explain", "rta104"],
    ["--explain", "RTA999"], ["--nope"], ["--diff"]])
def test_the_cli_parses_as_the_reference(argv, monkeypatch, capsys):
    got = [_parsed(m, c, list(argv), monkeypatch)
           for m, c in ((pmain, pcore), (rmain, rcore))]
    capsys.readouterr()
    assert got[0] == got[1]
