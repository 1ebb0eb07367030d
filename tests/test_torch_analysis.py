"""The port's static-analysis suite (``rafiki_torch.analysis``): the
counterparts of the reference's fixture, waiver, stale-waiver, baseline
and ``--changed`` tests in ``tests/test_analysis.py``, on trees whose
package is ``rafiki_torch/``, and the port's own fixtures.

- **Fixture corpus**: per checker, a tree of true positives and one of
  correct code that must stay finding-free (the false-positive guard):
  the reference's framework-neutral fixtures under ``rafiki_torch/``,
  and ``tests/torch_analysis_fixtures/`` for the torch forms of RTA401,
  RTA402 and RTA602.
- **Where the port reads its tree differently**: ``NodeConfig`` from
  the AST, ``apply_env``'s export loops, the fabric predicate as a
  gate, the client's whole-URL ``_send``.
- **Waivers, stale waivers, the baseline and ``--changed``**, as the
  reference's. The real tree, the CLI and the mutation gates are in
  ``tests/test_torch_analysis_repo.py`` and
  ``tests/test_torch_analysis_gates*.py``.
"""

import os
import shutil

from _torch_analysis import fixture_tree, torch_fixture_tree
from rafiki_torch.analysis.core import (Finding, load_baseline, run_suite,
                                        save_baseline)


def _codes(report):
    return sorted({f.code for f in report.findings})


def _run(root, checker):
    return run_suite(root, only=[checker])


def _pkg(tmp_path):
    pkg = tmp_path / "rafiki_torch"
    pkg.mkdir(exist_ok=True)
    return pkg


# --- Fixture corpus: true positive + false-positive guard per checker


def test_guarded_state_true_positives(tmp_path):
    report = _run(fixture_tree("guarded_tp", str(tmp_path / "t")),
                  "guarded-state")
    codes = _codes(report)
    assert "RTA101" in codes and "RTA102" in codes and "RTA103" in codes
    by_anchor = {f.anchor for f in report.findings}
    assert "UnguardedAccess._depth@depth" in by_anchor
    assert "guarded_tp:_mod_depth@mod_depth" in by_anchor
    assert "SelfDeadlock:_lock->_lock" in by_anchor
    assert "LockOrderCycle:_a<->_b" in by_anchor
    assert any("time.sleep" in f.message for f in report.findings)
    assert any("open()" in f.message for f in report.findings)


def test_guarded_state_false_positive_guard(tmp_path):
    report = _run(fixture_tree("guarded_fp", str(tmp_path / "t")),
                  "guarded-state")
    assert report.findings == [], [f.render() for f in report.findings]


def test_thread_lifecycle_true_positives(tmp_path):
    report = _run(fixture_tree("thread_tp", str(tmp_path / "t")),
                  "thread-lifecycle")
    assert _codes(report) == ["RTA201", "RTA202"]


def test_thread_lifecycle_false_positive_guard(tmp_path):
    report = _run(fixture_tree("thread_fp", str(tmp_path / "t")),
                  "thread-lifecycle")
    assert report.findings == [], [f.render() for f in report.findings]


def test_series_lifecycle_true_positive(tmp_path):
    report = _run(fixture_tree("series_tp", str(tmp_path / "t")),
                  "series-lifecycle")
    assert _codes(report) == ["RTA301"]
    anchors = {f.anchor for f in report.findings}
    assert {"label:service", "label:tenant", "label:bin"} <= anchors


def test_series_lifecycle_false_positive_guard(tmp_path):
    report = _run(fixture_tree("series_fp", str(tmp_path / "t")),
                  "series-lifecycle")
    assert report.findings == [], [f.render() for f in report.findings]


def test_aliasing_true_positives(tmp_path):
    report = _run(torch_fixture_tree("aliasing_tp", str(tmp_path / "t")),
                  "aliasing")
    assert _codes(report) == ["RTA401", "RTA402"]
    by_anchor = {f.anchor for f in report.findings}
    # F7: the entry the staging cache keeps is a view of a host array.
    assert "staged_arrays:from_numpy:ds.images" in by_anchor
    assert "staged_arrays:as_tensor:ds.labels" in by_anchor
    # In-place writes of an entry: a _ method, a subscript store, a
    # view's copy_, an out= and an augmented assignment, the last
    # three through a neutral-named helper chain.
    assert "normalise_in_place:div_:images" in by_anchor
    assert "normalise_in_place:store:labels" in by_anchor
    assert "write_through_helpers:copy_:resident[0]" in by_anchor
    assert "write_through_helpers:out:resident" in by_anchor
    assert "write_through_helpers:store:view" in by_anchor
    assert "alias_a_cached_host_array:from_numpy:host" in by_anchor
    # RTA402: returned, returned after an unpack, and kept via a local.
    assert "Runner.__call__:self.static_out" in by_anchor
    assert "Engine.step:self._out" in by_anchor
    assert "Engine.keep:latest" in by_anchor
    assert len(report.findings) == 11


def test_aliasing_false_positive_guard(tmp_path):
    report = _run(torch_fixture_tree("aliasing_fp", str(tmp_path / "t")),
                  "aliasing")
    assert report.findings == [], [f.render() for f in report.findings]


def test_drift_true_positives(tmp_path):
    report = _run(fixture_tree("drift_tp", str(tmp_path / "t")), "drift")
    assert _codes(report) == ["RTA501", "RTA502", "RTA503", "RTA504",
                              "RTA505", "RTA506"]
    msgs = "\n".join(f.message for f in report.findings)
    for text in ("rafiki_tpu_serving_widgets", "'mystery'",
                 "rafiki_tpu_bus_retries_seconds",
                 "rafiki_tpu_renamed_away_total", "RAFIKI_TPU_MYSTERY_KNOB",
                 "RAFIKI_TPU_ROGUE_TWEAK", "rafiki_tpu_serving_gone_seconds",
                 "rafiki_tpu_serving_vanished_seconds"):
        assert text in msgs, text
    assert "rafiki_tpu_bus_wait_seconds'" not in msgs


def test_drift_false_positive_guard(tmp_path):
    report = _run(fixture_tree("drift_fp", str(tmp_path / "t")), "drift")
    assert report.findings == [], [f.render() for f in report.findings]


def test_concurrency_true_positives(tmp_path):
    report = _run(fixture_tree("concurrency_tp", str(tmp_path / "t")),
                  "concurrency")
    assert _codes(report) == ["RTA104", "RTA105", "RTA106"]
    by_anchor = {f.anchor: f for f in report.findings}
    cyc = by_anchor["Coordinator._lock<->StatsSink._lock"]
    assert "Coordinator._tick" in cyc.message
    assert "Coordinator._note" in cyc.message
    assert "sink.py" in cyc.message
    blk = by_anchor["Admission.admit->_backoff:time.sleep()"]
    assert "_backoff -> _pause" in blk.message
    assert "Poller._latest:cross-root" in by_anchor
    assert "MiniService._hits:cross-root" in by_anchor
    cc = by_anchor["BusConsumer._seen:cross-root"]
    assert "'loop'" in cc.message and cc.path.endswith("consumer.py")
    sc = by_anchor["SubmitConsumer._polled:cross-root"]
    assert "'drain'" in sc.message and sc.path.endswith("consumer.py")
    mg = by_anchor["publish->_settle:time.sleep()"]
    assert "rafiki_torch.registry._REG_LOCK" in mg.message
    assert "drain:time.sleep():direct" in by_anchor
    assert "Journal._lock<->rafiki_torch.registry._REG_LOCK" in by_anchor
    dd = by_anchor["flush:time.sleep():direct"]
    assert "rafiki_torch.registry._REG_LOCK" in dd.message
    assert dd.path.endswith("dotted.py")
    assert "Ledger._lock<->rafiki_torch.registry._REG_LOCK" in by_anchor
    hh = by_anchor["FrameHandler._hits:cross-root"]
    assert "'handle'" in hh.message and hh.path.endswith("server.py")
    sp = by_anchor["ParamWorker._seen:cross-root"]
    assert "'loop'" in sp.message and sp.path.endswith("spawnhelper.py")
    assert ("rafiki_torch.modlocks._FLUSH_LOCK<->"
            "rafiki_torch.modlocks._INGEST_LOCK") in by_anchor


def test_concurrency_false_positive_guard(tmp_path):
    report = _run(fixture_tree("concurrency_fp", str(tmp_path / "t")),
                  "concurrency")
    assert report.findings == [], [f.render() for f in report.findings]


def test_import_hygiene_true_positives(tmp_path):
    report = _run(torch_fixture_tree("imports_tp", str(tmp_path / "t")),
                  "import-hygiene")
    assert _codes(report) == ["RTA601", "RTA602"]
    msgs = "\n".join(f.message for f in report.findings)
    for text in ("builds/starts a thread", "binds a socket/server",
                 "spawns a process", "APP_DEBUG", "APP_LEASE", "APP_ELSE",
                 "APP_INVERTED", "APP_SUB_LEASE"):
        assert text in msgs, text
    eager = {f.path: f for f in report.findings if f.code == "RTA602"}
    assert set(eager) == {"rafiki_torch/heavy.py", "rafiki_torch/kernels.py"}
    # Each finding names the import chain from the bus root.
    assert "rafiki_torch/bus/broker.py -> rafiki_torch/heavy.py" \
        in eager["rafiki_torch/heavy.py"].message
    assert eager["rafiki_torch/heavy.py"].anchor == "eager-torch:torch"
    assert ("rafiki_torch/heavy.py -> rafiki_torch/kernels.py"
            in eager["rafiki_torch/kernels.py"].message)
    assert eager["rafiki_torch/kernels.py"].anchor == \
        "eager-torch:triton.language"


def test_import_hygiene_false_positive_guard(tmp_path):
    report = _run(torch_fixture_tree("imports_fp", str(tmp_path / "t")),
                  "import-hygiene")
    assert report.findings == [], [f.render() for f in report.findings]


def test_an_eager_jax_import_is_no_rta602_in_the_port(tmp_path):
    """The reference's jax fixture: the port's broker path may import
    jax (it never does; tests/test_torch_imports.py holds that), but
    RTA602 is about torch here."""
    report = _run(fixture_tree("imports_tp", str(tmp_path / "t")),
                  "import-hygiene")
    assert "RTA602" not in _codes(report)


def test_flow_true_positives(tmp_path):
    report = _run(fixture_tree("flow_tp", str(tmp_path / "t")), "flow")
    assert _codes(report) == ["RTA701", "RTA702", "RTA703"]
    by_anchor = {f.anchor: f for f in report.findings}
    assert "queue:work:" in by_anchor
    assert "queue:lost:" in by_anchor
    assert "op-token:__flush__" in by_anchor
    assert "op-token:__drain2__" in by_anchor
    assert by_anchor["route-call:GET /thingz"].path.endswith("client.py")
    assert "route:POST /orphan" in by_anchor
    flag = "RAFIKI_TPU_CLUSTER_FABRIC"
    assert f"{flag}:import-effect:Thread()" in by_anchor
    assert (f"{flag}:offpath:NodeRegistry.__init__:"
            "rafiki_tpu_node_peers") in by_anchor
    assert f"{flag}:offpath:spawn_pinger:Thread()" in by_anchor
    assert f"{flag}:series:rafiki_tpu_serving_fabric_total" in by_anchor
    assert (f"{flag}:unguarded-ctor:NodeRegistry@"
            "Platform.__init__") in by_anchor


def test_flow_false_positive_guard(tmp_path):
    report = _run(fixture_tree("flow_fp", str(tmp_path / "t")), "flow")
    assert report.findings == [], [f.render() for f in report.findings]


# --- Where the port reads its tree differently ------------------------


def test_the_fabric_predicate_is_a_gate(tmp_path):
    """``if cluster_fabric_enabled():`` gates a construction of the
    fabric's registry as the env name does; an ungated one flags."""
    root = fixture_tree("flow_fp", str(tmp_path / "t"))
    # flow_fp's platform.py imports the fabric-owned NodeRegistry.
    platform = os.path.join(root, "rafiki_torch", "platform.py")
    with open(platform, "a", encoding="utf-8") as f:
        f.write("\n\ndef cluster_fabric_enabled():\n"
                "    return False\n\n\n"
                "class GatedPlatform:\n"
                "    def __init__(self, bus):\n"
                "        self.registry = None\n"
                "        if cluster_fabric_enabled():\n"
                "            self.registry = NodeRegistry(bus)\n")
    assert _run(root, "flow").findings == []
    with open(platform, "a", encoding="utf-8") as f:
        f.write("\n\nclass OpenPlatform:\n"
                "    def __init__(self, bus):\n"
                "        self.registry = NodeRegistry(bus)\n")
    anchors = {f.anchor for f in _run(root, "flow").findings}
    assert ("RAFIKI_TPU_CLUSTER_FABRIC:unguarded-ctor:NodeRegistry@"
            "OpenPlatform.__init__") in anchors


def test_a_whole_url_send_is_a_route_caller(tmp_path):
    """The port's client sends ``f"{self._base}/path"`` URLs through
    ``_send``; the route it names has a caller, and a typo does not."""
    pkg = _pkg(tmp_path)
    (pkg / "app.py").write_text(
        "ROUTES = [(\"POST\", \"/datasets\", None)]\n")
    (pkg / "client.py").write_text(
        "class Client:\n"
        "    def upload(self, name):\n"
        "        url = f\"{self._base}/datasets?name={name}\"\n"
        "        return self._send(\"POST\", url, None, {})\n"
        "    def typo(self):\n"
        "        return self._send(\"POST\", f\"{self._base}/datasetz\","
        " None, {})\n")
    anchors = {f.anchor for f in _run(str(tmp_path), "flow").findings}
    assert "route:POST /datasets" not in anchors
    assert "route-call:POST /datasetz" in anchors


def _drift_tree(tmp_path, config_edit):
    root = fixture_tree("drift_fp", str(tmp_path / "t"))
    path = os.path.join(root, "rafiki_torch", "config.py")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    with open(path, "w", encoding="utf-8") as f:
        f.write(config_edit(text))
    return root


def test_node_config_is_read_from_the_ast(tmp_path):
    """The port's config.py imports its package relatively, which a
    load by path cannot do: the knobs come from the source, with
    ``_ENV_MAP`` and ``_PREFIX``."""
    root = _drift_tree(tmp_path, lambda t: t.replace(
        "import os\n",
        "import os\nfrom .observe.wire import packed_wire_mode\n"))
    assert _run(root, "drift").findings == []
    from rafiki_torch.analysis.checkers.drift import load_node_config

    spec = load_node_config(root)
    assert spec.fields == ["workdir", "tidy_knob"]
    assert spec.env_name("tidy_knob") == "RAFIKI_TPU_TIDY_KNOB"


def test_a_knob_exported_in_a_loop_counts_as_exported(tmp_path):
    """``for f in ("a", "b"): os.environ[self.env_name(f)] = ...`` in
    apply_env exports each named knob (RTA505); taking the knob out of
    the loop's tuple makes the finding."""
    loop = ('        for f in ("tidy_knob",):\n'
            '            os.environ[self.env_name(f)] = '
            'str(getattr(self, f))\n')
    direct = ('        os.environ[self.env_name("tidy_knob")] = '
              'str(self.tidy_knob)\n')
    root = _drift_tree(tmp_path, lambda t: t.replace(direct, loop))
    assert _run(root, "drift").findings == []
    shutil.rmtree(root)
    root = _drift_tree(tmp_path, lambda t: t.replace(
        direct, loop.replace('"tidy_knob",', '"workdir",')))
    assert [f.anchor for f in _run(root, "drift").findings
            if f.code == "RTA505"] == ["apply_env:RAFIKI_TPU_TIDY_KNOB"]


# --- Waivers -----------------------------------------------------------

GUARDED = ("import threading\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self._n = 0\n"
           "    def a(self):\n"
           "        with self._lock:\n"
           "            self._n += 1\n"
           "    def b(self):\n")


def test_waiver_with_reason_suppresses(tmp_path):
    (_pkg(tmp_path) / "mod.py").write_text(
        GUARDED + "        # rta: disable=RTA101 benign monotonic peek\n"
                  "        return self._n\n")
    report = run_suite(str(tmp_path), only=["guarded-state"])
    assert report.new == []
    waived = [f for f in report.findings if f.status == "waived"]
    assert len(waived) == 1
    assert waived[0].reason == "benign monotonic peek"


def test_waiver_without_reason_is_its_own_finding(tmp_path):
    (_pkg(tmp_path) / "mod.py").write_text(
        GUARDED + "        # rta: disable=RTA101\n"
                  "        return self._n\n")
    report = run_suite(str(tmp_path), only=["guarded-state"])
    assert sorted(f.code for f in report.new) == ["RTA001", "RTA101"]


def test_waiver_class_form_covers_all_codes(tmp_path):
    (_pkg(tmp_path) / "mod.py").write_text(
        "import threading, time\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._n = 0\n"
        "    def a(self):\n"
        "        with self._lock:\n"
        "            self._n += 1\n"
        "            # rta: disable=RTA1xx startup-only path, held <1ms\n"
        "            time.sleep(0.001)\n")
    report = run_suite(str(tmp_path), only=["guarded-state"])
    assert report.new == []
    assert any(f.status == "waived" and f.code == "RTA102"
               for f in report.findings)


def test_waiver_inside_string_literal_is_inert(tmp_path):
    (_pkg(tmp_path) / "mod.py").write_text(
        GUARDED + '        s = "# rta: disable=RTA101 just a string"\n'
                  "        return self._n, s\n")
    report = run_suite(str(tmp_path), only=["guarded-state"])
    assert sorted(f.code for f in report.new) == ["RTA101"]


def test_a_waived_aliasing_finding(tmp_path):
    """RTA402 waives like any code: the reason lands on the finding."""
    root = torch_fixture_tree("aliasing_tp", str(tmp_path / "t"))
    path = os.path.join(root, "rafiki_torch", "aliasing_tp.py")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    text = text.replace(
        "        self.graph.replay()\n        return self.static_out\n",
        "        self.graph.replay()\n"
        "        # rta: disable=RTA402 the caller reads it at once\n"
        "        return self.static_out\n")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    report = run_suite(root, only=["aliasing"])
    waived = [f for f in report.findings if f.status == "waived"]
    assert [(f.code, f.reason) for f in waived] == \
        [("RTA402", "the caller reads it at once")]


def test_thread_in_module_level_block_is_flagged(tmp_path):
    (_pkg(tmp_path) / "mod.py").write_text(
        "import threading\n"
        "if True:\n"
        "    t = threading.Thread(target=print)\n"
        "    t.start()\n")
    report = run_suite(str(tmp_path), only=["thread-lifecycle"])
    assert any(f.code == "RTA201" for f in report.new), \
        [f.render() for f in report.findings]


# --- Stale waivers -----------------------------------------------------


def test_stale_waiver_true_positive(tmp_path):
    root = fixture_tree("stale_waiver_tp", str(tmp_path / "t"))
    report = run_suite(root, only=["guarded-state"])
    stale = [f for f in report.new if f.code == "RTA003"]
    assert len(stale) == 1 and "RTA101" in stale[0].message
    msgs = [f.message for f in run_suite(root).new if f.code == "RTA003"]
    assert len(msgs) == 2 and any("RTA999" in m for m in msgs)


def test_stale_waiver_false_positive_guard(tmp_path):
    report = run_suite(fixture_tree("stale_waiver_fp", str(tmp_path / "t")),
                       only=["guarded-state"])
    assert not [f for f in report.new if f.code == "RTA003"]
    assert len([f for f in report.findings if f.status == "waived"]) == 2


def test_stale_waiver_is_unwaivable(tmp_path):
    (_pkg(tmp_path) / "mod.py").write_text(
        "def f():\n"
        "    # rta: disable=RTA003 trying to silence the detector\n"
        "    # rta: disable=RTA101 stale reason\n"
        "    return 1\n")
    report = run_suite(str(tmp_path), only=["guarded-state"])
    assert sorted(f.code for f in report.new).count("RTA003") == 2


def test_stale_waiver_skipped_in_changed_mode(tmp_path):
    root = fixture_tree("stale_waiver_tp", str(tmp_path / "t"))
    report = run_suite(root, changed={"rafiki_torch/stale_waiver_tp.py"})
    assert not [f for f in report.findings if f.code == "RTA003"]


# --- Baseline ----------------------------------------------------------


def test_baseline_freezes_and_unreviewed_fails(tmp_path):
    pkg = _pkg(tmp_path)
    (pkg / "mod.py").write_text(GUARDED + "        return self._n\n")
    (pkg / "config.py").write_text(
        "import dataclasses\n\n\n"
        "@dataclasses.dataclass\n"
        "class NodeConfig:\n"
        "    pass\n")
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "ops.md").write_text("# Ops\n")
    ident = "RTA101:rafiki_torch/mod.py:C._n@b"
    report = run_suite(str(tmp_path), only=["guarded-state"],
                       baseline={ident: "pre-existing, tracked elsewhere"})
    assert report.new == []
    assert any(f.status == "baselined" for f in report.findings)
    report = run_suite(str(tmp_path), only=["guarded-state"],
                       baseline={ident: "UNREVIEWED: fill me in"})
    assert any(f.code == "RTA002" for f in report.new)
    stale_bl = {ident: "ok reason",
                "RTA101:rafiki_torch/gone.py:X._y@z": "fixed long ago"}
    report = run_suite(str(tmp_path), baseline=stale_bl)
    assert report.new == []
    assert report.stale_baseline == ["RTA101:rafiki_torch/gone.py:X._y@z"]
    report = run_suite(str(tmp_path), only=["guarded-state"],
                       baseline=stale_bl)
    assert report.new == [] and report.stale_baseline == []


def test_update_baseline_round_trip(tmp_path):
    findings = [Finding(code="RTA101", path="rafiki_torch/m.py", line=3,
                        message="msg", anchor="C._n@b")]
    path = str(tmp_path / "baseline.json")
    save_baseline(path, findings, prior={})
    ident = "RTA101:rafiki_torch/m.py:C._n@b"
    loaded = load_baseline(path)
    assert ident in loaded and loaded[ident].startswith("UNREVIEWED")
    save_baseline(path, findings, prior={ident: "benign: snapshot read"})
    assert load_baseline(path)[ident] == "benign: snapshot read"
    save_baseline(path, findings + [
        Finding(code="RTA001", path="rafiki_torch/m.py", line=9,
                message="waiver without a reason", anchor="waiver:9")],
        prior={ident: "benign: snapshot read"})
    assert list(load_baseline(path)) == [ident]


# --- --changed ---------------------------------------------------------


def test_changed_mode_scopes_per_file_checkers(tmp_path):
    pkg = _pkg(tmp_path)
    bad = GUARDED + "        return self._n\n"
    (pkg / "one.py").write_text(bad)
    (pkg / "two.py").write_text(bad)
    assert len(run_suite(str(tmp_path), only=["guarded-state"]).new) == 2
    scoped = run_suite(str(tmp_path), changed={"rafiki_torch/one.py"},
                       only=["guarded-state"])
    assert [f.path for f in scoped.new] == ["rafiki_torch/one.py"]
    assert run_suite(str(tmp_path), changed=set()).findings == []


def test_only_the_port_s_package_is_scanned(tmp_path):
    """One package root: a reference-named package beside it is not
    analysed."""
    (_pkg(tmp_path) / "mod.py").write_text("X = 1\n")
    ref = tmp_path / "rafiki_tpu"
    ref.mkdir()
    (ref / "mod.py").write_text(GUARDED + "        return self._n\n")
    report = run_suite(str(tmp_path), only=["guarded-state"])
    assert report.n_files == 1 and report.findings == []

