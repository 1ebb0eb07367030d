"""The port's profiling and trial-phase plane held against the
reference's, on the CPU.

- ``MfuMeter``: the same step cost, device count, peak and clock give
  the same achieved FLOP/s and MFU (exact: the same arithmetic).
- ``device_peak_flops``: the ``RAFIKI_TPU_PEAK_FLOPS`` override wins in
  both; the card's table holds the H100 data sheet's bf16 peak.
- ``flops_of_step`` against the models' analytic counts:
  ``TorchFeedForward``'s train step counts exactly ``6·b·macs`` less
  the first layer's input gradient, which no step computes
  (``2·b·fan_in·units``); the LM's counts within 10% of
  ``_flops_per_step`` with ``remat`` "none" (the plain attention's
  backward recomputes QKᵀ and dO·Vᵀ in both the dq and the dk+dv pass
  and visits the causal diagonal blocks whole; at this shape that adds
  8.0%).
- Trial traces: ``trace_session`` writes a trace file with its scope in
  the metadata, and a busy profiler skips the trace, counted, while the
  trial completes.
- ``phase_totals``: one trial of the feed-forward model through each
  package's ``TrialRunner`` counts the same phases (counts exact; the
  seconds are the host's and differ). The trial's ``trial.persist``
  span and the advisor's ``advisor.propose`` span carry the
  reference's names and attribute keys.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import glob
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rafiki_tpu.observe import phases as ref_phases
from rafiki_tpu.observe import profiling as ref_profiling
from rafiki_tpu.observe import trace as ref_trace
from rafiki_torch.models import TorchFeedForward
from rafiki_torch.models.lm import TorchTransformerLM
from rafiki_torch.observe import metrics, phases, profiling
from rafiki_torch.observe import trace as port_trace

FF_KNOBS = {"hidden_layer_count": 2, "hidden_layer_units": 64,
            "learning_rate": 1e-3, "batch_size": 32, "max_epochs": 5}
LM_KNOBS = {"d_model": 256, "n_layers": 2, "seq_len": 256,
            "batch_size": 2, "vocab_size": 512, "learning_rate": 1e-3,
            "train_steps": 20, "quick_train": False}
LM_TOL = 0.10


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def test_mfu_meter_arithmetic_agrees(monkeypatch):
    clock = _Clock(100.0)
    monkeypatch.setattr(ref_profiling.time, "monotonic", clock)
    monkeypatch.setattr(profiling.time, "monotonic", clock)
    meters = {"ref": ref_profiling.MfuMeter(3.0e12, n_devices=4,
                                            peak_flops_per_device=1e14),
              "port": profiling.MfuMeter(3.0e12, n_devices=4,
                                         peak_flops_per_device=1e14)}
    out = {}
    for kind, m in meters.items():
        seen = [m.achieved_flops, m.mfu, m.peak]
        clock.t = 100.0
        m.reset()
        m.tick(10)
        m.tick()
        clock.t = 102.5
        seen += [m.n_steps, m.elapsed, m.achieved_flops, m.mfu]
        m.flops_per_step = None
        seen += [m.achieved_flops, m.mfu]
        out[kind] = seen
    assert out["port"] == out["ref"]
    assert out["port"][5] == 3.0e12 * 11 / 2.5
    assert out["port"][6] == pytest.approx(3.0e12 * 11 / 2.5 / 4e14,
                                           rel=1e-15)
    unknown = profiling.MfuMeter(1e9, peak_flops_per_device=0)
    unknown.tick(5)
    assert unknown.achieved_flops is not None and unknown.mfu is None


def test_device_peak_flops_honours_the_override(monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_PEAK_FLOPS", "1.25e14")
    assert profiling.device_peak_flops("cpu") == \
        ref_profiling.device_peak_flops() == 1.25e14
    m = profiling.MfuMeter(1e12, n_devices=2, device="cpu")
    assert m.peak == 2.5e14
    monkeypatch.delenv("RAFIKI_TPU_PEAK_FLOPS")
    assert profiling.device_peak_flops("cpu") > 0  # the calibrated one
    assert profiling.H100_PEAK_BF16_FLOPS == 989e12
    assert profiling._PEAK_FLOPS_BY_NAME["H100 80GB HBM3"] == 989e12


def test_step_flops_match_the_feedforward_count():
    m = TorchFeedForward(device="cpu",
                         **TorchFeedForward.validate_knobs(FF_KNOBS))
    shape, b = (12, 12, 1), 32
    net = m._new_net(4, shape)
    x = torch.rand(b, *shape)
    y = torch.zeros(b, dtype=torch.int64)

    def step():
        F.cross_entropy(m._logits(net, x).float(), y).backward()

    first = next(mod for mod in net.modules()
                 if isinstance(mod, torch.nn.Linear))
    fan_in = int(np.prod(shape))
    assert first.in_features == fan_in
    analytic = 6 * b * m._macs(net, shape)
    assert profiling.flops_of_step(step) == \
        analytic - 2 * b * fan_in * first.out_features


def test_step_flops_match_the_lm_count():
    lm = TorchTransformerLM(device="cpu", **dict(
        TorchTransformerLM.validate_knobs(LM_KNOBS), remat="none"))
    lm._install(lm._init_params())
    win = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 257)))

    def step():
        loss, _ = lm._loss(win)
        loss.backward()

    counted = profiling.flops_of_step(step)
    analytic = lm._flops_per_step(2)
    assert abs(counted / analytic - 1) <= LM_TOL, counted / analytic
    assert counted > analytic  # the recomputed products, never fewer


def _traces(path):
    return glob.glob(os.path.join(path, "*.pt.trace.json"))


def _count(name, event):
    c = metrics.registry().find(name)
    return 0.0 if c is None else c.value(event=event)


def test_trace_session_writes_and_a_busy_profiler_skips(tmp_path):
    busy0 = _count("rafiki_tpu_trial_traces_total", "busy")
    with profiling.trace_session(str(tmp_path / "a")):
        torch.ones(64, 64) @ torch.ones(64, 64)
        with profiling.trace_session(str(tmp_path / "b")):
            pass  # the profiler is taken: skipped, counted
    assert _count("rafiki_tpu_trial_traces_total", "busy") == busy0 + 1
    assert not os.path.exists(tmp_path / "b")
    (path,) = _traces(str(tmp_path / "a"))
    with open(path) as f:
        body = json.load(f)
    assert body["rafiki_tpu_trace"]["scope"] == profiling.TRACE_SCOPE
    assert any(e.get("name") == "aten::mm"
               for e in body["traceEvents"])
    with profiling.trace_session(None):
        pass  # tracing off: nothing at all


def test_on_demand_sessions_count_as_the_reference(tmp_path):
    """start, busy and stop counts, and the clamp, on both packages'
    locks (the reference's busy path only: its start is jax's)."""
    c = "rafiki_tpu_profile_sessions_total"
    with ref_profiling._trace_lock:
        assert ref_profiling.start_device_profile(str(tmp_path / "r"),
                                                  1.0) is None
    before = {e: _count(c, e) for e in ("start", "busy", "stop")}
    t0 = time.monotonic()
    s = profiling.start_device_profile(str(tmp_path / "p"), 1e6)
    assert s is not None
    assert 60.0 <= s.deadline_mono - t0 <= 60.0 + (time.monotonic() - t0)
    assert profiling.start_device_profile(str(tmp_path / "q"), 1) is None
    assert not s.expired(s.deadline_mono - 1)
    assert s.expired(s.deadline_mono)
    s.stop()
    s.stop()  # once only
    after = {e: _count(c, e) for e in ("start", "busy", "stop")}
    assert {e: after[e] - before[e] for e in after} == \
        {"start": 1, "busy": 1, "stop": 1}
    assert len(_traces(str(tmp_path / "p"))) == 1
    assert not profiling.PROFILER_LOCK.locked()


def _ref_trial(tmp_path, data):
    from rafiki_tpu.advisor.random_advisor import RandomAdvisor
    from rafiki_tpu.models.feedforward import JaxFeedForward
    from rafiki_tpu.store import MetaStore, ParamStore
    from rafiki_tpu.worker.runner import TrialRunner

    meta = MetaStore(str(tmp_path / "ref.db"))
    params = ParamStore(str(tmp_path / "ref_params"))
    sub = _sub(meta, "rafiki_tpu.models.feedforward:JaxFeedForward")
    adv = RandomAdvisor(JaxFeedForward.get_knob_config(), seed=0)
    runner = TrialRunner(JaxFeedForward, adv, data[0], data[1], meta,
                         params, sub["id"], budget={
                             "MODEL_TRIAL_COUNT": 1})
    row = runner.run_one()
    runner.drain_persist()
    return row, meta, params


def _port_trial(tmp_path, data, model_class=TorchFeedForward):
    from rafiki_torch.advisor import RandomAdvisor
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.worker import TrialRunner

    meta = MetaStore(str(tmp_path / "port.db"))
    params = ParamStore(str(tmp_path / "port_params"))
    sub = _sub(meta, "rafiki_torch.models:TorchFeedForward")
    adv = RandomAdvisor(TorchFeedForward.get_knob_config(), seed=0)
    runner = TrialRunner(model_class, adv, data[0], data[1], meta, params,
                         sub["id"], budget={"MODEL_TRIAL_COUNT": 1},
                         device="cpu")
    return runner.run_one(), meta, params


def _sub(meta, cls):
    user = meta.create_user("dev@x.c", "x", "MODEL_DEVELOPER")
    model = meta.create_model(user["id"], "ff", "IMAGE_CLASSIFICATION",
                              cls, {})
    job = meta.create_train_job(user["id"], "app", "IMAGE_CLASSIFICATION",
                                {"MODEL_TRIAL_COUNT": 1}, "t", "v",
                                "RUNNING")
    return meta.create_sub_train_job(job["id"], model["id"], "RUNNING")


def _diff(after, before):
    return {p: after[p]["count"] - before[p]["count"] for p in after}


def test_phase_totals_and_trial_spans_agree(tmp_path, synth_image_data):
    for tr, kind in ((ref_trace, "ref"), (port_trace, "port")):
        os.makedirs(tmp_path / kind / "logs")
        tr.configure(str(tmp_path / kind / "logs"))
    try:
        b_ref, b_port = ref_phases.phase_totals(), phases.phase_totals()
        ref_row, rmeta, rparams = _ref_trial(tmp_path, synth_image_data)
        port_row, pmeta, pparams = _port_trial(tmp_path, synth_image_data)
        d_ref = _diff(ref_phases.phase_totals(), b_ref)
        d_port = _diff(phases.phase_totals(), b_port)
        assert ref_row["status"] == port_row["status"] == "COMPLETED"
        assert d_port == d_ref == {"propose": 1, "load": 2, "stage": 2,
                                   "train": 1, "eval": 1, "persist": 1}
        spans = {}
        for kind, tr, row in (("ref", ref_trace, ref_row),
                              ("port", port_trace, port_row)):
            got = tr.collect_trace(str(tmp_path / kind / "logs"),
                                   row["id"])["spans"]
            spans[kind] = [(s["name"], sorted(s["attrs"])) for s in got]
        assert spans["port"] == spans["ref"]
        assert spans["port"][0][0] == "trial.persist"
    finally:
        ref_trace.configure(None)
        port_trace.configure(None)
    for store in (rmeta, rparams, pmeta, pparams):
        store.close()


class _Labelled(TorchFeedForward):
    """Notes the train series of its own trial label as train ends."""
    seen = []

    def train(self, *a, **kw):
        super().train(*a, **kw)
        h = metrics.registry().find("rafiki_tpu_train_step_seconds")
        self.seen.append((dict(metrics.bound_labels()),
                          h.count(**metrics.bound_labels())))


def test_a_trial_is_labelled_and_traced_or_skipped(tmp_path, monkeypatch,
                                                   synth_image_data):
    """The trial label rides the train loop's step histogram and goes
    when the trial ends; with ``RAFIKI_TPU_TRACE_DIR`` set a trial is
    traced into its own directory, and one that meets a busy profiler
    completes untraced, counted."""
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path / "traces"))
    busy0 = _count("rafiki_tpu_trial_traces_total", "busy")
    start0 = _count("rafiki_tpu_trial_traces_total", "start")
    rows = []
    for i, held in enumerate((False, True)):
        if held:
            assert profiling.PROFILER_LOCK.acquire(timeout=5)
        try:
            rows.append(_port_trial(tmp_path / str(i), synth_image_data,
                                    _Labelled)[0])
        finally:
            if held:
                profiling.PROFILER_LOCK.release()
    assert [r["status"] for r in rows] == ["COMPLETED"] * 2
    assert _count("rafiki_tpu_trial_traces_total", "busy") == busy0 + 1
    assert _count("rafiki_tpu_trial_traces_total", "start") == start0 + 1
    assert len(_traces(str(tmp_path / "traces" / rows[0]["id"]))) == 1
    assert not os.path.exists(tmp_path / "traces" / rows[1]["id"])
    for (labels, n), row in zip(_Labelled.seen, rows):
        assert labels == {"trial": row["id"][:12]} and n > 0
        h = metrics.registry().find("rafiki_tpu_train_step_seconds")
        assert h.count(trial=row["id"][:12]) == 0  # removed at the end


def test_advisor_spans_match_the_reference(tmp_path):
    from rafiki_tpu.advisor.random_advisor import RandomAdvisor as RefAdv
    from rafiki_tpu.advisor.worker import AdvisorWorker as RefWorker
    from rafiki_tpu.advisor.worker import RemoteAdvisor as RefRemote
    from rafiki_tpu.bus import MemoryBus as RefBus
    from rafiki_tpu.models.feedforward import JaxFeedForward
    from rafiki_torch.advisor import RandomAdvisor
    from rafiki_torch.advisor.worker import AdvisorWorker, RemoteAdvisor
    from rafiki_torch.bus import MemoryBus

    kinds = {"ref": (ref_trace, RefAdv, RefWorker, RefRemote, RefBus,
                     JaxFeedForward),
             "port": (port_trace, RandomAdvisor, AdvisorWorker,
                      RemoteAdvisor, MemoryBus, TorchFeedForward)}
    names = {}
    for kind, (tr, adv, worker, remote, bus_cls, model) in kinds.items():
        log_dir = str(tmp_path / kind)
        os.makedirs(log_dir)
        tr.configure(log_dir)
        bus = bus_cls()
        w = worker(adv(model.get_knob_config(), seed=0), bus, "sub1")
        w.start()
        try:
            ctx = tr.TraceContext(tr.new_trace_id())
            with tr.use(ctx):
                proposal = remote(bus, "sub1").propose()
            assert proposal is not None
            untraced = remote(bus, "sub1").propose()  # no span
            assert untraced is not None
        finally:
            w.stop()
            tr.configure(None)
        got = tr.collect_trace(log_dir, ctx.trace_id)
        names[kind] = [(s["name"], s["parent_id"] == ctx.span_id)
                       for s in got["spans"]]
    assert names["port"] == names["ref"] == [("advisor.propose", True)]
