"""The port's serving front held against the reference's, decision by
decision, on the same inputs: the shard plans, the quarantine and
straggler deadlines, the adaptive fill window and ``Retry-After``, the
metrics exposition, ``ServingStats``' snapshot, ``NodeConfig``'s serving
fields, the trace envelope and ``collect_trace``. Every comparison is
exact."""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import types

import pytest

from rafiki_torch import config as pconfig
from rafiki_torch.bus import MemoryBus as PortBus
from rafiki_torch.observe import metrics as pmetrics
from rafiki_torch.observe import trace as ptrace
from rafiki_torch.observe.serving import ServingStats as PortStats
from rafiki_torch.predictor import batcher as pbatcher
from rafiki_torch.predictor import predictor as ppred
from rafiki_tpu import config as rconfig
from rafiki_tpu.bus import MemoryBus as RefBus
from rafiki_tpu.observe import metrics as rmetrics
from rafiki_tpu.observe import trace as rtrace
from rafiki_tpu.observe.serving import ServingStats as RefStats
from rafiki_tpu.predictor import batcher as rbatcher
from rafiki_tpu.predictor import predictor as rpred

PORT = types.SimpleNamespace(pred=ppred, batcher=pbatcher, bus=PortBus,
                             metrics=pmetrics, trace=ptrace,
                             stats=PortStats, config=pconfig)
REF = types.SimpleNamespace(pred=rpred, batcher=rbatcher, bus=RefBus,
                            metrics=rmetrics, trace=rtrace,
                            stats=RefStats, config=rconfig)
BOTH = (PORT, REF)


@pytest.fixture()
def predictors():
    """A port and a reference ``Predictor`` with the same timeouts."""
    made = [m.pred.Predictor("job", m.bus(), gather_timeout=2.0,
                             worker_wait_timeout=0.1, shard_replicas=True)
            for m in BOTH]
    yield made
    for p in made:
        p.close()


def _plan(p, mod, n, groups, rr, lat, shard=True):
    p.shard_replicas = shard
    return [(s.worker, s.bin, s.start, s.count)
            for s in p._plan_for(n, groups, rr, lat)]


GROUPS = [
    {"tA": ["w1"]},
    {"tA": ["w1", "w2"]},
    {"tA": ["w1", "w2", "w3"], "tB": ["w4"]},
    {"tA": ["w1", "w2", "w3", "w4", "w5"], "tB": ["w6", "w7"]},
]
LATS = [{}, {"w1": 0.01}, {"w1": 0.01, "w2": 0.04, "w3": 0.02},
        {"w1": 2.0, "w2": 0.001, "w4": 0.5, "w6": 0.0, "w7": 0.3},
        {"w2": 30.0, "w3": 60.0, "w5": 1e-9}]


@pytest.mark.parametrize("shard", [True, False])
def test_shard_plans_equal_the_reference(predictors, shard):
    port, ref = predictors
    n_cases = 0
    for groups in GROUPS:
        for lat in LATS:
            for n in (1, 2, 3, 7, 10, 64, 1000):
                for rr in (0, 1, 2, 5):
                    assert _plan(port, ppred, n, groups, rr, lat, shard) \
                        == _plan(ref, rpred, n, groups, rr, lat, shard), \
                        (groups, lat, n, rr)
                    n_cases += 1
    assert n_cases == len(GROUPS) * len(LATS) * 7 * 4


def test_quarantine_sequence_equals_the_reference(predictors):
    seqs = []
    for p in predictors:
        seq = []
        for strike in range(8):
            p._penalize("w")
            seq.append((p._quarantine_s("w"), p._lat["w"],
                        p._strikes["w"]))
        p._note_latency("w", 0.01)
        seq.append(("reset", p._strikes.get("w"), p._lat["w"]))
        p._penalize("w")
        seq.append((p._quarantine_s("w"), p._strikes["w"]))
        p._penalized.pop("w")
        p._penalize("w")
        seq.append((p._quarantine_s("w"), p._strikes["w"]))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[0][0][0] == 2.0 and seqs[0][7][0] == 2.0 * 16


@pytest.mark.parametrize("lats", [
    {}, {"w1": 0.010}, {"w1": 0.010, "w2": 0.020},
    {"w1": 0.001, "w2": 0.002}, {"w1": 0.010, "w2": 100.0},
    {"w1": 0.3, "w2": 0.2, "w3": 0.1}])
def test_partial_wait_equals_the_reference(predictors, lats):
    waits = []
    for p, mod in zip(predictors, (ppred, rpred)):
        for w, v in lats.items():
            p._note_latency(w, v)
            p._note_latency(w, v / 2)
        plan = [mod._Shard("w1", "tA", 0, 4), mod._Shard("w2", "tA", 4, 4)]
        waits.append(p._partial_wait(plan))
    assert waits[0] == waits[1]


def _fill_windows(mod, arrivals, **kw):
    """The adaptive window after each of ``arrivals`` (monotonic
    seconds), the batcher's clock patched; its threads are not
    started, so each submit is admitted and times out at once."""
    clock = {"t": 0.0}
    fake = types.SimpleNamespace(monotonic=lambda: clock["t"],
                                 time=lambda: clock["t"])

    class _Idle:
        def predict_submit(self, *a, **k):  # pragma: no cover
            raise AssertionError("no thread dispatches")

    mb = mod.MicroBatcher(_Idle(), queue_cap=1 << 20, **kw)
    mb._started = True
    real = mod.time
    mod.time = fake
    try:
        out = []
        for t in arrivals:
            clock["t"] = t
            with pytest.raises(TimeoutError):
                mb.submit([1], timeout=0)
            out.append(mb.current_fill_window())
        return out
    finally:
        mod.time = real
        mb.stats.close()


@pytest.mark.parametrize("kw", [
    {}, {"fill_window": 0.05}, {"fill_window_min": 0.001,
                                "fill_window_max": 0.03},
    {"fill_window_min": 0.02, "fill_window_max": 0.02}])
def test_fill_window_equals_the_reference(kw):
    trickle = [0.1 * i for i in range(8)]
    burst = [1.0 + 0.0005 * i for i in range(40)]
    idle = [100.0 + 0.001 * i for i in range(10)]
    arrivals = trickle + burst + idle
    port = _fill_windows(pbatcher, arrivals, **kw)
    ref = _fill_windows(rbatcher, arrivals, **kw)
    assert port == ref


@pytest.mark.parametrize("cap,max_batch,fw", [
    (4096, 1024, 0.005), (64, 16, 0.005), (6, 4, 0.01), (100, 1, 0.2),
    (10, 1000, 0.0), (1, 1, 3.3)])
def test_retry_after_and_backpressure_equal_the_reference(cap, max_batch,
                                                          fw):
    got = []
    for m in BOTH:
        mb = m.batcher.MicroBatcher(object(), fill_window=fw,
                                    max_batch=max_batch, queue_cap=cap)
        ra = mb._retry_after()
        e = m.batcher.Backpressure(ra, depth=cap + 1, cap=cap)
        f = m.batcher.Backpressure(ra, 3, 2, reason="client_share")
        got.append((ra, str(e), e.retry_after, e.depth, e.cap, e.reason,
                    str(f), f.reason))
        mb.stats.close()
    assert got[0] == got[1]


def _metric_ops(reg):
    c = reg.counter("rafiki_tpu_serving_requests_total", "Requests")
    c.inc(service="a")
    c.inc(2.5, service="b")
    c.inc(service='q"uote\\back\nline')
    g = reg.gauge("rafiki_tpu_serving_queue_depth_queries", "Depth")
    g.set(7, service="a")
    g.inc(service="a")
    g.dec(3, service="b")
    h = reg.histogram("rafiki_tpu_serving_stage_seconds", "Stages")
    for i, v in enumerate((0.0001, 0.0007, 0.003, 0.049, 0.2, 3.0, 50.0,
                           0.0005, 1e-9)):
        h.observe(v, service="a", stage=("fill", "gather")[i % 2])
    h2 = reg.histogram("rafiki_tpu_custom_seconds", buckets=(0.5, 1.5))
    h2.observe(1.0)
    reg.counter("rafiki_tpu_empty_total")
    c.remove(service="b")
    return reg.expose(), h.percentile(0.5, service="a", stage="fill"), \
        h.cumulative_buckets(service="a", stage="gather")


def test_exposition_equals_the_reference():
    assert _metric_ops(pmetrics.MetricsRegistry()) == \
        _metric_ops(rmetrics.MetricsRegistry())


def test_parse_exposition_and_percentiles_equal_the_reference():
    text, _, _ = _metric_ops(rmetrics.MetricsRegistry())
    text += ('rafiki_tpu_x_bucket{le="0.1",s="a#b"} 3 # {trace_id="ab"} '
             '0.05 1.5\nrafiki_tpu_x_bucket{le="+Inf",s="a#b"} 4\n'
             'rafiki_tpu_y +Inf\n')
    parsed = [m.metrics.parse_exposition(text) for m in BOTH]
    assert parsed[0] == parsed[1]
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        for cum in ([], [(0.1, 0), (float("inf"), 0)],
                    [(0.001, 2), (0.01, 2), (0.1, 9), (float("inf"), 10)],
                    [(1.0, 5), (float("inf"), 20)]):
            assert pmetrics.bucket_percentile(cum, q) == \
                rmetrics.bucket_percentile(cum, q), (cum, q)
    samples = parsed[0]["rafiki_tpu_serving_stage_seconds_bucket"]
    for match in ({}, {"stage": "fill"}, {"stage": "gather"},
                  {"stage": "none"}):
        assert pmetrics.histogram_percentiles_ms(samples, **match) == \
            rmetrics.histogram_percentiles_ms(samples, **match)


def test_label_context_equals_the_reference():
    got = []
    for m in BOTH:
        with m.metrics.label_context(trial="t1"):
            with m.metrics.label_context(worker=3):
                inner = m.metrics.bound_labels()
            outer = m.metrics.bound_labels()
        got.append((inner, outer, m.metrics.bound_labels()))
    assert got[0] == got[1]


def test_serving_stats_snapshot_equals_the_reference():
    snaps = []
    for m in BOTH:
        s = m.stats(service="same")
        try:
            s.admitted(3)
            s.admitted(5)
            s.backpressured()
            s.backpressured(reason="client_share")
            s.set_queue_depth(8)
            s.set_queue_depth(2)
            s.dispatched(2, 8, 0.004, 0.0002, inflight=2,
                         fill_window=0.003)
            s.dispatched(1, 1, 0.0, 0.0001, inflight=1)
            s.gathered(0.03, inflight=0)
            snaps.append(s.snapshot())
        finally:
            s.close()
    assert snaps[0] == snaps[1]
    assert snaps[0]["coalescing_factor"] == 1.5


# The serving part of NodeConfig (the node's own fields are held
# against the reference in test_torch_node_config.py).
SERVING_FIELDS = [f.name for f in
                  pconfig.NodeConfig.__dataclass_fields__.values()
                  if f.name.startswith(("serving_", "pipeline_",
                                        "workload_"))]


def test_nodeconfig_serving_defaults_equal_the_reference():
    port, ref = pconfig.NodeConfig(), rconfig.NodeConfig()
    assert len(SERVING_FIELDS) == 22
    for f in SERVING_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
        assert pconfig.NodeConfig.env_name(f) == \
            rconfig.NodeConfig.env_name(f)
    for raw in ("", "0", "1", "off", "On", " no ", "TRUE", "x"):
        assert pconfig._parse_bool(raw) == rconfig._parse_bool(raw)


@pytest.mark.parametrize("kw", [
    {"serving_fill_window": -1.0}, {"serving_max_batch": 0},
    {"serving_max_inflight": 0}, {"serving_queue_cap": 0},
    {"serving_fill_window_min": 0.01},
    {"serving_fill_window_min": 0.02, "serving_fill_window_max": 0.01},
    {"serving_fill_window_min": -0.1, "serving_fill_window_max": 0.1},
    {"serving_client_share": 1.5}, {"serving_client_share": -0.1},
    {"serving_quant": "int4"}, {"serving_stacked": "maybe"},
    {"serving_quant": "INT8", "serving_stacked": "Off"},
    {"serving_fill_window": 0.0, "serving_fill_window_min": 0.0},
    {"serving_cache_bytes": -1}, {"serving_cache_ttl_s": 0.0},
    {"serving_cache_admit_after": 0}, {"serving_tier_threshold": -0.1},
    {"pipeline_sync_min": -1.0}, {"workload_max_mb": 0.0},
    {"workload_retain_segments": 0},
    {"serving_cache_bytes": 1 << 20, "serving_tier_threshold": 0.2,
     "serving_attribution": True, "workload_record": True}])
def test_nodeconfig_validation_equals_the_reference(kw):
    outcomes = []
    for m in BOTH:
        try:
            m.config.NodeConfig(**kw).validate()
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("env", [
    {"RAFIKI_TPU_SERVING_MICROBATCH": "0",
     "RAFIKI_TPU_SERVING_FILL_WINDOW_MAX": "0.03",
     "RAFIKI_TPU_SERVING_MAX_BATCH": "64",
     "RAFIKI_TPU_SERVING_CLIENT_HEADER": "X-Client",
     "RAFIKI_TPU_SERVING_QUANT": "int8",
     "RAFIKI_TPU_SERVING_GENERATE": "yes"},
    {"RAFIKI_TPU_SERVING_MICROBATCH": "auto"},
    {"RAFIKI_TPU_SERVING_MAX_BATCH": "abc"},
    {"RAFIKI_TPU_SERVING_QUEUE_CAP": "0"},
    {"RAFIKI_TPU_SERVING_SHARD_REPLICAS": "off",
     "RAFIKI_TPU_SERVING_STACKED": "off",
     "RAFIKI_TPU_SERVING_CLIENT_SHARE": "0.5"},
    {"RAFIKI_TPU_SERVING_CACHE_BYTES": "4096",
     "RAFIKI_TPU_SERVING_CACHE_TTL_S": "5",
     "RAFIKI_TPU_SERVING_CACHE_ADMIT_AFTER": "1",
     "RAFIKI_TPU_SERVING_TIER_THRESHOLD": "0.25",
     "RAFIKI_TPU_PIPELINE_SYNC_MIN": "0.5",
     "RAFIKI_TPU_SERVING_ATTRIBUTION": "1",
     "RAFIKI_TPU_WORKLOAD_RECORD": "yes",
     "RAFIKI_TPU_WORKLOAD_MAX_MB": "2",
     "RAFIKI_TPU_WORKLOAD_RETAIN_SEGMENTS": "3"},
    {"RAFIKI_TPU_SERVING_CACHE_BYTES": "lots"},
    {"RAFIKI_TPU_SERVING_ATTRIBUTION": "auto"}])
def test_nodeconfig_from_env_and_apply_env_equal_the_reference(env):
    names = [pconfig.NodeConfig.env_name(f) for f in SERVING_FIELDS]
    outcomes = []
    saved = dict(os.environ)
    try:
        for m in BOTH:
            for k in names:
                os.environ.pop(k, None)
            try:
                cfg = m.config.NodeConfig.from_env(env)
            except ValueError as e:
                outcomes.append(str(e))
                continue
            cfg.apply_env()
            outcomes.append(({f: getattr(cfg, f) for f in SERVING_FIELDS},
                             {k: os.environ.get(k) for k in names}))
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("header", [
    "0123456789abcdef0123456789abcdef-0123456789abcdef",
    "0123456789ABCDEF0123456789ABCDEF-0123456789ABCDEF",
    "  0123456789abcdef0123456789abcdef-0123456789abcdef  ",
    "0f8fad5b-d9cb-469f-a165-70867728950e", "opaque-upstream-id",
    "0123456789abcdef0123456789abcdef-0123", "abc"])
def test_start_trace_header_parsing_equals_the_reference(header):
    got = []
    for m in BOTH:
        ctx = m.trace.start_trace(header)
        got.append((ctx.trace_id, ctx.parent_id, len(ctx.span_id)))
    assert got[0] == got[1]


@pytest.mark.parametrize("header", [None, "", "   "])
def test_start_trace_mints_or_samples_as_the_reference(header,
                                                       monkeypatch):
    for rate, minted in (("1", True), ("0", False), ("nonsense", True)):
        monkeypatch.setenv("RAFIKI_TPU_TRACE_SAMPLE", rate)
        got = [m.trace.start_trace(header) for m in BOTH]
        assert [c is not None for c in got] == [minted, minted]
        if minted:
            assert [len(c.trace_id) for c in got] == [32, 32]
            assert [c.parent_id for c in got] == [None, None]


def test_inject_and_extract_equal_the_reference():
    ids = [("ab" * 16, "cd" * 8), ("ef" * 16, "01" * 8)]
    for m, other in ((PORT, REF), (REF, PORT)):
        ctxs = [m.trace.TraceContext(t, span_id=s) for t, s in ids]
        env = m.trace.inject(ctxs + [None])
        assert env == other.trace.inject(
            [other.trace.TraceContext(t, span_id=s) for t, s in ids])
        assert m.trace.inject([None]) is None
        many = [m.trace.TraceContext("%032x" % i) for i in range(40)]
        assert len(m.trace.inject(many)["ids"]) == 32
        frames = [{"queries": [1], "_trace": env},
                  {"queries": [2], "_trace": dict(env)},
                  {"queries": [3]}, {"_trace": "junk"},
                  {"_trace": {"ids": [[1, 2, 3]]}}, "not a dict"]
        got = [[(c.trace_id, c.span_id) for c in
                o.trace.extract_frames(json.loads(json.dumps(
                    frames[:5])) + frames[5:])]
               for o in (PORT, REF)]
        assert got[0] == got[1] == ids


def _record(mod, log_dir, tids, monkeypatch, roll_mb=None):
    if roll_mb is not None:
        monkeypatch.setenv("RAFIKI_TPU_TRACE_MAX_MB", str(roll_mb))
    mod.configure(str(log_dir))
    try:
        for i in range(60):
            tid = tids[i % len(tids)]
            ctx = mod.TraceContext(tid, parent_id="ff" * 8)
            mod.record_event(f"span {i}", f"svc{i % 3}", [ctx],
                             1000.0 + 0.001 * (i * 7 % 13), 0.002,
                             attrs={"i": i, "n": [1, 2]} if i % 2 else None,
                             child=bool(i % 3))
        with mod.span("worker.predict", service="w",
                      ctxs=[mod.TraceContext(tids[0])]):
            pass
    finally:
        mod.configure(None)
    with open(mod.span_log_path(str(log_dir)), "a") as f:
        f.write("not json\n" + '{"trace_id":"%s", broken\n' % tids[0])


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("roll_mb", [None, 0.002])
def test_collect_trace_equals_the_reference(writer, roll_mb, tmp_path,
                                            monkeypatch):
    tids = ["a1" * 16, "b2" * 16, "c3" * 16]
    mod = ptrace if writer == "port" else rtrace
    _record(mod, tmp_path, tids, monkeypatch, roll_mb)
    if roll_mb is not None:
        assert os.path.exists(mod.span_log_path(str(tmp_path)) + ".1")
    for tid in tids + ["d4" * 16]:
        port = ptrace.collect_trace(str(tmp_path), tid)
        ref = rtrace.collect_trace(str(tmp_path), tid)
        assert {k: port[k] for k in ("trace_id", "n_spans", "spans")} == \
            {k: ref[k] for k in ("trace_id", "n_spans", "spans")}
    if roll_mb is None:
        assert ptrace.collect_trace(str(tmp_path), tids[0])["n_spans"] == 21
