"""The port's SLO plane held against the reference's (after
``tests/test_slo.py``): the rules grammar and files, the window ring,
the alert machine and ``Instance`` on one seeded event sequence, and
``SloEngine.sweep`` over one sequence of scraped expositions, with the
clock the two engines read stubbed to the same values. Then the alert
log's roll, the webhook sender, and ``close`` dropping the series.

Each package counts in its own process-global registry; every series
read here belongs to an objective named in this file, and each engine
is closed (its families dropped) before the next is built.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from rafiki_torch.admin import slo_engine as port_engine
from rafiki_torch.observe import metrics as port_metrics
from rafiki_torch.observe import slo as port_slo
from rafiki_tpu.admin import slo_engine as ref_engine
from rafiki_tpu.observe import metrics as ref_metrics
from rafiki_tpu.observe import slo as ref_slo

PKGS = {"port": (port_slo, port_engine, port_metrics),
        "ref": (ref_slo, ref_engine, ref_metrics)}
SLO_FAMILIES = ("rafiki_tpu_slo_budget_remaining_ratio",
                "rafiki_tpu_slo_burn_rate", "rafiki_tpu_slo_alerts_total",
                "rafiki_tpu_slo_worker_scrape_ratio")


def _parsed(slo, text):
    try:
        return [dataclasses.asdict(o) for o in slo.parse_rules(text)]
    except ValueError as e:
        return f"ValueError: {e}"


RULES = [
    "",
    "p99:p99<50ms,window=60,fast=5,slow=20,burn=2,for=2,resolve=4"
    ";avail:ratio>=0.995,window=120",
    "x:p95<10ms,window=100",
    "y:p99.9<5ms",
    "b:p90<25ms,scope=bin,job=abc,window=30,fast=3,slow=10",
    "t:p99<100ms,scope=tenant,route=/predict,metric=my_seconds",
    "r:ratio>=0.9,window=600,burn=14.4,for=0,resolve=0",
    "x:p99<50",
    "x:p99<50ms,bogus=1",
    "x:p99<50ms,window=1,window=2",
    "x:ratio>=1.5",
    "x:p99<50ms,scope=cluster",
    "y:ratio>=0.9,scope=bin",
    "z:ratio>=0.9,metric=rafiki_tpu_serving_requests_total",
    "x:p99<50ms,fast=30,slow=10",
    "x:p99<50ms,window=10,slow=20",
    "x:p99<50ms,burn=0",
    "x:p99<50ms,for=-1",
    "x:p99<50ms,window=abc",
    "x:p99<50ms,window",
    "a:p99<1ms;a:p99<2ms",
    "nospec",
    "bad name:p99<1ms",
    "x:p100<1ms",
]


@pytest.mark.parametrize("text", RULES)
def test_inline_rules_parse_as_the_reference(text):
    got = [_parsed(slo, text) for slo, _, _ in PKGS.values()]
    assert got[0] == got[1]


FILES = [
    {"objectives": [{"name": "p99", "type": "latency", "target": 0.99,
                     "threshold_ms": 50, "scope": "tenant",
                     "window_s": 60, "fast_window_s": 5,
                     "slow_window_s": 30}]},
    {"objectives": [{"name": "a", "type": "ratio", "target": "0.995",
                     "burn_threshold": 6, "for_s": 3,
                     "resolve_for_s": 9}]},
    {"objectives": [{"name": "x", "type": "latency", "target": 0.9,
                     "threshold_ms": 5, "burn": 2}]},
    {"objectives": [{"type": "latency", "target": 0.9}]},
    {"objectives": [{"name": "x", "threshold_ms": 5, "target": 0.9}]},
    {"objectives": "none"},
    [],
]


@pytest.mark.parametrize("i", range(len(FILES) + 2))
def test_rules_files_parse_as_the_reference(i, tmp_path):
    path = tmp_path / "rules.json"
    if i < len(FILES):
        path.write_text(json.dumps(FILES[i]))
    elif i == len(FILES):
        path.write_text("{not json")
    else:
        path = tmp_path / "absent.json"
    got = [_parsed(slo, str(path)) for slo, _, _ in PKGS.values()]
    assert got[0] == got[1]


def test_good_total_interpolates_as_the_reference():
    rng = np.random.default_rng(7)
    for _ in range(200):
        bounds = sorted(set(np.round(rng.uniform(0.001, 1.0, 5), 4)))
        cum = np.cumsum(rng.integers(0, 20, len(bounds) + 1))
        deltas = [(float(b), int(c)) for b, c in zip(bounds, cum)]
        deltas.append((float("inf"), int(cum[-1])))
        thr = float(rng.uniform(0.0, 1.2))
        assert port_slo.good_total_from_deltas(deltas, thr) == \
            ref_slo.good_total_from_deltas(deltas, thr)


def _events(seed, n=120):
    """``(now, good, total)`` a second: healthy, a bad spell, healthy,
    gaps with no events, and a second bad spell."""
    rng = np.random.default_rng(seed)
    out, now = [], 1000.0
    for i in range(n):
        now += float(rng.uniform(0.5, 1.5))
        total = float(rng.integers(0, 40))
        bad_share = 0.6 if 30 <= i < 50 or 80 <= i < 86 else 0.002
        bad = float(rng.binomial(int(total), bad_share))
        out.append((now, total - bad, total))
    return out


@pytest.mark.parametrize("rule", [
    "a:p99<50ms,window=60,fast=5,slow=20,burn=2,for=3,resolve=6",
    "b:p95<50ms,window=30,fast=3,slow=30,burn=1,for=0,resolve=0",
    "c:ratio>=0.99,window=120,fast=10,slow=60,burn=14.4,for=2"])
@pytest.mark.parametrize("seed", [1, 2])
def test_instance_and_alert_machine_as_the_reference(rule, seed):
    runs = {}
    for kind, (slo, _, _) in PKGS.items():
        [obj] = slo.parse_rules(rule)
        inst = slo.Instance.create(obj, {"job": "j"})
        ring = slo.WindowRing(30.0, maxlen=64)
        steps = []
        for now, good, total in _events(seed):
            tr = inst.evaluate(now, good, total)
            ring.add(now, good, total)
            steps.append((tr, inst.machine.state, inst.burn_fast,
                          inst.burn_slow, inst.budget_remaining,
                          inst.good, inst.total,
                          ring.sums(now, 10.0),
                          ring.burn_rate(now, 10.0, obj.budget),
                          ring.budget_remaining(now, 30.0, obj.budget)))
        runs[kind] = steps
    assert runs["port"] == runs["ref"]
    transitions = [s[0] for s in runs["port"] if s[0] is not None]
    assert "firing" in transitions and "resolved" in transitions


# --- The engine ----------------------------------------------------------

class _Clock:
    """The clock an engine reads, stepped by the test."""

    def __init__(self):
        self.t = 5000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1_700_000_000.0 + self.t


class _Meta:
    def __init__(self, jobs):
        self.jobs = jobs

    def get_inference_jobs(self, status=None):
        return self.jobs


class _Services:
    def __init__(self, log_dir=""):
        self.log_dir = log_dir


JOB = "abcdef0123456789"


def _expo(http, bins, tenants, req, rej):
    """An exposition with the families the engine reads, cumulative."""
    lines = []
    for le, cum in http:
        lines.append(f'rafiki_tpu_http_request_seconds_bucket{{le="{le}",'
                     f'route="/predict",service="http1"}} {cum}')
    for b, rows in bins.items():
        for le, cum in rows:
            lines.append(f'rafiki_tpu_serving_bin_device_seconds_bucket'
                         f'{{job="{JOB[:12]}",bin="{b}",le="{le}"}} {cum}')
    for t, rows in tenants.items():
        for le, cum in rows:
            lines.append(f'rafiki_tpu_serving_tenant_request_seconds_bucket'
                         f'{{service="svc1",tenant="{t}",le="{le}"}} {cum}')
    lines.append('rafiki_tpu_serving_tenant_request_seconds_bucket'
                 '{service="other",tenant="intruder",le="+Inf"} 500')
    lines.append(f'rafiki_tpu_serving_requests_total{{service="svc1"}} {req}')
    lines.append(f'rafiki_tpu_serving_rejected_total{{service="svc1"}} {rej}')
    return "\n".join(lines) + "\n"


def _feed(seed, n=60):
    """A seeded sequence of cumulative expositions: latency buckets at
    25 and 100 ms for the job, two bins and two tenants; a counter reset
    at sweep 40 (a restarted frontend)."""
    rng = np.random.default_rng(seed)
    keys = ["http", "binA", "binB", "t1", "t2"]
    cum = {k: [0, 0, 0] for k in keys}
    req = rej = 0
    out = []
    for i in range(n):
        bad = 20 <= i < 32
        for k in keys:
            n_ev = int(rng.integers(0, 30))
            share = 0.5 if bad and k != "binA" else 0.003
            slow = int(rng.binomial(n_ev, share))
            mid = int(rng.integers(0, slow + 1))
            c = cum[k]
            c[0] += n_ev - slow
            c[1] += n_ev - slow + mid
            c[2] += n_ev
        req += int(rng.integers(0, 30))
        rej += int(rng.integers(0, 4)) if bad else 0
        if i == 40:
            cum = {k: [0, 0, 0] for k in keys}
            req = rej = 0

        def rows(k):
            c = cum[k]
            return [("0.025", c[0]), ("0.1", c[1]), ("+Inf", c[2])]

        out.append(_expo(rows("http"),
                         {"binA": rows("binA"), "binB": rows("binB")},
                         {"t1": rows("t1"), "t2": rows("t2")}, req, rej))
    return out


ENGINE_RULES = (
    "job-p99:p99<25ms,window=20,fast=3,slow=8,burn=2,for=2,resolve=3;"
    "bin-p90:p90<100ms,scope=bin,window=20,fast=3,slow=8,burn=1,for=1,"
    "resolve=2;"
    "ten-p95:p95<25ms,scope=tenant,window=20,fast=3,slow=8,burn=2,for=0,"
    "resolve=4;"
    "avail:ratio>=0.95,window=20,fast=3,slow=8,burn=1,for=1,resolve=2")


def _slo_series(metrics):
    out = []
    for name in SLO_FAMILIES:
        m = metrics.registry().find(name)
        for labels, v in (m.samples() if m is not None else ()):
            out.append((name, tuple(sorted(labels.items())), v))
    return sorted(out)


def _drive(kind, monkeypatch, feed, log_dir="", alert_log_mb=16.0):
    slo, engine_mod, metrics = PKGS[kind]
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    jobs = [{"id": JOB, "predictor_host": "x:1"}]
    eng = engine_mod.SloEngine(_Services(log_dir), _Meta(jobs),
                               slo.parse_rules(ENGINE_RULES),
                               alert_log_mb=alert_log_mb)
    state = {"text": feed[0]}

    class _Scrapes:
        def fetch(self, host, path):
            if path == "/stats":
                return {"service": "svc1", "http_service": "http1"}
            return state["text"]

    steps = []
    try:
        for text in feed:
            state["text"] = text
            clock.t += 0.5
            got = eng.sweep(scrapes=_Scrapes())
            steps.append(([{k: v for k, v in e.items() if k != "trace_id"}
                           for e in got], _slo_series(metrics),
                          eng.slo_pressure(JOB)))
        snap = eng.snapshot()
        alerts = eng.alerts_snapshot()
        for e in alerts["alerts"]:
            assert len(e.pop("trace_id")) == 32
        jobs.clear()  # the job stopped: its instances and gauges go
        eng.sweep(scrapes=_Scrapes())
        pruned = (eng.snapshot(), _slo_series(metrics))
    finally:
        eng.close()
    return steps, snap, alerts, pruned, _slo_series(metrics)


@pytest.mark.parametrize("seed", [3, 4])
def test_engine_sweeps_as_the_reference(seed, monkeypatch):
    feed = _feed(seed)
    runs = {kind: _drive(kind, monkeypatch, feed) for kind in PKGS}
    assert runs["port"] == runs["ref"]
    steps, snap, alerts, (snap_after, series_after), closed = runs["port"]
    fired = {(e["objective"], e["transition"]) for s in steps for e in s[0]}
    for name in ("job-p99", "bin-p90", "ten-p95", "avail"):
        assert (name, "firing") in fired, (name, fired)
    # The bad spell names the violating bin; binA stays clean.
    assert "binB" in {s[2] for s in steps}
    assert not any(e["labels"].get("tenant") == "intruder"
                   for s in steps for e in s[0])
    assert not any(e["labels"].get("bin") == "binA"
                   for s in steps for e in s[0])
    assert alerts["enabled"] and len(alerts["alerts"]) == \
        sum(len(s[0]) for s in steps)
    assert all(o["instances"] == [] for o in snap_after["objectives"])
    assert [s for s in series_after
            if s[0] != "rafiki_tpu_slo_alerts_total"] == []
    assert closed == []


def test_alert_log_rolls_and_close_drops_the_series(monkeypatch, tmp_path):
    feed = _feed(5, n=40)
    logs = {}
    for kind in PKGS:
        d = tmp_path / kind
        _, _, alerts, _, closed = _drive(kind, monkeypatch, feed,
                                         log_dir=str(d),
                                         alert_log_mb=100 / 2 ** 20)
        assert closed == []
        files = sorted(p.name for p in d.iterdir())
        lines = [json.loads(x) for name in files
                 for x in (d / name).read_text().splitlines()]
        for x in lines:
            assert len(x.pop("trace_id")) == 32
        logs[kind] = (files, lines, alerts)
    assert logs["port"] == logs["ref"]
    files, lines, alerts = logs["port"]
    # Each line is over the 100-byte cap: the log rolled at each write,
    # keeping one generation of one line.
    assert files == ["alerts.jsonl.1"] and len(alerts["alerts"]) > 1
    assert lines == [alerts["alerts"][0]]


def test_the_webhook_sender_posts_each_transition(monkeypatch):
    from rafiki_torch.utils.service import JsonHttpServer

    hits = []
    server = JsonHttpServer(
        [("POST", "/hook",
          lambda params, body, ctx: (hits.append(body) or (200, {})))],
        host="127.0.0.1", name="hook").start()
    clock = _Clock()
    monkeypatch.setattr(port_engine, "time", clock)
    before = {t.name for t in threading.enumerate()}
    state = {"text": _expo([("0.025", 0), ("+Inf", 0)], {}, {}, 0, 0)}

    class _Scrapes:
        def fetch(self, host, path):
            if path == "/stats":
                return {"service": "svc1", "http_service": "http1"}
            return state["text"]

    eng = port_engine.SloEngine(
        _Services(), _Meta([{"id": JOB, "predictor_host": "x:1"}]),
        port_slo.parse_rules("hook-p99:p99<25ms,window=30,fast=5,slow=10,"
                             "burn=1,for=0,resolve=3600"),
        webhook_url=f"http://127.0.0.1:{server.port}/hook")
    try:
        assert eng.sweep(scrapes=_Scrapes()) == []
        assert eng._webhook_thread is None  # no transition, no thread
        state["text"] = _expo([("0.025", 0), ("+Inf", 100)], {}, {}, 0, 0)
        clock.t += 1.0
        [tr] = eng.sweep(scrapes=_Scrapes())
        assert tr["transition"] == "firing"
        deadline = time.monotonic() + 10
        while not hits and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hits and hits[0]["objective"] == "hook-p99"
        assert hits[0]["trace_id"] == tr["trace_id"]
        assert "slo-webhook" in {t.name for t in threading.enumerate()} \
            - before
    finally:
        eng.close()
        server.stop()
    assert not eng._webhook_thread.is_alive()
    assert _slo_series(port_metrics) == []
