"""The port's autoscaler held against the reference's (after
``tests/test_autoscaler.py``), then driven on the CPU.

Against the reference: ``AutoscalePolicy`` on one table of signal
sequences (the hysteresis band, cooldowns, step bounds, ``slo_firing``
ahead of the queue signals, ``predicted``) and on seeded random ones;
``_signals`` over one sequence of scraped expositions; ``sweep`` with
stubbed stores and actuators, decision for decision; ``from_env``; and
the four control-loop routes of two fresh platforms.

On the CPU, the port alone (``TorchFeedForward``, ``device="cpu"``): a
scale-up through ``add_inference_worker`` that preempts an idle train
worker (the MFU gauges stubbed), a scale-down through
``drain_inference_worker`` under load with every query answered, the
regrow, dry run, real signals from the predictor's ``/metrics``, the
supervise hook's order and isolation, and, in a fresh process, no
control-loop series and no thread with the loop off.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from rafiki_torch.admin import autoscaler as port_as
from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.constants import (BudgetOption, ServiceStatus,
                                    ServiceType, TaskType, UserType)
from rafiki_torch.observe import metrics as port_metrics
from rafiki_tpu.admin import autoscaler as ref_as

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"port": port_as, "ref": ref_as}
WAIT_S = 60.0
AUTOSCALE_FAMILIES = ("rafiki_tpu_autoscale_", "rafiki_tpu_slo_")


# --- The policy ----------------------------------------------------------

def _run_policy(mod, knobs, steps):
    """Each step ``(now, signal fields, replicas)``: the trend, the
    regime and the decisions, with the cooldown bookkeeping of a live
    sweep that actuated them."""
    policy = mod.AutoscalePolicy(mod.PolicyKnobs(**knobs))
    state = mod.JobState()
    out = []
    for now, kw, replicas in steps:
        kw = dict(kw)
        if kw.get("bins") is not None:
            kw["bins"] = {b: mod.BinSignals(**s)
                          for b, s in kw["bins"].items()}
        sig = mod.JobSignals(**kw)
        policy.note_trend(sig, state, now)
        decisions = policy.decide(sig, dict(replicas), state, now)
        for d in decisions:
            if d.action == "scale_up":
                state.last_up_mono = now
            else:
                state.last_down_mono = now
        out.append((policy.classify(sig), [dataclasses.astuple(d)
                                           for d in decisions],
                    sig.queue_frac_pred, state.queue_slope_ewma))
    return out


BP = {"backpressure_delta": 3.0, "queue_depth": 10, "queue_cap": 100}
IDLE = {"queue_depth": 0, "queue_cap": 100}
TABLE = {
    "band holds": ({}, [(float(t), {"queue_depth": d, "queue_cap": 100},
                         {"a": 2}) for t, d in enumerate(
                             [5, 20, 3, 24, 10, 2.5, 15])]),
    "up cooldown": ({"up_cooldown_s": 10.0},
                    [(t, BP, {"a": 1, "b": 1}) for t in
                     (0.0, 1.0, 9.9, 10.0, 15.0, 21.0)]),
    "down cooldown after up": (
        {"up_cooldown_s": 1.0, "down_cooldown_s": 30.0},
        [(0.0, BP, {"a": 1}), (5.0, IDLE, {"a": 2}), (29.0, IDLE, {"a": 2}),
         (30.0, IDLE, {"a": 2}), (31.0, BP, {"a": 1}),
         (45.0, IDLE, {"a": 2}), (61.0, IDLE, {"a": 2})]),
    "step and ceiling": (
        {"step": 2, "max_replicas": 3, "up_cooldown_s": 0.0},
        [(0.0, BP, {"a": 1, "b": 3, "c": 2}), (1.0, BP, {"a": 2, "b": 3,
                                                          "c": 3}),
         (2.0, BP, {"a": 3, "b": 3, "c": 3})]),
    "never below one": ({"down_cooldown_s": 0.0},
                        [(0.0, IDLE, {"a": 1, "b": 1}),
                         (1.0, IDLE, {"a": 3, "b": 2})]),
    "queue high and p99": (
        {"p99_high_ms": 100.0, "up_cooldown_s": 0.0, "down_cooldown_s": 0.0},
        [(0.0, {"queue_depth": 30, "queue_cap": 100}, {"a": 1}),
         (1.0, {"queue_depth": 5, "queue_cap": 100, "p99_ms": 150.0},
          {"a": 2}),
         (2.0, {"queue_depth": 1, "queue_cap": 100, "p99_ms": 60.0},
          {"a": 3}),
         (3.0, {"queue_depth": 1, "queue_cap": 100, "p99_ms": 40.0},
          {"a": 3})]),
    "slo ahead of the queue": (
        {"up_cooldown_s": 0.0},
        [(0.0, dict(BP, slo_firing=""), {"a": 1, "b": 2}),
         (1.0, dict(IDLE, slo_firing=""), {"a": 2, "b": 2}),
         (2.0, dict(BP, slo_firing="bbbbbbbbbbbb"),
          {"aaaaaaaaaaaaXX": 1, "bbbbbbbbbbbbYY": 2}),
         (3.0, dict(IDLE, slo_firing="bbbbbbbbbbbb"),
          {"a": 4, "bbbbbbbbbbbbYY": 4})]),
    "per-bin signals": (
        {"up_cooldown_s": 0.0, "down_cooldown_s": 0.0},
        [(0.0, dict(BP, bins={"hot": {"qps": 90.0, "queue_rate": 1.0},
                              "cold": {"qps": 5.0}}),
          {"hot": 2, "cold": 1, "quiet": 1}),
         (1.0, dict(IDLE, bins={"hot": {"qps": 1.0},
                                "cold": {"qps": 0.5}}),
          {"hot": 3, "cold": 2, "quiet": 2})]),
    "predicted by the trend": (
        {"predict_horizon_s": 10.0, "up_cooldown_s": 0.0},
        [(float(t), {"queue_depth": d, "queue_cap": 100}, {"a": 1})
         for t, d in enumerate([1, 3, 5, 8, 12, 16, 20, 19, 18, 2])]),
    "predicted by the table": (
        {"predict_horizon_s": 30.0, "up_cooldown_s": 0.0},
        [(0.0, dict(IDLE, qps=2.0, expected_qps=2.5), {"a": 1}),
         (1.0, dict(IDLE, qps=2.0, expected_qps=3.0), {"a": 1}),
         (2.0, dict(IDLE, qps=0.1, expected_qps=1.6), {"a": 2}),
         (3.0, dict(BP, qps=0.1, expected_qps=9.0), {"a": 2})]),
}


@pytest.mark.parametrize("name", sorted(TABLE))
def test_the_policy_decides_as_the_reference(name):
    knobs, steps = TABLE[name]
    got = [_run_policy(mod, knobs, steps) for mod in PKGS.values()]
    assert got[0] == got[1]
    reasons = {d[2] for step in got[0] for d in step[1]}
    if name.startswith("slo"):
        assert reasons == {"slo_firing"}
        assert got[0][2][1][0][1] == "bbbbbbbbbbbbYY"
    if name.startswith("predicted"):
        assert "predicted" in reasons
    if name == "band holds":
        assert all(step[1] == [] for step in got[0])


@pytest.mark.parametrize("seed", range(4))
def test_the_policy_on_seeded_sequences_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        knobs = {"max_replicas": int(rng.integers(1, 5)),
                 "step": int(rng.integers(1, 3)),
                 "up_cooldown_s": float(rng.choice([0.0, 2.0, 10.0])),
                 "down_cooldown_s": float(rng.choice([0.0, 5.0, 60.0])),
                 "queue_high": float(rng.choice([0.25, 0.5])),
                 "queue_low": 0.02,
                 "p99_high_ms": float(rng.choice([0.0, 80.0])),
                 "predict_horizon_s": float(rng.choice([0.0, 5.0]))}
        replicas = {b: int(rng.integers(1, 4)) for b in ("x1", "y2", "z3")}
        steps, now = [], 0.0
        for _ in range(12):
            now += float(rng.uniform(0.2, 3.0))
            sig = {"qps": float(rng.uniform(0, 50)),
                   "queue_depth": float(rng.choice([0, 1, 10, 30, 80])),
                   "queue_cap": 100.0,
                   "backpressure_delta": float(rng.choice([0, 0, 0, 2])),
                   "p99_ms": float(rng.choice([20.0, 50.0, 120.0])),
                   "slo_firing": [None, None, None, "", "y2"][
                       int(rng.integers(0, 5))],
                   "expected_qps": float(rng.uniform(0, 100))
                   if rng.random() < 0.3 else None}
            if rng.random() < 0.5:
                sig["bins"] = {b: {"qps": float(rng.uniform(0, 30))}
                               for b in replicas if rng.random() < 0.7}
            steps.append((now, sig, dict(replicas)))
        got = [_run_policy(mod, knobs, steps) for mod in PKGS.values()]
        assert got[0] == got[1]


def test_from_env_builds_the_same_knobs(monkeypatch, tmp_path):
    table = tmp_path / "p.json"
    table.write_text(json.dumps({"period_s": 60, "bin_s": 30,
                                 "qps": [1.0, 4.0]}))
    for k, v in {"AUTOSCALE_MAX_REPLICAS": "3", "AUTOSCALE_STEP": "2",
                 "AUTOSCALE_UP_COOLDOWN_S": "1.5",
                 "AUTOSCALE_QUEUE_HIGH": "0.4",
                 "AUTOSCALE_IDLE_SWEEPS": "x",
                 "AUTOSCALE_PREDICT_HORIZON_S": "20",
                 "AUTOSCALE_DRY_RUN": "yes",
                 "AUTOSCALE_PERIODICITY": str(table)}.items():
        monkeypatch.setenv("RAFIKI_TPU_" + k, v)
    got = []
    for mod in PKGS.values():
        s = mod.Autoscaler.from_env(None, None)
        try:
            got.append((dataclasses.asdict(s.policy.knobs), s.dry_run,
                        s.periodicity))
        finally:
            s.close()
    assert got[0] == got[1]
    assert got[0][0]["max_replicas"] == 3 and got[0][1] is True


# --- Signals and the sweep, against the reference ------------------------

def _job_expo(i, rng, cum):
    """The frontend's families after sweep ``i`` (cumulative in
    ``cum``): load with 429s every fourth sweep, quiet from sweep 14."""
    quiet = i >= 14
    cum["req"] += int(rng.integers(0, 40))
    cum["rej"] += int(rng.integers(0, 3)) if i % 4 == 2 and not quiet \
        else 0
    for le in ("0.01", "0.05", "0.25", "+Inf"):
        cum[le] = cum.get(le, 0)
    n = int(rng.integers(0, 40))
    for j, le in enumerate(("0.01", "0.05", "0.25", "+Inf")):
        cum[le] += int(n * (j + 1) / 4)
    for b in ("aaaaaaaaaaaa", "bbbbbbbbbbbb"):
        cum["q" + b] = cum.get("q" + b, 0) + int(rng.integers(0, 30))
        cum["w" + b] = cum.get("w" + b, 0.0) + float(rng.uniform(0, 0.5))
    lines = [f'rafiki_tpu_serving_requests_total{{service="s1"}} '
             f'{cum["req"]}',
             f'rafiki_tpu_serving_rejected_total{{reason="queue_full",'
             f'service="s1"}} {cum["rej"]}',
             f'rafiki_tpu_serving_queue_depth_queries{{service="s1"}} '
             f'{0 if quiet else int(rng.integers(0, 60))}',
             'rafiki_tpu_serving_requests_total{service="other"} 999']
    for le in ("0.01", "0.05", "0.25", "+Inf"):
        lines.append(f'rafiki_tpu_http_request_seconds_bucket{{le="{le}",'
                     f'route="/predict",service="h1"}} {cum[le]}')
    if i >= 2:  # the ledger appears mid-run (attribution turned on)
        for b in ("aaaaaaaaaaaa", "bbbbbbbbbbbb"):
            lines.append(f'rafiki_tpu_serving_bin_queries_total{{bin="{b}",'
                         f'service="s1"}} {cum["q" + b]}')
            lines.append(f'rafiki_tpu_serving_bin_queue_seconds_total{{'
                         f'bin="{b}",service="s1"}} {cum["w" + b]!r}')
    return "\n".join(lines) + "\n"


class _Scrapes:
    def __init__(self, feed):
        self.feed = feed

    def fetch(self, host, path):
        if path == "/stats":
            return {"service": "s1", "http_service": "h1",
                    "knobs": {"queue_cap": 200}, "microbatch": True}
        return self.feed["text"]


def test_signals_fold_the_exposition_as_the_reference():
    got = {}
    for kind, mod in PKGS.items():
        rng = np.random.default_rng(11)
        cum = {"req": 0, "rej": 0}
        feed = {}
        scaler = mod.Autoscaler(None, None)
        state = mod.JobState()
        out = []
        try:
            for i in range(12):
                feed["text"] = _job_expo(i, rng, cum)
                sig = scaler._signals({"id": "j", "predictor_host": "h:1"},
                                      state, 100.0 + 1.5 * i,
                                      scrapes=_Scrapes(feed))
                out.append(None if sig is None else dataclasses.asdict(sig))
        finally:
            scaler.close()
        got[kind] = out
    assert got["port"] == got["ref"]
    assert got["port"][0] is None and got["port"][-1]["bins"]
    assert any(s["backpressure_delta"] > 0 for s in got["port"][1:])


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1_700_000_000.0 + self.t


class _FakeAllocator:
    def __init__(self, free):
        self.free = free

    def allocate(self, n, name, shared_ok=False):
        if self.free < n:
            return None
        self.free -= n
        return object()

    def release(self, name):
        self.free += 1


class _FakeMeta:
    def __init__(self, services):
        self.services = services

    def get_inference_jobs(self, status=None):
        return [{"id": "job-0123456789", "predictor_host": "h:1"}]

    def get_service(self, sid):
        return self.services.rows.get(sid)

    def get_train_jobs(self, status=None):
        return []


class _FakeServices:
    """Replica rows per bin; adds and drains counted, chips finite."""

    def __init__(self, free):
        self.allocator = _FakeAllocator(free)
        self.rows = {}
        self.workers = []
        self.n = 0
        for b in ("b1", "b2"):
            self.add_inference_worker("job-0123456789", b)

    def add_inference_worker(self, job_id, bin_id, chips_per_worker=1):
        if self.allocator.allocate(chips_per_worker, "x") is None:
            return None
        self.n += 1
        sid = f"svc{self.n:04d}" + "0" * 8
        self.rows[sid] = {"id": sid, "created_at": float(self.n),
                          "chips": [0] * chips_per_worker}
        self.workers.append({"service_id": sid, "trial_id": bin_id})
        return self.rows[sid]

    def drain_inference_worker(self, sid, drain_timeout=15.0):
        self.workers = [w for w in self.workers if w["service_id"] != sid]
        self.allocator.free += 1
        return {"service_id": sid, "drained": True}

    def active_inference_workers(self, job_id):
        return list(self.workers)


def test_the_sweep_decides_and_actuates_as_the_reference(monkeypatch):
    got = {}
    for kind, mod in PKGS.items():
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        services = _FakeServices(free=3)
        scaler = mod.Autoscaler(services, _FakeMeta(services),
                                knobs=mod.PolicyKnobs(
                                    up_cooldown_s=2.0, down_cooldown_s=5.0,
                                    max_replicas=3, mfu_floor=0.0))
        rng = np.random.default_rng(21)
        cum = {"req": 0, "rej": 0}
        feed = {}
        log = []
        try:
            for i in range(30):
                clock.t += 1.0
                feed["text"] = _job_expo(i, rng, cum)
                acted = [{k: v for k, v in e.items() if k != "trace_id"}
                         for e in scaler.sweep(scrapes=_Scrapes(feed))]
                log.append((acted, sorted(
                    (w["trial_id"], w["service_id"])
                    for w in services.workers)))
            snap = scaler.snapshot()
            assert all(len(e["trace_id"]) == 32 for e in snap["decisions"])
            snap["decisions"] = [
                {k: v for k, v in e.items() if k != "trace_id"}
                for e in snap["decisions"]]
            series = sorted(
                (name, tuple(sorted(labels.items())), v)
                for name in ("rafiki_tpu_autoscale_actions_total",
                             "rafiki_tpu_autoscale_target_replicas",
                             "rafiki_tpu_autoscale_actual_replicas")
                for labels, v in mod._metrics.registry().find(
                    name).samples())
        finally:
            scaler.close()
        got[kind] = (log, snap, series)
    assert got["port"] == got["ref"]
    actions = {e["action"] for step in got["port"][0] for e in step[0]}
    assert {"scale_up", "scale_down"} <= actions


# --- The routes against the reference's ----------------------------------

def _get(port, token, path):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        headers={"Authorization": f"Bearer {token}"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_the_control_loop_routes_answer_as_the_reference(tmp_path,
                                                         monkeypatch):
    from rafiki_torch.client import Client
    from rafiki_torch.platform import LocalPlatform as PortPlatform
    from rafiki_tpu.platform import LocalPlatform as RefPlatform

    for k in ("RAFIKI_TPU_AUTOSCALE", "RAFIKI_TPU_SLO_RULES"):
        monkeypatch.delenv(k, raising=False)
    answers = {}
    for kind, make in (
            ("port", lambda p: PortPlatform(workdir=p, device="cpu",
                                            supervise_interval=0,
                                            http=True)),
            ("ref", lambda p: RefPlatform(workdir=p, supervise_interval=0,
                                          http=True))):
        plat = make(str(tmp_path / kind))
        try:
            c = Client(admin_port=plat.admin_port)
            token = c.login("superadmin@rafiki", "rafiki")["token"]
            answers[kind] = [_get(plat.admin_port, token, p) for p in
                             ("/autoscale", "/slo", "/alerts",
                              "/capacity")]
        finally:
            plat.shutdown()
    assert answers["port"] == answers["ref"]
    off = answers["port"]
    assert [a[1] for a in off[:3]] == [{"enabled": False}] * 3
    cap = off[3][1]
    assert cap["enabled"] and cap["gate"]["ok"] \
        and cap["policy_source"] == "defaults" \
        and cap["workload"] == {"recorded": False}


# --- On the CPU: the port's loop on a real stack -------------------------

SMALL_FF = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models.feedforward import TorchFeedForward


class SmallFF(TorchFeedForward):
    # One small layer, one epoch.
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg.update(hidden_layer_count=FixedKnob(1),
                   hidden_layer_units=FixedKnob(16),
                   batch_size=FixedKnob(32), max_epochs=FixedKnob(1))
        return cfg
"""
OVERLOAD = port_as.JobSignals(qps=50.0, queue_depth=900, queue_cap=1000,
                              backpressure_delta=5)
QUIET = port_as.JobSignals(queue_depth=0, queue_cap=1000)


def _wait(cond, what, secs=WAIT_S):
    deadline = time.monotonic() + secs
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _predict(host, batch):
    req = urllib.request.Request(
        f"http://{host}/predict", data=json.dumps({"queries": batch})
        .encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())["predictions"]
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, None
    except OSError:
        return 0, None


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Three CPU chips, sharing off: a one-bin job (1 chip) and a donor
    train job of two workers (2 chips) fill them, so a scale-up must
    preempt the donor."""
    from rafiki_torch.datasets import make_synthetic_image_dataset
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.platform import LocalPlatform

    prior = os.environ.get("RAFIKI_TPU_CHIP_SHARE")
    os.environ["RAFIKI_TPU_CHIP_SHARE"] = "0"
    tmp = tmp_path_factory.mktemp("autoscale")
    data = make_synthetic_image_dataset(str(tmp / "data"), n_train=128,
                                        n_val=32, image_shape=(8, 8, 1),
                                        n_classes=4)
    plat = LocalPlatform(workdir=str(tmp / "plat"), supervise_interval=0,
                         device="cpu", n_chips=3)
    admin = plat.admin
    try:
        user = admin.create_user("scale@x.c", "pw", UserType.MODEL_DEVELOPER)
        model = admin.create_model(user["id"], "ff-scale",
                                   TaskType.IMAGE_CLASSIFICATION, "SmallFF",
                                   model_source=SMALL_FF)
        job = admin.create_train_job(
            user["id"], "scale", TaskType.IMAGE_CLASSIFICATION,
            [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 1}, *data,
            advisor_type="random")
        assert admin.wait_until_train_job_done(job["id"], timeout=WAIT_S)
        inf = admin.create_inference_job(user["id"], job["id"],
                                         max_models=1)
        donor = admin.create_train_job(
            user["id"], "donor", TaskType.IMAGE_CLASSIFICATION,
            [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 100000,
                            BudgetOption.CHIP_COUNT: 2}, *data,
            advisor_type="random")
        cache = Cache(plat.bus)
        _wait(lambda: len(cache.running_workers(inf["id"])) == 1,
              "the bin's worker did not register")
        ds = load_image_dataset(data[1])
        batch = [encode_payload(ds.images[i]) for i in range(3)]
        host = admin.get_inference_job(inf["id"])["predictor_host"]
        assert _predict(host, batch)[0] == 200
        yield {"plat": plat, "inf": inf, "donor": donor, "host": host,
               "batch": batch, "cache": cache}
    finally:
        plat.shutdown()
        if prior is None:
            os.environ.pop("RAFIKI_TPU_CHIP_SHARE", None)
        else:
            os.environ["RAFIKI_TPU_CHIP_SHARE"] = prior


def _donor_workers(plat, job_id):
    return [svc for sub in plat.meta.get_sub_train_jobs(job_id)
            for w in plat.meta.get_train_job_workers(sub["id"])
            for svc in [plat.meta.get_service(w["service_id"])]
            if svc["service_type"] == ServiceType.TRAIN
            and svc["status"] in (ServiceStatus.STARTED,
                                  ServiceStatus.DEPLOYING,
                                  ServiceStatus.RUNNING)]


def test_scale_up_preempts_then_drains_and_regrows(stack, monkeypatch):
    plat, inf, donor = stack["plat"], stack["inf"], stack["donor"]
    # No train loop's MFU gauge is visible: each donor sub-job reads idle.
    monkeypatch.setattr(port_as.Autoscaler, "_mfu_samples",
                        staticmethod(lambda: {}))
    scaler = port_as.Autoscaler(
        plat.services, plat.meta,
        knobs=port_as.PolicyKnobs(up_cooldown_s=0.0, down_cooldown_s=0.0,
                                  idle_sweeps=2, max_replicas=2))
    plat.services.autoscaler = scaler
    try:
        _wait(lambda: len(_donor_workers(plat, donor["id"])) == 2,
              "the donor's two workers did not start")
        assert scaler.sweep() == []  # the first scrape is the basis
        assert plat.allocator.free_chips == 0
        scaler._signals = lambda job, state, now: OVERLOAD
        acted = scaler.sweep()
        assert [d["action"] for d in acted] == ["scale_up"]
        up = acted[0]
        assert up["applied"] and up["reason"] == "backpressure" \
            and up["preempted_chips"] == 1
        assert len(_donor_workers(plat, donor["id"])) == 1
        assert len(plat.services.active_inference_workers(inf["id"])) == 2
        _wait(lambda: len(stack["cache"].running_workers(inf["id"])) == 2,
              "the added replica did not register")
        # The ceiling: no third replica however loud the signal.
        assert [d["action"] for d in scaler.sweep()] == []

        # Quiet under load: the newest replica drains, every request is
        # answered, and the donor gets its worker back.
        stop = threading.Event()
        answers = []

        def client():
            while not stop.is_set():
                answers.append(_predict(stack["host"], stack["batch"]))

        t = threading.Thread(target=client, daemon=True)
        t.start()
        try:
            _wait(lambda: len(answers) >= 3, "no answer under load")
            scaler._signals = lambda job, state, now: QUIET
            actions = []
            deadline = time.monotonic() + WAIT_S
            while "regrow" not in actions:
                assert time.monotonic() < deadline, actions
                actions += [d["action"] for d in scaler.sweep()]
            n = len(answers)
            _wait(lambda: len(answers) >= n + 3, "no answer after drain")
        finally:
            stop.set()
            t.join(timeout=WAIT_S)
        assert actions == ["scale_down", "regrow"]
        assert answers and all(s == 200 and len(p) == 3 and
                               all(x is not None for x in p)
                               for s, p in answers), answers[:3]
        assert len(plat.services.active_inference_workers(inf["id"])) == 1
        assert len(stack["cache"].running_workers(inf["id"])) == 1
        assert len(_donor_workers(plat, donor["id"])) == 2
        snap = plat.admin.get_autoscale()
        assert snap["enabled"] and snap["epoch"] == scaler.epoch
        assert [d["action"] for d in snap["decisions"]] == [
            "regrow", "scale_down", "scale_up", "preempt_shrink"]
        assert all(len(d["trace_id"]) == 32 for d in snap["decisions"])
        assert snap["preempted"] == {} and snap["targets"]
    finally:
        plat.services.autoscaler = None
        scaler.close()
    c = port_metrics.registry().find("rafiki_tpu_autoscale_actions_total")
    assert c is None or c.samples() == []


def test_dry_run_records_without_actuating(stack):
    plat, inf = stack["plat"], stack["inf"]
    scaler = port_as.Autoscaler(plat.services, plat.meta,
                                knobs=port_as.PolicyKnobs(up_cooldown_s=0.0),
                                dry_run=True)
    try:
        before = len(plat.services.active_inference_workers(inf["id"]))
        scaler._signals = lambda job, state, now: OVERLOAD
        c = port_metrics.registry().find(
            "rafiki_tpu_autoscale_actions_total")
        n0 = c.value(action="scale_up", reason="backpressure")
        acted = scaler.sweep()
        assert [(d["action"], d["dry_run"], d["applied"]) for d in acted] \
            == [("scale_up", True, False)]
        assert len(plat.services.active_inference_workers(
            inf["id"])) == before
        assert c.value(action="scale_up", reason="backpressure") - n0 == 1
        assert scaler.snapshot()["dry_run"] is True
    finally:
        scaler.close()


def test_real_signals_from_the_predictor(stack):
    plat = stack["plat"]
    scaler = port_as.Autoscaler(plat.services, plat.meta)
    try:
        job = plat.meta.get_inference_job(stack["inf"]["id"])
        state = port_as.JobState()
        assert scaler._signals(job, state, time.monotonic()) is None
        for _ in range(5):
            assert _predict(stack["host"], stack["batch"])[0] == 200
        sig = scaler._signals(job, state, time.monotonic() + 0.5)
        assert sig is not None and sig.qps > 0 and sig.queue_cap > 1
        assert sig.p99_ms is not None and sig.p99_ms > 0
        assert sig.backpressure_delta == 0
    finally:
        scaler.close()


def test_supervise_sweeps_slo_then_autoscale_each_isolated(stack):
    services = stack["plat"].services
    calls = []

    class _Consumer:
        def __init__(self, name, fail=False):
            self.name, self.fail = name, fail

        def sweep(self, scrapes=None):
            calls.append((self.name, scrapes))
            if self.fail:
                raise RuntimeError("injected")

    try:
        services.slo_engine = _Consumer("slo", fail=True)
        services.autoscaler = _Consumer("autoscale")
        assert services.supervise() == []
        assert [n for n, _ in calls] == ["slo", "autoscale"]
        assert calls[0][1] is calls[1][1] and calls[0][1] is not None
        calls.clear()
        services.slo_engine = None
        services.supervise()
        assert [n for n, _ in calls] == ["autoscale"]
    finally:
        services.slo_engine = services.autoscaler = None
    calls.clear()
    services.supervise()
    assert calls == []


_STACK = r"""
import json, os, re, sys, threading, urllib.request
from rafiki_torch.client import Client
from rafiki_torch.observe.metrics import registry
from rafiki_torch.platform import LocalPlatform

plat = LocalPlatform(workdir=sys.argv[1], device="cpu",
                     supervise_interval=0, http=True)
plat.services.supervise()
token = Client(admin_port=plat.admin_port).login(
    "superadmin@rafiki", "rafiki")["token"]
routes = {}
for path in ("/autoscale", "/slo", "/alerts"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{plat.admin_port}{path}",
        headers={"Authorization": f"Bearer {token}"})
    routes[path] = json.loads(urllib.request.urlopen(req, timeout=60).read())
fams = sorted({line.split("{")[0].split(" ")[0]
               for line in registry().expose().splitlines()
               if line and not line.startswith("#")})
threads = sorted(re.sub(r"[0-9a-f]{4,}|\d+", "#", t.name)
                 for t in threading.enumerate()
                 if "process_request_thread" not in t.name)
print(json.dumps({"routes": routes, "families": fams, "threads": threads,
                  "armed": [plat.services.autoscaler is not None,
                            plat.services.slo_engine is not None]}))
plat.shutdown()
"""


def _fresh_stack(path, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("RAFIKI_TPU_AUTOSCALE", "RAFIKI_TPU_SLO_RULES")}
    e.update(env)
    e["PYTHONPATH"] = str(ROOT) + os.pathsep + e.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _STACK, str(path)],
                         cwd=ROOT, env=e, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_loop_off_adds_no_series_and_no_thread(tmp_path):
    off = _fresh_stack(tmp_path / "off")
    assert off["armed"] == [False, False]
    assert off["routes"] == {p: {"enabled": False}
                             for p in ("/autoscale", "/slo", "/alerts")}
    assert not [f for f in off["families"]
                if f.startswith(AUTOSCALE_FAMILIES)], off["families"]
    assert "rafiki_tpu_http_request_seconds_bucket" in off["families"]
    # Armed without a webhook: the engines ride the supervise thread.
    on = _fresh_stack(tmp_path / "on", RAFIKI_TPU_AUTOSCALE="1",
                      RAFIKI_TPU_SLO_RULES="p99:p99<50ms")
    assert on["armed"] == [True, True]
    assert on["routes"]["/autoscale"]["enabled"] \
        and on["routes"]["/slo"]["enabled"] \
        and on["routes"]["/alerts"] == {"enabled": True, "epoch": 1,
                                        "firing": [], "alerts": []}
    assert on["threads"] == off["threads"]
