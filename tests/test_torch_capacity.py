"""The port's replay simulator and capacity engine held against the
reference's (after ``tests/test_capacity.py``): ``simulate`` and
``score`` on the canned ``zipf``, ``ramp`` and ``chaos`` traces and on a
recorded ``workload.jsonl``, each report's JSON equal byte for byte;
the fleet models; the policy gate, green under the default policy and
red under a degraded one; the periodicity table's round trip; and the
CLI's reports and exit codes.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json

import numpy as np
import pytest

from rafiki_torch import capacity as port_cli
from rafiki_torch.admin import capacity as port_cap
from rafiki_torch.observe import replay as port_replay
from rafiki_torch.observe import slo as port_slo
from rafiki_tpu import capacity as ref_cli
from rafiki_tpu.admin import capacity as ref_cap
from rafiki_tpu.observe import replay as ref_replay
from rafiki_tpu.observe import slo as ref_slo

PKGS = {"port": (port_cap, port_replay, port_slo),
        "ref": (ref_cap, ref_replay, ref_slo)}
#: The reference's gate test's degraded policy: a queue high water no
#: load reaches, one replica, a minute's cooldown.
DEGRADED = {"queue_high": 0.98, "max_replicas": 1, "up_cooldown_s": 60}


def _dumps(report):
    return json.dumps(report, sort_keys=True)


@pytest.mark.parametrize("name", ["zipf", "ramp", "chaos"])
@pytest.mark.parametrize("seed", [0, 5])
def test_canned_traces_are_the_reference(name, seed):
    assert _dumps(port_cap.canned_trace(name, seed=seed)) == \
        _dumps(ref_cap.canned_trace(name, seed=seed))


SCENARIOS = [
    ("ramp", {}, {}, None),
    ("zipf", {"queue_high": 0.5, "step": 2}, {"sweep_interval_s": 0.5},
     None),
    ("chaos", {"down_cooldown_s": 5.0, "p99_high_ms": 400.0},
     {"queue_cap": 32.0, "provision_delay_s": 1.0, "seed": 3}, None),
    ("ramp", DEGRADED, {}, None),
    ("chaos", {"predict_horizon_s": 10.0}, {"max_batch": 4},
     "p99:p99<300ms,window=30,fast=5,slow=15,burn=2,for=1,resolve=5;"
     "avail:ratio>=0.98,window=30,fast=5,slow=15"),
]


@pytest.mark.parametrize("i", range(len(SCENARIOS)))
def test_simulate_and_score_as_the_reference(i):
    name, policy, sim, rules = SCENARIOS[i]
    out = {}
    for kind, (cap, replay, slo) in PKGS.items():
        trace = cap.canned_trace(name, seed=i)
        fleet = replay.FleetModel.synthetic(n_bins=1 + i % 2)
        objectives = slo.parse_rules(rules) if rules else ()
        knobs = cap.make_policy(policy)
        sim_knobs = replay.SimKnobs(**sim)
        sim_report = replay.simulate(trace, fleet=fleet, sim=sim_knobs,
                                     policy=knobs, objectives=objectives)
        score = cap.score(trace, policy=knobs,
                          objectives=(slo.parse_rules(rules) if rules
                                      else None), sim=sim_knobs)
        out[kind] = (_dumps(sim_report), _dumps(score))
    assert out["port"] == out["ref"]
    assert json.loads(out["port"][0])["served"] > 0


def _recorded(tmp_path, seed=9, n=600):
    """A ``workload.jsonl`` in the recorder's schema: seeded arrivals,
    a ramp in the middle, some 429s, served compute times."""
    rng = np.random.default_rng(seed)
    t, lines = 0.0, []
    for i in range(n):
        rate = 4.0 if i < 200 or i >= 450 else 25.0
        t += float(rng.exponential(1.0 / rate))
        q = int(rng.choice([1, 1, 2, 4]))
        status = 429 if 300 <= i < 320 and i % 3 == 0 else 200
        rec = {"off_s": round(t, 4), "t": round(1.7e9 + t, 3),
               "tenant": f"{int(rng.integers(0, 5)):016x}", "job": "jobx",
               "bins": ["b1"], "n": q, "size": 1 << (q - 1).bit_length(),
               "status": status, "dur_ms": round(float(rng.uniform(5, 80)),
                                                 3)}
        if status == 200:
            rec["queue_ms"] = round(float(rng.uniform(0, 5)), 3)
            rec["compute_ms"] = round(rec["dur_ms"] - rec["queue_ms"], 3)
        else:
            rec["reason"] = "queue_full"
        lines.append(json.dumps(rec))
    path = tmp_path / "workload.jsonl"
    path.write_text("\n".join(lines) + "\n")
    return path


def test_a_recorded_workload_replays_as_the_reference(tmp_path):
    path = _recorded(tmp_path)
    out = {}
    for kind, (cap, replay, slo) in PKGS.items():
        trace = cap.resolve_trace(str(path))
        fleet = replay.FleetModel.from_trace(trace)
        out[kind] = (_dumps(trace), repr(fleet),
                     _dumps(cap.score(trace)),
                     _dumps(cap.score(trace, policy=cap.make_policy(
                         DEGRADED))),
                     _dumps(cap.learn_periodicity(trace, 60.0, 5.0)))
    assert out["port"] == out["ref"]
    trace = json.loads(out["port"][0])
    assert len(trace) == 600 and json.loads(out["port"][2])["served"] > 0


def _exposition(rng):
    lines = []
    for b in ("aaaa", "bbbb"):
        cum = 0
        for le in ("0.001", "0.005", "0.01", "0.05", "+Inf"):
            cum += int(rng.integers(0, 50))
            lines.append(f'rafiki_tpu_serving_bin_device_seconds_bucket'
                         f'{{bin="{b}",job="j",le="{le}"}} {cum}')
    lines.append('rafiki_tpu_serving_bin_device_seconds_count'
                 '{bin="aaaa",job="j"} 7')
    return "\n".join(lines) + "\n"


def test_fleet_models_and_their_draws_as_the_reference():
    import random

    text = _exposition(np.random.default_rng(2))
    out = {}
    for kind, (cap, replay, slo) in PKGS.items():
        fleet = replay.FleetModel.from_exposition(text)
        rng = random.Random(4)
        draws = [m.service_s(n, rng) for m in fleet.bins
                 for n in (1, 3, 8) for _ in range(50)]
        synth = replay.FleetModel.synthetic(n_bins=2, base_s=0.01)
        draws += [m.service_s(n, rng) for m in synth.bins for n in (1, 5)]
        out[kind] = (repr(fleet), draws,
                     replay.FleetModel.from_exposition("# nothing\n"),
                     _dumps(replay.simulate(cap.canned_trace("ramp"),
                                            fleet=fleet)))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) > 0 and out["port"][2] is None


def test_the_policy_gate_is_green_by_default_and_red_degraded():
    out = {}
    for kind, (cap, _, _) in PKGS.items():
        green = cap.policy_gate()
        red = cap.policy_gate(policy=cap.make_policy(DEGRADED))
        out[kind] = (_dumps(green), _dumps(red))
    assert out["port"] == out["ref"]
    green, red = (json.loads(x) for x in out["port"])
    assert green["ok"] and green["violations"] == []
    assert not red["ok"] and red["violations"]
    with pytest.raises(ValueError, match="unknown policy knob"):
        port_cap.make_policy({"queue_hihg": 0.5})


def test_periodicity_round_trips_and_bad_tables_are_refused(tmp_path):
    trace = port_cap.canned_trace("chaos", seed=1)
    table = port_cap.learn_periodicity(trace, period_s=60.0, bin_s=10.0)
    assert table == ref_cap.learn_periodicity(trace, 60.0, 10.0)
    path = tmp_path / "p.json"
    path.write_text(json.dumps(table))
    loaded = port_cap.load_periodicity(str(path))
    assert loaded == ref_cap.load_periodicity(str(path)) == table
    assert [port_cap.expected_qps(loaded, t, 5.0) for t in range(0, 90, 7)] \
        == [ref_cap.expected_qps(loaded, t, 5.0) for t in range(0, 90, 7)]
    for bad in ({"period_s": 60, "bin_s": 10, "qps": [1.0]},
                {"period_s": 60, "bin_s": 0, "qps": []},
                {"period_s": 60, "bin_s": 30, "qps": [1.0, -1.0]},
                {"bin_s": 30, "qps": [1.0, 2.0]}, [1, 2]):
        path.write_text(json.dumps(bad))
        msgs = []
        for cap in (port_cap, ref_cap):
            with pytest.raises(ValueError) as e:
                cap.load_periodicity(str(path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError):
        port_cap.learn_periodicity(trace, period_s=10.0, bin_s=20.0)


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("argv,rc", [
    (["score", "--trace", "ramp"], 0),
    (["score", "--trace", "ramp", "--policy", json.dumps(DEGRADED)], 1),
    (["score", "--trace", "chaos", "--full", "--seed", "2",
      "--queue-cap", "32"], None),
    (["score", "--trace", "zipf", "--slo",
      "p50:p50<100ms,window=30,fast=5,slow=15"], None),
    (["score", "--trace", "ramp", "--policy", '{"nope": 1}'], 2),
    (["score", "--trace", "nope"], 2),
    (["learn", "--trace", "zipf", "--period", "60", "--bin", "15"], 0),
])
def test_the_cli_reports_and_exits_as_the_reference(argv, rc, capsys):
    got = [_cli(m, list(argv), capsys) for m in (port_cli, ref_cli)]
    assert got[0] == got[1]
    if rc is not None:
        assert got[0][0] == rc


def test_the_cli_scores_a_recorded_trace_and_writes_a_table(tmp_path,
                                                              capsys):
    path = _recorded(tmp_path)
    fleet = tmp_path / "fleet.prom"
    fleet.write_text(_exposition(np.random.default_rng(3)))
    rcs = {}
    for kind, mod in (("port", port_cli), ("ref", ref_cli)):
        out = tmp_path / f"{kind}.json"
        learn = _cli(mod, ["learn", "--trace", str(path), "--period", "60",
                           "--bin", "10", "--out", str(out)], capsys)
        score = _cli(mod, ["score", "--trace", str(tmp_path), "--fleet",
                           str(fleet), "--periodicity", str(out)], capsys)
        rcs[kind] = (learn, out.read_text(), score)
    assert rcs["port"] == rcs["ref"]
    assert rcs["port"][0][0] == 0 and rcs["port"][2][0] in (0, 1)
