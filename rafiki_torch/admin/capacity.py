"""Capacity engine: autoscale policies scored against workloads, offline.

The port's copy of ``rafiki_tpu/admin/capacity.py``, over
``observe/replay.py``:

- ``score``: one simulation, one report whose ``ok`` says that no SLO
  objective fired (``python -m rafiki_torch.capacity score`` and
  ``GET /capacity``);
- ``canned_trace``: deterministic ``zipf``, ``ramp`` and ``chaos``
  workloads, so a policy can be judged without a recorded trace;
  ``policy_gate`` runs the ramp under ``GATE_RULES``;
- ``learn_periodicity``, ``load_periodicity`` and ``expected_qps``: a
  phase-binned qps table learned from a trace, which the autoscaler's
  predictive plane reads (``RAFIKI_TPU_AUTOSCALE_PERIODICITY`` with
  ``RAFIKI_TPU_AUTOSCALE_PREDICT_HORIZON_S``).

Every verdict is deterministic in its inputs: seeded, with no clock.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Sequence

from ..observe import metrics as _metrics
from ..observe import slo as _slo
from .autoscaler import PolicyKnobs

#: Default gate objectives for canned-trace scoring: a coarse latency
#: ceiling plus admission availability, windowed for the canned traces'
#: 1 s simulated sweep cadence. Deliberately loose — the gate flags
#: policies that CANNOT keep up, not ones that are merely imperfect.
GATE_RULES = ("sim-p95:p95<1000ms,window=60,fast=10,slow=30,burn=2,"
              "for=2,resolve=10;"
              "sim-avail:ratio>=0.99,window=60,fast=10,slow=30,burn=2,"
              "for=2,resolve=10")

#: Canned trace vocabulary (see :func:`canned_trace`).
CANNED_TRACES = ("zipf", "ramp", "chaos")


# --- Canned workloads --------------------------------------------------

def _arrivals(rng: random.Random,
              segments: Sequence[tuple]) -> List[float]:
    """Exponential-gap arrival times for piecewise-linear rate segments
    ``(t0, t1, rate0, rate1)`` (requests/s at each edge)."""
    out: List[float] = []
    for t0, t1, r0, r1 in segments:
        t = float(t0)
        while t < t1:
            frac = (t - t0) / max(t1 - t0, 1e-9)
            rate = r0 + (r1 - r0) * frac
            if rate <= 0:
                t += 1.0
                continue
            t += rng.expovariate(rate)
            if t < t1:
                out.append(t)
    return out


def _zipf_tenant(rng: random.Random, n: int = 8) -> str:
    weights = [1.0 / k for k in range(1, n + 1)]
    total = sum(weights)
    u = rng.random() * total
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if u <= acc:
            return f"tenant{i}"
    return f"tenant{n - 1}"


def canned_trace(name: str, seed: int = 0) -> List[Dict[str, Any]]:
    """A deterministic synthetic workload in the recorder's schema.

    ``zipf``: 120 s of steady 8 req/s with a zipf-skewed tenant mix —
    the attribution-shaped baseline. ``ramp``: 60 s quiet (2 req/s)
    then a 60 s linear climb to 20 req/s — the scale-up stressor the
    regression gate judges policies on. ``chaos``: bursts an order of
    magnitude over base with a dead-quiet gap — the flap stressor.
    """
    rng = random.Random(seed)
    if name == "zipf":
        segments = [(0.0, 120.0, 8.0, 8.0)]
    elif name == "ramp":
        segments = [(0.0, 60.0, 2.0, 2.0), (60.0, 120.0, 2.0, 20.0)]
    elif name == "chaos":
        segments = [(0.0, 30.0, 2.0, 2.0), (30.0, 40.0, 25.0, 25.0),
                    (40.0, 55.0, 0.0, 0.0), (55.0, 70.0, 2.0, 2.0),
                    (70.0, 85.0, 30.0, 30.0), (85.0, 120.0, 2.0, 2.0)]
    else:
        raise ValueError(f"unknown canned trace {name!r} "
                         f"(valid: {', '.join(CANNED_TRACES)})")
    out = []
    for t in _arrivals(rng, segments):
        n = rng.choice((1, 1, 1, 2, 4))
        out.append({"off_s": round(t, 4), "t": round(t, 3),
                    "job": f"sim-{name}"[:12],
                    "tenant": _zipf_tenant(rng), "n": n,
                    "size": 1 << max(0, (n - 1).bit_length()),
                    "status": 200})
    return out


def resolve_trace(source: str) -> List[Dict[str, Any]]:
    """A canned trace name, or a recorded ``workload.jsonl`` file/log
    dir (observe/workload.py's reader)."""
    if source in CANNED_TRACES:
        return canned_trace(source)
    from ..observe import workload as _workload

    trace = _workload.load(source)
    if not trace:
        raise ValueError(f"trace {source!r} holds no workload records")
    return trace


# --- Periodicity -------------------------------------------------------

def learn_periodicity(trace: Sequence[Dict[str, Any]], period_s: float,
                      bin_s: float = 60.0) -> Dict[str, Any]:
    """Phase-binned request-rate table: fold every arrival onto its
    phase within ``period_s`` and average over the cycles the trace
    spans. The table deliberately stores qps (requests/s, matching the
    signal the policy compares against), not query counts."""
    if period_s <= 0 or bin_s <= 0 or bin_s > period_s:
        raise ValueError("periodicity needs 0 < bin_s <= period_s")
    n_bins = max(1, int(math.ceil(period_s / bin_s)))
    counts = [0] * n_bins
    span = 0.0
    for rec in trace:
        off = max(0.0, float(rec.get("off_s") or 0.0))
        span = max(span, off)
        counts[min(n_bins - 1, int((off % period_s) // bin_s))] += 1
    cycles = max(1, int(math.ceil(span / period_s)))
    return {"period_s": float(period_s), "bin_s": float(bin_s),
            "qps": [round(c / (bin_s * cycles), 4) for c in counts]}


def load_periodicity(path: str) -> Dict[str, Any]:
    """Read + validate a learned table. LOUD on any malformation —
    ``NodeConfig.validate`` calls this at startup so a typo'd table
    fails the node, not silently predicts nothing."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except OSError as e:
        raise ValueError(f"periodicity table {path!r}: {e}") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"periodicity table {path!r}: {e}") from None
    if not isinstance(data, dict):
        raise ValueError(f"periodicity table {path!r}: not an object")
    try:
        period_s = float(data["period_s"])
        bin_s = float(data["bin_s"])
        qps = [float(v) for v in data["qps"]]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"periodicity table {path!r}: needs numeric "
                         f"period_s, bin_s and a qps array ({e})") \
            from None
    if period_s <= 0 or bin_s <= 0 or bin_s > period_s:
        raise ValueError(f"periodicity table {path!r}: needs "
                         f"0 < bin_s <= period_s")
    want = max(1, int(math.ceil(period_s / bin_s)))
    if len(qps) != want:
        raise ValueError(f"periodicity table {path!r}: qps has "
                         f"{len(qps)} bins, period/bin implies {want}")
    if any(v < 0 for v in qps):
        raise ValueError(f"periodicity table {path!r}: negative qps")
    return {"period_s": period_s, "bin_s": bin_s, "qps": qps}


def expected_qps(table: Dict[str, Any], t: float,
                 horizon_s: float) -> float:
    """The table's request rate at phase ``t + horizon_s``."""
    phase = (t + horizon_s) % table["period_s"]
    qps = table["qps"]
    return float(qps[min(len(qps) - 1, int(phase // table["bin_s"]))])


# --- Scoring -----------------------------------------------------------

def make_policy(overrides: Optional[Dict[str, Any]]) -> PolicyKnobs:
    """PolicyKnobs from a candidate-policy mapping (the CLI's
    ``--policy`` JSON). Unknown keys are rejected loudly — a typo'd
    knob must not silently score the default policy."""
    overrides = overrides or {}
    valid = set(asdict(PolicyKnobs()))
    unknown = set(overrides) - valid
    if unknown:
        raise ValueError(f"unknown policy knob(s) {sorted(unknown)} "
                         f"(valid: {sorted(valid)})")
    return PolicyKnobs(**overrides)


def score(trace: Sequence[Dict[str, Any]],
          policy: Optional[PolicyKnobs] = None,
          objectives: Optional[Sequence[_slo.Objective]] = None,
          fleet=None, sim=None,
          periodicity: Optional[Dict[str, Any]] = None,
          ) -> Dict[str, Any]:
    """Simulate ``trace`` under ``policy`` and judge it against
    ``objectives`` (default: :data:`GATE_RULES`). The report's ``ok``
    is the regression-gate verdict: False iff any objective fired.

    When no ``fleet`` is given, a recorded trace's own ``compute_ms``
    column fits the service-time model (canned traces carry none, so
    they keep the synthetic fleet) — scoring a store against a
    fabricated fleet would judge the policy on latencies the edge
    never saw."""
    from ..observe import replay as _replay

    policy = policy or PolicyKnobs()
    if objectives is None:
        objectives = _slo.parse_rules(GATE_RULES)
    if fleet is None:
        fleet = _replay.FleetModel.from_trace(trace)
    report = _replay.simulate(trace, fleet=fleet, sim=sim,
                              policy=policy, objectives=objectives,
                              periodicity=periodicity)
    report["policy"] = asdict(policy)
    report["objectives"] = [o.name for o in objectives]
    return report


def policy_gate(policy: Optional[PolicyKnobs] = None,
                trace_name: str = "ramp", seed: int = 0,
                ) -> Dict[str, Any]:
    """The CI-facing gate: the canned ``trace_name`` trace against
    ``policy`` under :data:`GATE_RULES`. Deterministic in (policy,
    trace_name, seed)."""
    from ..observe import replay as _replay

    return score(canned_trace(trace_name, seed=seed), policy=policy,
                 sim=_replay.SimKnobs(seed=seed))


# --- Admin surface -----------------------------------------------------

def _workload_summary(log_dir: str) -> Dict[str, Any]:
    """Bounded recorded-trace summary for ``GET /capacity``: segment
    and line counts from a cheap scan, never a full parse (the active
    store can hold tens of MB)."""
    from ..observe import workload as _workload

    paths = _workload.segment_paths(log_dir)
    if not paths:
        return {"recorded": False}
    lines = 0
    for p in paths:
        try:
            with open(p, "rb") as f:
                lines += sum(1 for _ in f)
        except OSError:
            continue
    return {"recorded": True, "segments": len(paths),
            "records": lines}


#: Gate runs memoized by policy knobs: the gate is DETERMINISTIC in
#: (policy, trace, seed), so a dashboard polling GET /capacity every
#: few seconds pays one simulation per distinct policy, not per poll.
_gate_memo: Dict[tuple, Dict[str, Any]] = {}


def admin_snapshot(services) -> Dict[str, Any]:
    """The ``GET /capacity`` body: the recorded-workload inventory for
    this node plus a canned-ramp gate run of the policy the node would
    actually apply (the live autoscaler's knobs when the loop is on,
    the defaults otherwise)."""
    scaler = getattr(services, "autoscaler", None)
    policy = scaler.policy.knobs if scaler is not None else None
    key = tuple(sorted(asdict(policy or PolicyKnobs()).items()))
    report = _gate_memo.get(key)
    if report is None:
        report = _gate_memo[key] = policy_gate(policy=policy)
    if _metrics.metrics_enabled() and report["latency_ms"]["p99"] \
            is not None:
        # The dashboard's simulated-vs-live comparison series: the
        # canned-ramp gate's p99 under the node's live policy.
        _metrics.registry().gauge(
            "rafiki_tpu_capacity_sim_p99_seconds",
            "Simulated p99 of the canned-ramp policy gate under the "
            "node's active autoscale policy").set(
            report["latency_ms"]["p99"] / 1e3, trace="ramp")
    return {
        "enabled": True,
        "policy_source": "autoscaler" if scaler is not None
        else "defaults",
        "workload": _workload_summary(
            getattr(services, "log_dir", "") or ""),
        "gate": {
            "trace": "ramp",
            "ok": report["ok"],
            "violations": report["violations"],
            "latency_ms": report["latency_ms"],
            "rejected": report["rejected"],
            "served": report["served"],
            "actions": report["actions"],
            "max_replicas": report["max_replicas"],
            # The ring is bounded for the same reason GET /autoscale's
            # is: a UI surface, not a log.
            "decisions": report["decisions"][-20:],
        },
    }
