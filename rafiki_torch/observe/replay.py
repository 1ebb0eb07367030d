"""Deterministic discrete-event replay of a workload against a modelled
fleet, under the control plane's own code.

The port's copy of ``rafiki_tpu/observe/replay.py``. ``simulate``
replays a trace's arrivals (``observe/workload.py`` records; only
``off_s`` and ``n`` are read) against a fleet model and runs, on
simulated sweeps, ``AutoscalePolicy.decide`` and ``note_trend``
(``admin/autoscaler.py``) on ``JobSignals`` built from the simulated
queue, 429s and latencies, and the SLO ``Instance`` and ``AlertMachine``
(``observe/slo.py``) on the simulated completions.

Service time is what is modelled: each bin draws a batch's time from a
``BinModel``, either an inverse-CDF draw over cumulative buckets (the
workers' ``rafiki_tpu_serving_bin_device_seconds``, or a trace's own
``compute_ms``) or ``base + per_query * n`` with +-20% jitter. Compile
stalls, cache hits and stragglers are not modelled, and every admitted
request goes to every bin, so ``JobSignals.bins`` stays None. Absolute
numbers are estimates; policy comparisons are the output to trust.

One ``random.Random(seed)`` draws every sample, the event heap breaks
ties by insertion order and nothing reads the clock, so the same
(trace, fleet, knobs, seed) gives the same report, byte for byte.
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..admin.autoscaler import (AutoscalePolicy, Decision, JobSignals,
                                JobState, PolicyKnobs)
from . import metrics as _metrics
from . import slo as _slo

#: The family the empirical fleet model is fit from (the workers'
#: per-bin device-time histogram).
FLEET_SOURCE_SERIES = "rafiki_tpu_serving_bin_device_seconds"


# --- Fleet model -------------------------------------------------------

@dataclass(frozen=True)
class BinModel:
    """One serving bin's service-time model.

    ``buckets`` (empirical): cumulative ``[(le_seconds, count), ...]``
    from the live ledger histogram; per-batch service time is an
    inverse-CDF draw with uniform interpolation inside the landing
    bucket. A draw landing in the ``+Inf`` bucket reports 1.5x the last
    finite bound — a known floor, never a fabricated tail.

    ``base_s``/``per_query_s`` (synthetic fallback): affine in the
    batch's query count with ±20% uniform jitter, for canned traces and
    fleets that have no ledger history yet.
    """

    name: str
    buckets: Tuple[Tuple[float, float], ...] = ()
    base_s: float = 0.005
    per_query_s: float = 0.04

    def service_s(self, n_queries: int, rng: random.Random) -> float:
        if self.buckets and self.buckets[-1][1] > 0:
            total = self.buckets[-1][1]
            rank = rng.random() * total
            prev_bound, prev_cum = 0.0, 0.0
            for bound, cum in self.buckets:
                if cum >= rank:
                    if bound == math.inf:
                        return prev_bound * 1.5
                    if cum <= prev_cum:
                        return bound
                    frac = (rank - prev_cum) / (cum - prev_cum)
                    return prev_bound + (bound - prev_bound) * frac
                prev_bound, prev_cum = bound, cum
            return prev_bound
        jitter = 0.8 + 0.4 * rng.random()
        return (self.base_s + self.per_query_s * max(1, n_queries)) \
            * jitter


@dataclass(frozen=True)
class FleetModel:
    """The modeled fleet: one :class:`BinModel` per serving bin."""

    bins: Tuple[BinModel, ...]

    @classmethod
    def synthetic(cls, n_bins: int = 1, base_s: float = 0.005,
                  per_query_s: float = 0.04) -> "FleetModel":
        """Default synthetic fleet. One bin by default: every admitted
        request scatters to EVERY bin (the uniform-attribution caveat
        above) while a scale-up only feeds one, so multi-bin synthetic
        fleets demand a per-bin scaling cadence the per-job step/
        cooldown knobs were never sized for — multi-bin models earn
        their keep when fit from a real ledger, not fabricated."""
        return cls(bins=tuple(
            BinModel(name=f"bin{i}", base_s=base_s,
                     per_query_s=per_query_s) for i in range(n_bins)))

    @classmethod
    def from_trace(cls, trace: Sequence[Dict[str, Any]],
                   name: str = "trace") -> Optional["FleetModel"]:
        """Empirical service-time model from a recorded workload's own
        ``compute_ms`` column (the edge duration minus admission wait).
        Unlike :meth:`from_exposition` — the device-kernel histogram —
        this includes the scatter/gather and HTTP overhead the edge
        actually pays per dispatch, so it is the fit to compare with a
        live p99.
        None when the trace carries no served compute samples."""
        comp = sorted(float(r.get("compute_ms") or 0.0) / 1e3
                      for r in trace
                      if r.get("status") == 200 and r.get("compute_ms"))
        if not comp:
            return None
        # Exact empirical inverse-CDF: one cumulative step per sample
        # (service_s interpolates between order statistics).
        buckets = tuple((v, float(i + 1)) for i, v in enumerate(comp))
        return cls(bins=(BinModel(name=name, buckets=buckets),))

    @classmethod
    def from_exposition(cls, text: str) -> Optional["FleetModel"]:
        """Fit per-bin empirical models from a /metrics exposition's
        ``rafiki_tpu_serving_bin_device_seconds`` buckets. None when
        the ledger families are absent or empty (attribution off, or
        no traffic yet) — callers fall back to :meth:`synthetic`."""
        parsed = _metrics.parse_exposition(text)
        by_bin: Dict[str, Dict[float, float]] = {}
        for labels, v in parsed.get(f"{FLEET_SOURCE_SERIES}_bucket", []):
            b = labels.get("bin", "")
            le = labels.get("le", "")
            bound = math.inf if le == "+Inf" else float(le)
            row = by_bin.setdefault(b, {})
            row[bound] = max(row.get(bound, 0.0), float(v))
        models = []
        for b in sorted(by_bin):
            cum = tuple(sorted(by_bin[b].items()))
            if cum and cum[-1][1] > 0:
                models.append(BinModel(name=b, buckets=cum))
        return cls(bins=tuple(models)) if models else None


# --- Simulation knobs --------------------------------------------------

@dataclass(frozen=True)
class SimKnobs:
    """The simulated frontend/fleet constants (not the policy's)."""

    seed: int = 0
    sweep_interval_s: float = 1.0   # supervise cadence under test
    queue_cap: float = 64.0         # admission bound, in queries
    max_batch: int = 8              # batcher's per-burst query budget
    initial_replicas: int = 1       # per bin, at t=0
    provision_delay_s: float = 2.0  # scale-up actuation latency
    max_sim_s: float = 3600.0       # runaway guard past the last arrival


# --- The engine --------------------------------------------------------

class _Sim:
    """One simulation run's mutable state (see :func:`simulate`)."""

    def __init__(self, fleet: FleetModel, sim: SimKnobs,
                 policy: AutoscalePolicy,
                 objectives: Sequence[_slo.Objective],
                 periodicity: Optional[Dict[str, Any]]):
        self.fleet = {m.name: m for m in fleet.bins}
        self.sim = sim
        self.policy = policy
        self.rng = random.Random(sim.seed)
        self.periodicity = periodicity
        # Event heap: (t, seq, kind, payload); seq makes ties stable.
        self.heap: List[Tuple[float, int, str, Any]] = []
        self.seq = 0
        self.req_seq = 0
        # Per-bin replica pools.
        self.active = {b: sim.initial_replicas for b in self.fleet}
        self.busy = {b: 0 for b in self.fleet}
        self.provisioning = {b: 0 for b in self.fleet}
        self.retiring = {b: 0 for b in self.fleet}
        self.queues: Dict[str, List[Tuple[int, int]]] = \
            {b: [] for b in self.fleet}  # [(req_id, n_queries), ...]
        # Requests in flight: req_id -> [t_arrive, pending_bin_slices].
        self.inflight: Dict[int, List[float]] = {}
        self.latencies_ms: List[float] = []
        self.sweep_latencies: List[float] = []  # completed this sweep
        self.rejected = 0
        self.admitted = 0
        self.arrived_queries = 0
        self.sweep_arrivals = 0
        self.sweep_admitted = 0
        self.sweep_rejected = 0
        # Controller state (the REAL JobState the policy reads).
        self.state = JobState()
        self.objectives = [
            _slo.Instance.create(o, {"job": "sim"}) for o in objectives
            if o.scope == "job"]
        self.skipped_objectives = [o.name for o in objectives
                                   if o.scope != "job"]
        self.decisions: List[Dict[str, Any]] = []
        self.timeline: List[Dict[str, Any]] = []
        self.replica_seconds = 0.0
        self._last_change_t = 0.0
        self.firing_s: Dict[str, float] = {}
        self.transitions: Dict[str, List[Dict[str, Any]]] = {}
        self.now = 0.0

    # -- event plumbing -------------------------------------------------

    def push(self, t: float, kind: str, payload: Any = None) -> None:
        self.seq += 1
        heapq.heappush(self.heap, (t, self.seq, kind, payload))

    def total_active(self) -> int:
        return sum(self.active.values())

    def _note_replica_change(self) -> None:
        self.replica_seconds += self.total_active() \
            * (self.now - self._last_change_t)
        self._last_change_t = self.now
        self.timeline.append(
            {"t": round(self.now, 3),
             "replicas": {b: self.active[b]
                          for b in sorted(self.active)}})

    # -- arrivals / service ---------------------------------------------

    def arrive(self, rec: Dict[str, Any]) -> None:
        n = max(1, int(rec.get("n") or 1))
        self.sweep_arrivals += 1
        self.arrived_queries += n
        depth = self.queue_depth()
        if depth + n > self.sim.queue_cap:
            self.rejected += 1
            self.sweep_rejected += 1
            return
        self.admitted += 1
        self.sweep_admitted += 1
        # Own counter: the heap's seq only advances on push(), so two
        # back-to-back arrivals that find every replica busy (no done
        # event pushed between them) would otherwise share an id and
        # alias each other's inflight slot.
        self.req_seq += 1
        req_id = self.req_seq
        self.inflight[req_id] = [self.now, len(self.fleet)]
        for b in self.fleet:
            self.queues[b].append((req_id, n))
            self.dispatch(b)

    def queue_depth(self) -> float:
        """Admission-gauge analogue: queries queued toward the slowest
        bin (the bin that gates the frontend)."""
        if not self.queues:
            return 0.0
        return float(max((sum(n for _, n in q)
                          for q in self.queues.values()), default=0))

    def dispatch(self, b: str) -> None:
        while self.queues[b] and \
                self.busy[b] < self.active[b] - self.retiring[b]:
            batch: List[Tuple[int, int]] = []
            got = 0
            while self.queues[b] and got < self.sim.max_batch:
                item = self.queues[b].pop(0)
                batch.append(item)
                got += item[1]
            self.busy[b] += 1
            svc = self.fleet[b].service_s(got, self.rng)
            self.push(self.now + max(1e-6, svc), "done", (b, batch))

    def complete(self, b: str, batch: List[Tuple[int, int]]) -> None:
        self.busy[b] -= 1
        if self.retiring[b] > 0 and self.active[b] > 1:
            self.retiring[b] -= 1
            self.active[b] -= 1
            self._note_replica_change()
        for req_id, _n in batch:
            slot = self.inflight.get(req_id)
            if slot is None:
                continue
            slot[1] -= 1
            if slot[1] <= 0:
                del self.inflight[req_id]
                ms = (self.now - slot[0]) * 1e3
                self.latencies_ms.append(ms)
                self.sweep_latencies.append(ms)
        self.dispatch(b)

    def provision(self, b: str) -> None:
        self.provisioning[b] -= 1
        self.active[b] += 1
        self._note_replica_change()
        self.dispatch(b)

    # -- the sweep (the real control plane, on simulated signals) -------

    def counts(self) -> Dict[str, int]:
        return {b: self.active[b] + self.provisioning[b]
                - self.retiring[b] for b in self.fleet}

    def sweep(self) -> None:
        dt = self.sim.sweep_interval_s
        sig = JobSignals(queue_depth=self.queue_depth(),
                         queue_cap=self.sim.queue_cap)
        inst_qps = self.sweep_arrivals / dt
        self.state.qps_ewma = (
            inst_qps if self.state.qps_ewma is None else
            0.4 * inst_qps + 0.6 * self.state.qps_ewma)
        sig.qps = self.state.qps_ewma
        sig.backpressure_delta = float(self.sweep_rejected)
        if self.sweep_latencies:
            ordered = sorted(self.sweep_latencies)
            rank = max(0, math.ceil(0.99 * len(ordered)) - 1)
            sig.p99_ms = round(ordered[rank], 3)
        # The predictive plane, exactly as the live sweep feeds it:
        # queue-trend projection plus the learned periodicity lookup
        # (sim time doubles as the phase clock).
        self.policy.note_trend(sig, self.state, self.now)
        if self.periodicity is not None and \
                self.policy.knobs.predict_horizon_s > 0:
            from ..admin.capacity import expected_qps
            sig.expected_qps = expected_qps(
                self.periodicity, self.now,
                self.policy.knobs.predict_horizon_s)
        # SLO instances judge this sweep's completions/admissions.
        firing = None
        for inst in self.objectives:
            obj = inst.objective
            if obj.otype == "latency":
                thr = obj.threshold_ms
                good = float(sum(1 for ms in self.sweep_latencies
                                 if ms <= thr))
                total = float(len(self.sweep_latencies))
            else:
                good = float(self.sweep_admitted)
                total = float(self.sweep_admitted + self.sweep_rejected)
            transition = inst.evaluate(self.now, good, total)
            if transition is not None:
                self.transitions.setdefault(obj.name, []).append(
                    {"t": round(self.now, 3), "state": transition})
            if inst.machine.state == "firing":
                self.firing_s[obj.name] = \
                    self.firing_s.get(obj.name, 0.0) + dt
                if obj.otype == "latency":
                    firing = ""
        sig.slo_firing = firing
        counts = self.counts()
        for d in self.policy.decide(sig, counts, self.state, self.now):
            self.apply(d, counts, sig)
        self.sweep_latencies = []
        self.sweep_arrivals = 0
        self.sweep_admitted = 0
        self.sweep_rejected = 0

    def apply(self, d: Decision, counts: Dict[str, int],
              sig: JobSignals) -> None:
        self.decisions.append(
            {"t": round(self.now, 3), "action": d.action, "bin": d.bin,
             "reason": d.reason, "replicas": counts[d.bin],
             "signals": {"qps": round(sig.qps, 2),
                         "queue_frac": round(sig.queue_frac, 4),
                         "backpressure_delta": sig.backpressure_delta,
                         "p99_ms": sig.p99_ms}})
        if d.action == "scale_up":
            # Same cooldown contract as Autoscaler._apply: the attempt
            # consumes the cooldown.
            self.state.last_up_mono = self.now
            self.provisioning[d.bin] += 1
            self.push(self.now + self.sim.provision_delay_s,
                      "provision", d.bin)
        else:
            self.state.last_down_mono = self.now
            if self.active[d.bin] - self.retiring[d.bin] > 1:
                if self.busy[d.bin] < self.active[d.bin] \
                        - self.retiring[d.bin]:
                    self.active[d.bin] -= 1  # a free replica retires now
                    self._note_replica_change()
                else:
                    self.retiring[d.bin] += 1  # retire on next drain

    # -- run ------------------------------------------------------------

    def run(self, trace: Sequence[Dict[str, Any]]) -> None:
        last_arrival = 0.0
        for rec in trace:
            t = max(0.0, float(rec.get("off_s") or 0.0))
            last_arrival = max(last_arrival, t)
            self.push(t, "arrival", rec)
        deadline = last_arrival + self.sim.max_sim_s
        self.push(self.sim.sweep_interval_s, "sweep", None)
        self._note_replica_change()
        while self.heap:
            t, _seq, kind, payload = heapq.heappop(self.heap)
            if t > deadline:
                break
            self.now = t
            if kind == "arrival":
                self.arrive(payload)
            elif kind == "done":
                self.complete(*payload)
            elif kind == "provision":
                self.provision(payload)
            elif kind == "sweep":
                self.sweep()
                # Sweeps stop once the work is drained — they are the
                # only self-renewing event, so this bounds the run.
                if self.inflight or self.heap:
                    self.push(self.now + self.sim.sweep_interval_s,
                              "sweep", None)
        self.replica_seconds += self.total_active() \
            * (self.now - self._last_change_t)
        self._last_change_t = self.now


def _percentile(ordered: List[float], q: float) -> Optional[float]:
    if not ordered:
        return None
    rank = max(0, math.ceil(q * len(ordered)) - 1)
    return round(ordered[rank], 3)


def simulate(trace: Sequence[Dict[str, Any]],
             fleet: Optional[FleetModel] = None,
             sim: Optional[SimKnobs] = None,
             policy: Optional[PolicyKnobs] = None,
             objectives: Sequence[_slo.Objective] = (),
             periodicity: Optional[Dict[str, Any]] = None,
             ) -> Dict[str, Any]:
    """Replay ``trace`` (workload records; only ``off_s``/``n`` are
    consumed) against ``fleet`` under ``policy`` + ``objectives``.
    Returns the full report: latency quantiles, 429s, the replica
    timeline, every policy decision, and per-objective SLO outcomes
    (``violations`` lists objectives that ever fired — the regression
    gate's verdict)."""
    fleet = fleet or FleetModel.synthetic()
    sim = sim or SimKnobs()
    engine = _Sim(fleet, sim, AutoscalePolicy(policy or PolicyKnobs()),
                  objectives, periodicity)
    engine.run(trace)
    ordered = sorted(engine.latencies_ms)
    actions: Dict[str, int] = {}
    for d in engine.decisions:
        key = f"{d['action']}:{d['reason']}"
        actions[key] = actions.get(key, 0) + 1
    slo_out = {}
    for inst in engine.objectives:
        name = inst.objective.name
        slo_out[name] = {
            "budget_remaining": round(inst.budget_remaining, 4),
            "firing_s": round(engine.firing_s.get(name, 0.0), 3),
            "state": inst.machine.state,
            "transitions": engine.transitions.get(name, []),
        }
    violations = sorted(n for n, s in slo_out.items()
                        if s["firing_s"] > 0 or s["state"] != "ok")
    return {
        "ok": not violations,
        "violations": violations,
        "requests": engine.admitted + engine.rejected,
        "served": len(engine.latencies_ms),
        "rejected": engine.rejected,
        "queries": engine.arrived_queries,
        "duration_s": round(engine.now, 3),
        "latency_ms": {
            "p50": _percentile(ordered, 0.50),
            "p95": _percentile(ordered, 0.95),
            "p99": _percentile(ordered, 0.99),
            "mean": (round(sum(ordered) / len(ordered), 3)
                     if ordered else None),
        },
        "replica_seconds": round(engine.replica_seconds, 3),
        "max_replicas": {b: max((e["replicas"][b]
                                 for e in engine.timeline), default=0)
                         for b in sorted(engine.fleet)},
        "replica_timeline": engine.timeline,
        "decisions": engine.decisions,
        "actions": actions,
        "slo": slo_out,
        "slo_skipped_scopes": sorted(engine.skipped_objectives),
        "seed": sim.seed,
    }
