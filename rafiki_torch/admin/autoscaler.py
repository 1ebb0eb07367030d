"""Metrics-driven autoscaler: the serving control loop.

The port's copy of ``rafiki_tpu/admin/autoscaler.py``. One ``sweep()``
a supervise pass:

1. reads each RUNNING inference job's predictor ``/metrics``
   (``admin/scrape.py``): request-rate deltas, the admission queue's
   depth, backpressure (429) deltas, the ``/predict`` latency histogram
   and, with attribution on, the per-bin query and queue-seconds
   counters; a firing latency objective from the SLO engine
   (``slo_pressure``); and the process registry's
   ``rafiki_tpu_train_mfu_ratio`` gauges, the idle-training signal;
2. decides per-bin replica targets with ``AutoscalePolicy``, a pure
   decision table: a hysteresis band between the queue's low and high
   water, a per-sweep step bound and asymmetric cooldowns. Replay
   (``observe/replay.py``) runs this same code;
3. actuates through ``ServicesManager``: ``add_inference_worker`` to
   scale up (an exclusive chip first, the time-sliced tier under
   ``RAFIKI_TPU_MAX_CHIP_SHARE`` after it), ``drain_inference_worker``
   to scale down, and, when a hot bin finds no exclusive chip and a
   train sub-job's MFU has sat under the floor for ``idle_sweeps``
   sweeps, the stop of one of its train workers, regrown once the
   pressure is gone.

Each decision is counted (``rafiki_tpu_autoscale_actions_total{action,
reason}``), traced (an ``autoscale.<action>`` span) and kept in a
bounded ring (``GET /autoscale``); per-bin target and actual gauges
follow the replicas. ``dry_run`` records without actuating. Off (the
default) no autoscaler exists: supervise pays one attribute check and
no ``rafiki_tpu_autoscale_*`` series exists.

The MFU gauges live in this process's registry, which sees thread
workers only: a sub-job with no visible gauge reads as idle. Where
train workers run in processes, ``RAFIKI_TPU_AUTOSCALE_MFU_FLOOR=0``
turns preemption off.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..observe import metrics as _metrics
from ..observe import trace as _trace

_log = logging.getLogger(__name__)

#: Smoothing for the per-job qps EWMA (~the last handful of sweeps
#: dominate; one quiet sweep must not read as "the ramp ended").
_QPS_ALPHA = 0.4

#: Decisions kept for ``GET /autoscale`` (bounded: the ring is a
#: debugging/UI surface, not a log).
_RING_CAP = 256


@dataclass(frozen=True)
class PolicyKnobs:
    """The decision table's constants (NodeConfig ``autoscale_*``)."""

    max_replicas: int = 4          # per-bin ceiling
    step: int = 1                  # max replicas added per job per sweep
    up_cooldown_s: float = 10.0    # min gap between scale-ups
    down_cooldown_s: float = 60.0  # quiet time before a scale-down
    queue_high: float = 0.25       # queue_depth/queue_cap high water
    queue_low: float = 0.02        # low water (hysteresis band between)
    p99_high_ms: float = 0.0       # 0 = p99 not consulted
    mfu_floor: float = 0.05        # train sub-job idle threshold (0 = no
    #                                preemption)
    idle_sweeps: int = 3           # consecutive idle sweeps to preempt
    # Predictive scale-ahead: 0 = reactive only.
    # With a horizon, a positive queue-fraction trend projected to
    # cross the high water mark within ``predict_horizon_s`` — or a
    # learned periodicity table expecting >= ``predict_ramp_ratio``x
    # the current qps within the horizon — scales up BEFORE the ramp.
    predict_horizon_s: float = 0.0
    predict_ramp_ratio: float = 1.5


@dataclass(frozen=True)
class BinSignals:
    """One serving bin's load, from the attribution ledger
    (``rafiki_tpu_serving_bin_*``): smoothed queries/s scattered toward
    the bin and smoothed admission-wait seconds accrued per second by
    work bound for it."""

    qps: float = 0.0
    queue_rate: float = 0.0


@dataclass
class JobSignals:
    """One sweep's observed load for one inference job."""

    qps: float = 0.0               # smoothed requests/s
    queue_depth: float = 0.0       # admitted-unsent queries (gauge)
    queue_cap: float = 1.0         # the frontend's admission bound
    backpressure_delta: float = 0.0  # 429s since the previous sweep
    p99_ms: Optional[float] = None   # /predict p99 over this sweep
    # Per-bin load (None when the scraped frontend exposes no
    # attribution ledger — attribution off — the
    # per-job fallback). Keyed by the ledger's truncated bin label.
    bins: Optional[Dict[str, BinSignals]] = None
    # Predictive inputs (None = predictive plane off or no basis):
    # queue_frac projected ``predict_horizon_s`` ahead along the trend
    # EWMA (set by AutoscalePolicy.note_trend), and the learned
    # periodicity table's expected qps at now+horizon (set by the
    # sweep from the loaded table; the replay simulator sets both the
    # same way).
    queue_frac_pred: Optional[float] = None
    expected_qps: Optional[float] = None
    # A FIRING latency-SLO alert for this job (admin/slo_engine.py):
    # None = none firing; "" = job/tenant-scoped alert (any bin may
    # take the capacity); a bin label = the violating bin, which the
    # scale-up targets first. Prioritized over every queue signal —
    # "scale to the SLO, not the queue".
    slo_firing: Optional[str] = None

    @property
    def queue_frac(self) -> float:
        return self.queue_depth / max(self.queue_cap, 1.0)

    def bin_signal(self, bin_id: str) -> Optional[BinSignals]:
        """Ledger rows label bins by ``trial_id[:12]`` (bounded
        cardinality); replica counts key the full id — match here."""
        if not self.bins:
            return None
        return self.bins.get(str(bin_id)[:12])


@dataclass
class JobState:
    """Per-job controller memory across sweeps."""

    last_up_mono: float = float("-inf")
    last_down_mono: float = float("-inf")
    qps_ewma: Optional[float] = None
    # Previous scrape totals for delta signals.
    prev_requests: Optional[float] = None
    prev_backpressure: Optional[float] = None
    prev_buckets: Dict[float, int] = field(default_factory=dict)
    prev_mono: Optional[float] = None
    # Per-bin attribution totals + EWMAs (empty until a scrape exposes
    # the ledger families).
    prev_bin: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    bin_qps_ewma: Dict[str, float] = field(default_factory=dict)
    bin_queue_ewma: Dict[str, float] = field(default_factory=dict)
    # Queue-fraction trend basis (predictive scale-ahead): previous
    # observation + slope EWMA, advanced by AutoscalePolicy.note_trend.
    trend_mono: Optional[float] = None
    trend_frac: float = 0.0
    queue_slope_ewma: Optional[float] = None
    # /stats memo: (serving service label, http service label,
    # queue cap, microbatch on?).
    labels: Optional[Tuple[str, str, float, bool]] = None


@dataclass(frozen=True)
class Decision:
    """One policy verdict for one bin (pre-actuation)."""

    action: str      # "scale_up" | "scale_down"
    bin: str
    reason: str      # "slo_firing" | "backpressure" | "queue_high" |
    #                  "p99_high" | "predicted" | "idle"


class AutoscalePolicy:
    """The pure decision table — unit-testable without a platform.

    Hysteresis: *overloaded* (any high-water signal) scales up,
    *idle* (every signal under its low water) scales down, anything
    between holds. Cooldowns: a scale-up is allowed ``up_cooldown_s``
    after the previous one; a scale-down needs ``down_cooldown_s`` of
    distance from the LAST ACTION in either direction — scaling up is
    cheap to undo, tearing a replica down right after adding it is the
    textbook flap. Step bounds: at most ``step`` replicas added per
    job per sweep (spread across the least-replicated bins first), at
    most ONE removed.
    """

    def __init__(self, knobs: PolicyKnobs):
        self.knobs = knobs

    def classify(self, sig: JobSignals) -> Tuple[str, str]:
        """``(regime, reason)``: regime is "up", "down" or "hold"."""
        k = self.knobs
        if sig.slo_firing is not None:
            # A firing latency SLO outranks every queue signal: the
            # queue can read idle while tail latency burns the error
            # budget (slow replicas drain a short queue slowly).
            return "up", "slo_firing"
        if sig.backpressure_delta > 0:
            return "up", "backpressure"
        if sig.queue_frac >= k.queue_high:
            return "up", "queue_high"
        if k.p99_high_ms > 0 and sig.p99_ms is not None \
                and sig.p99_ms >= k.p99_high_ms:
            return "up", "p99_high"
        if k.predict_horizon_s > 0:
            # Scale AHEAD of the ramp: the projected queue fraction
            # crosses the high water within the horizon (and the queue
            # already shows life — above the low water, so floor noise
            # cannot trigger a prediction), or the learned periodicity
            # table expects a >= ramp_ratio x step-up (vs the current
            # qps, floored at 1 qps so near-idle noise never reads as
            # an imminent ramp). Ranked below every OBSERVED pressure
            # signal — a prediction must not outrank a measurement.
            if sig.queue_frac_pred is not None \
                    and sig.queue_frac_pred >= k.queue_high \
                    and sig.queue_frac > k.queue_low:
                return "up", "predicted"
            if sig.expected_qps is not None and sig.expected_qps \
                    >= k.predict_ramp_ratio * max(sig.qps, 1.0):
                return "up", "predicted"
        p99_quiet = (k.p99_high_ms <= 0 or sig.p99_ms is None
                     or sig.p99_ms <= 0.5 * k.p99_high_ms)
        if sig.queue_frac <= k.queue_low and p99_quiet:
            return "down", "idle"
        return "hold", "band"

    def note_trend(self, sig: JobSignals, state: JobState,
                   now: float) -> None:
        """Fold this sweep's queue fraction into the per-job slope EWMA
        and project ``sig.queue_frac_pred`` at ``predict_horizon_s``
        (left None on a flat/negative trend, a first observation, or a
        disabled horizon). Shared verbatim by the live sweep and the
        replay simulator (observe/replay.py) — the regression gate only
        means something if both predict with the same arithmetic."""
        k = self.knobs
        if k.predict_horizon_s <= 0:
            return
        if state.trend_mono is not None and now > state.trend_mono:
            inst = (sig.queue_frac - state.trend_frac) \
                / (now - state.trend_mono)
            prev = state.queue_slope_ewma
            state.queue_slope_ewma = (
                inst if prev is None else
                _QPS_ALPHA * inst + (1.0 - _QPS_ALPHA) * prev)
            if state.queue_slope_ewma > 0:
                sig.queue_frac_pred = min(
                    1.0, sig.queue_frac
                    + state.queue_slope_ewma * k.predict_horizon_s)
        state.trend_mono = now
        state.trend_frac = sig.queue_frac

    def decide(self, sig: JobSignals, replicas: Dict[str, int],
               state: JobState, now: float) -> List[Decision]:
        """The per-sweep verdicts for one job. Pure in ``(signals,
        replica counts, state timestamps, now)``; the caller applies
        cooldown bookkeeping on actuation (dry-run must not consume a
        cooldown it never acted on)."""
        if not replicas:
            return []
        k = self.knobs
        regime, reason = self.classify(sig)
        out: List[Decision] = []

        def per_replica_load(b: str) -> Optional[float]:
            s = sig.bin_signal(b)
            if s is None:
                return None
            return s.qps / max(replicas[b], 1)

        if regime == "up":
            if now - state.last_up_mono < k.up_cooldown_s:
                return []
            if sig.bins:
                # Per-bin signals (attribution ledger): the
                # HOTTEST bin per replica gets the capacity — a cold
                # bin that merely has fewer replicas no longer absorbs
                # a hot bin's scale-up. Unmeasured bins rank below any
                # measured one; replicas then bin id break ties.
                order = sorted(
                    replicas,
                    key=lambda b: (-(per_replica_load(b)
                                     if per_replica_load(b) is not None
                                     else -1.0), replicas[b], b))
            else:
                # Per-job fallback (old workers / attribution off):
                # fewest-replicas-first, bin id as the deterministic
                # tie break.
                order = sorted(replicas, key=lambda b: (replicas[b], b))
            if reason == "slo_firing" and sig.slo_firing:
                # A bin-scoped alert names its victim: the violating
                # bin takes the capacity first (stable sort keeps the
                # load/replica order among the rest).
                order.sort(key=lambda b: 0 if str(b)[:12]
                           == sig.slo_firing else 1)
            budget = k.step
            for b in order:
                if budget == 0:
                    break
                if replicas[b] >= k.max_replicas:
                    continue
                out.append(Decision("scale_up", b, reason))
                budget -= 1
        elif regime == "down":
            if now - max(state.last_up_mono,
                         state.last_down_mono) < k.down_cooldown_s:
                return []
            # Never below one replica (a bin's last replica is its
            # ensemble vote, not capacity).
            candidates = [b for b in replicas if replicas[b] > 1]
            if candidates:
                if sig.bins:
                    # COLDEST bin per replica drains first (most-
                    # replicated as the tie break). An UNMEASURED bin
                    # ranks coldest of all: no ledger rows means no
                    # observed traffic (a tiered best bin keeps every
                    # query from its siblings) — ranking it hottest
                    # would drain the one bin actually serving.
                    victim = min(candidates, key=lambda b: (
                        per_replica_load(b)
                        if per_replica_load(b) is not None
                        else -1.0, -replicas[b], b))
                else:
                    victim = sorted(candidates,
                                    key=lambda b: (-replicas[b], b))[0]
                out.append(Decision("scale_down", victim, reason))
        return out


class Autoscaler:
    """The controller: scrape → decide → actuate, one ``sweep()`` per
    supervise pass. Constructed only when ``RAFIKI_TPU_AUTOSCALE`` is
    on (LocalPlatform); ``ServicesManager.supervise`` holds a plain
    ``autoscaler`` attribute that is None otherwise."""

    def __init__(self, services, meta, knobs: Optional[PolicyKnobs] = None,
                 dry_run: bool = False,
                 periodicity: Optional[Dict[str, Any]] = None):
        self.services = services
        self.meta = meta
        self.policy = AutoscalePolicy(knobs or PolicyKnobs())
        self.dry_run = dry_run
        # Learned periodicity table (admin/capacity.py; None = no table
        # loaded). Consulted only when predict_horizon_s > 0.
        self.periodicity = periodicity
        self.epoch = 0
        self._jobs: Dict[str, JobState] = {}
        # sub_train_job_id -> consecutive sweeps its MFU sat below the
        # floor (missing gauge counts as 0.0 — see the module
        # docstring's honesty note).
        self._idle_train: Dict[str, int] = {}
        # Preemption debt: sub_id -> [n_chips, ...] of train workers we
        # shrank away, re-grown when pressure subsides.
        self._preempted: Dict[str, List[int]] = {}
        # Sweeps since any job last classified "up" — the regrow gate.
        self._quiet_sweeps = 0
        self._lock = threading.Lock()
        self._ring: "collections.deque" = collections.deque(
            maxlen=_RING_CAP)
        self._m_actions = self._m_target = self._m_actual = None
        self._m_reclaimed = None
        if _metrics.metrics_enabled():
            reg = _metrics.registry()
            self._m_actions = reg.counter(
                "rafiki_tpu_autoscale_actions_total",
                "Autoscaler decisions taken (or would-have, in dry "
                "run), by action and reason")
            self._m_target = reg.gauge(
                "rafiki_tpu_autoscale_target_replicas",
                "Replica target per serving bin (job= short job id, "
                "bin= short bin id)")
            self._m_actual = reg.gauge(
                "rafiki_tpu_autoscale_actual_replicas",
                "Live replicas per serving bin at the last sweep")
            self._m_reclaimed = reg.counter(
                "rafiki_tpu_autoscale_reclaimed_chips_total",
                "Chips reclaimed from idle train sub-jobs by "
                "preemption")

    @classmethod
    def from_env(cls, services, meta) -> "Autoscaler":
        """Build from the ``RAFIKI_TPU_AUTOSCALE_*`` env knobs
        ``NodeConfig.apply_env`` exported (the platform composition
        path; tests construct directly)."""
        import os

        from ..config import NodeConfig, _parse_bool

        def f(name, default):
            raw = os.environ.get(NodeConfig.env_name(name), "")
            try:
                return type(default)(raw) if raw else default
            except ValueError:
                return default

        knobs = PolicyKnobs(
            max_replicas=f("autoscale_max_replicas", 4),
            step=f("autoscale_step", 1),
            up_cooldown_s=f("autoscale_up_cooldown_s", 10.0),
            down_cooldown_s=f("autoscale_down_cooldown_s", 60.0),
            queue_high=f("autoscale_queue_high", 0.25),
            queue_low=f("autoscale_queue_low", 0.02),
            p99_high_ms=f("autoscale_p99_high_ms", 0.0),
            mfu_floor=f("autoscale_mfu_floor", 0.05),
            idle_sweeps=f("autoscale_idle_sweeps", 3),
            predict_horizon_s=f("autoscale_predict_horizon_s", 0.0),
            predict_ramp_ratio=f("autoscale_predict_ramp_ratio", 1.5),
        )
        dry = _parse_bool(os.environ.get(
            NodeConfig.env_name("autoscale_dry_run"), "0"))
        periodicity = None
        table_path = os.environ.get(
            NodeConfig.env_name("autoscale_periodicity"), "").strip()
        if table_path:
            from .capacity import load_periodicity

            try:
                periodicity = load_periodicity(table_path)
            except (OSError, ValueError):
                # NodeConfig.validate parsed this path at startup; a
                # table deleted since is a degraded signal, not a
                # reason to refuse the whole control loop.
                _log.warning("autoscale periodicity table %s "
                             "unreadable; periodicity predictions off",
                             table_path, exc_info=True)
        return cls(services, meta, knobs=knobs, dry_run=dry,
                   periodicity=periodicity)

    def close(self) -> None:
        """Drop every autoscale series (job/bin labels churn with
        deployments; a stopped autoscaler must not leak them into
        every future scrape)."""
        for m in (self._m_actions, self._m_target, self._m_actual,
                  self._m_reclaimed):
            if m is not None:
                m.remove()

    # --- The sweep -----------------------------------------------------

    def sweep(self, scrapes=None) -> List[Dict[str, Any]]:
        """One control pass; returns the decisions recorded (actuated
        or dry-run). Runs on the supervise thread — everything here is
        best-effort and must not raise into the sweep. ``scrapes`` is
        the sweep-shared :class:`~rafiki_torch.admin.scrape.ScrapeCache`
        when the supervise pass runs several metric consumers (the SLO
        engine scraped the same endpoints moments ago); None fetches
        directly."""
        self.epoch += 1
        now = time.monotonic()
        acted: List[Dict[str, Any]] = []
        jobs = self.meta.get_inference_jobs(status="RUNNING")
        live_ids = {j["id"] for j in jobs}
        self._prune_departed(live_ids)
        self._track_idle_training()
        any_up = False
        slo = getattr(self.services, "slo_engine", None)
        for job in jobs:
            state = self._jobs.setdefault(job["id"], JobState())
            # scrapes forwarded only when present: _signals is a test
            # seam (monkeypatched fakes keep the legacy 3-arg shape).
            sig = (self._signals(job, state, now) if scrapes is None
                   else self._signals(job, state, now,
                                      scrapes=scrapes))
            if sig is None:
                continue
            if slo is not None:
                # The SLO engine swept just before us (same supervise
                # pass): a firing latency objective is scale-up
                # pressure for this job, ahead of the queue signals.
                sig.slo_firing = slo.slo_pressure(job["id"])
            # Predictive inputs (no-ops when predict_horizon_s == 0):
            # trend projection from controller state, expected qps from
            # the learned periodicity table at wall-clock phase.
            self.policy.note_trend(sig, state, now)
            if self.periodicity is not None and \
                    self.policy.knobs.predict_horizon_s > 0:
                from .capacity import expected_qps

                sig.expected_qps = expected_qps(
                    self.periodicity, time.time(),
                    self.policy.knobs.predict_horizon_s)
            replicas, by_bin = self._replica_counts(job["id"])
            if not replicas:
                continue
            self._publish_actual(job["id"], replicas)
            decisions = self.policy.decide(sig, replicas, state, now)
            regime, _ = self.policy.classify(sig)
            any_up = any_up or regime == "up"
            for d in decisions:
                acted.append(self._apply(job["id"], d, replicas,
                                         by_bin, sig, state, now))
        if any_up:
            self._quiet_sweeps = 0
        else:
            self._quiet_sweeps += 1
            regrown = self._maybe_regrow(now)
            if regrown is not None:
                acted.append(regrown)
        return acted

    def _prune_departed(self, live_ids) -> None:
        for job_id in [j for j in self._jobs if j not in live_ids]:
            del self._jobs[job_id]
            if self._m_target is not None:
                self._m_target.remove(job=job_id[:8])
                self._m_actual.remove(job=job_id[:8])

    # --- Signals -------------------------------------------------------

    def _scrape(self, host: str, path: str) -> Any:
        from .scrape import fetch_endpoint

        return fetch_endpoint(host, path)

    def _signals(self, job: Dict[str, Any], state: JobState,
                 now: float, scrapes=None) -> Optional[JobSignals]:
        """Scrape the job's predictor and fold the exposition into
        delta signals. None (skip this job this sweep) when the
        frontend is not reachable yet."""
        host = job.get("predictor_host")
        if not host:
            return None
        fetch = scrapes.fetch if scrapes is not None else self._scrape
        try:
            if state.labels is None:
                stats = fetch(host, "/stats")
                knobs = stats.get("knobs") or {}
                state.labels = (stats.get("service") or "",
                                stats.get("http_service") or "",
                                float(knobs.get("queue_cap")
                                      or stats.get("queue_cap") or 1.0),
                                bool(stats.get("microbatch", True)))
            text = fetch(host, "/metrics")
        except (OSError, ValueError):
            state.labels = None  # re-resolve after a frontend restart
            return None
        service, http_service, queue_cap, microbatch = state.labels
        if not microbatch:
            # A batcher-off frontend has no admission queue: depth is
            # always 0 and 429s only fire on the fairness cap, so the
            # policy would read permanent "idle" and drain manually
            # attached replicas under live traffic. No honest signal
            # basis — leave the job alone.
            return None
        metrics = _metrics.parse_exposition(text)

        def total(name, **match):
            return sum(v for labels, v in metrics.get(name, [])
                       if all(labels.get(k) == str(mv)
                              for k, mv in match.items()))

        requests = total("rafiki_tpu_serving_requests_total",
                         service=service)
        backpressure = total("rafiki_tpu_serving_rejected_total",
                             service=service)
        depth = total("rafiki_tpu_serving_queue_depth_queries",
                      service=service)
        buckets: Dict[float, int] = {}
        for labels, v in metrics.get(
                "rafiki_tpu_http_request_seconds_bucket", []):
            if labels.get("service") != http_service or \
                    labels.get("route") != "/predict":
                continue
            le = labels.get("le")
            bound = float("inf") if le == "+Inf" else float(le)
            buckets[bound] = buckets.get(bound, 0) + int(v)

        # Per-bin attribution ledger (present only when the scraped
        # frontend runs with RAFIKI_TPU_SERVING_ATTRIBUTION): fold the
        # per-bin query/queue-seconds totals into per-bin rate EWMAs.
        # Absent families leave `bins` None — the per-job fallback.
        bin_now: Dict[str, Tuple[float, float]] = {}
        for labels, v in metrics.get(
                "rafiki_tpu_serving_bin_queries_total", []):
            if labels.get("service") != service:
                continue
            b = labels.get("bin", "")
            q, w = bin_now.get(b, (0.0, 0.0))
            bin_now[b] = (q + v, w)
        for labels, v in metrics.get(
                "rafiki_tpu_serving_bin_queue_seconds_total", []):
            if labels.get("service") != service:
                continue
            b = labels.get("bin", "")
            q, w = bin_now.get(b, (0.0, 0.0))
            bin_now[b] = (q, w + v)

        sig = JobSignals(queue_depth=depth, queue_cap=queue_cap)
        dt = (now - state.prev_mono) if state.prev_mono is not None \
            else None
        if bin_now and dt and dt > 0:
            bins: Dict[str, BinSignals] = {}
            for b, (q, w) in bin_now.items():
                pq, pw = state.prev_bin.get(b, (None, None))
                if pq is None:
                    continue  # first sight of this bin: basis only
                inst_q = max(0.0, q - pq) / dt
                inst_w = max(0.0, w - pw) / dt
                prev = state.bin_qps_ewma.get(b)
                state.bin_qps_ewma[b] = (
                    inst_q if prev is None else
                    _QPS_ALPHA * inst_q + (1.0 - _QPS_ALPHA) * prev)
                prev = state.bin_queue_ewma.get(b)
                state.bin_queue_ewma[b] = (
                    inst_w if prev is None else
                    _QPS_ALPHA * inst_w + (1.0 - _QPS_ALPHA) * prev)
                bins[b] = BinSignals(
                    qps=state.bin_qps_ewma[b],
                    queue_rate=state.bin_queue_ewma[b])
            if bins:
                sig.bins = bins
        if bin_now:
            state.prev_bin = bin_now
            # Bins retired by promotion churn must not pin stale EWMAs.
            for stale in [b for b in state.bin_qps_ewma
                          if b not in bin_now]:
                state.bin_qps_ewma.pop(stale, None)
                state.bin_queue_ewma.pop(stale, None)
        if dt and dt > 0 and state.prev_requests is not None:
            inst = max(0.0, requests - state.prev_requests) / dt
            state.qps_ewma = (inst if state.qps_ewma is None else
                              _QPS_ALPHA * inst +
                              (1.0 - _QPS_ALPHA) * state.qps_ewma)
        sig.qps = state.qps_ewma or 0.0
        if state.prev_backpressure is not None:
            sig.backpressure_delta = max(
                0.0, backpressure - state.prev_backpressure)
        deltas = sorted((le, buckets.get(le, 0)
                         - state.prev_buckets.get(le, 0))
                        for le in buckets)
        if deltas and deltas[-1][1] > 0:
            p99 = _metrics.bucket_percentile(deltas, 0.99)
            sig.p99_ms = round(p99 * 1e3, 3) if p99 is not None else None
        first = state.prev_mono is None
        state.prev_requests = requests
        state.prev_backpressure = backpressure
        state.prev_buckets = buckets
        state.prev_mono = now
        # The first scrape has no delta basis: record it, act next
        # sweep (a controller must never act on totals it cannot
        # attribute to a time window).
        return None if first else sig

    def _replica_counts(self, job_id: str,
                        ) -> Tuple[Dict[str, int],
                                   Dict[str, List[Dict[str, Any]]]]:
        """Live replicas per trial bin + the mapping rows per bin
        (newest-first, for the drain pick)."""
        by_bin: Dict[str, List[Dict[str, Any]]] = {}
        for w in self.services.active_inference_workers(job_id):
            by_bin.setdefault(str(w["trial_id"]), []).append(w)
        for rows in by_bin.values():
            rows.sort(key=lambda w: self._created_at(w), reverse=True)
        return {b: len(rows) for b, rows in by_bin.items()}, by_bin

    def _created_at(self, w: Dict[str, Any]) -> float:
        svc = self.meta.get_service(w["service_id"])
        return float(svc.get("created_at") or 0.0) if svc else 0.0

    def _publish_actual(self, job_id: str,
                        replicas: Dict[str, int]) -> None:
        if self._m_actual is None:
            return
        for b, n in replicas.items():
            self._m_actual.set(n, job=job_id[:8], bin=b[:12])

    # --- Actuation -----------------------------------------------------

    def _apply(self, job_id: str, d: Decision,
               replicas: Dict[str, int],
               by_bin: Dict[str, List[Dict[str, Any]]],
               sig: JobSignals, state: JobState,
               now: float) -> Dict[str, Any]:
        t0 = time.monotonic()
        wall = time.time()
        target = replicas[d.bin] + (1 if d.action == "scale_up" else -1)
        entry: Dict[str, Any] = {
            "epoch": self.epoch, "t": round(wall, 3),
            "job": job_id[:8], "bin": d.bin[:12],
            "action": d.action, "reason": d.reason,
            "replicas": replicas[d.bin], "target": target,
            "dry_run": self.dry_run,
            "signals": {"qps": round(sig.qps, 2),
                        "queue_frac": round(sig.queue_frac, 4),
                        "backpressure_delta": sig.backpressure_delta,
                        "p99_ms": sig.p99_ms},
        }
        if sig.slo_firing is not None:
            entry["signals"]["slo_firing"] = sig.slo_firing
        if sig.queue_frac_pred is not None:
            entry["signals"]["queue_frac_pred"] = \
                round(sig.queue_frac_pred, 4)
        if sig.expected_qps is not None:
            entry["signals"]["expected_qps"] = round(sig.expected_qps, 2)
        if sig.bins:
            entry["signals"]["bins"] = {
                b: {"qps": round(s.qps, 2),
                    "queue_rate": round(s.queue_rate, 4)}
                for b, s in sorted(sig.bins.items())}
        ok = True
        if not self.dry_run:
            try:
                if d.action == "scale_up":
                    # The attempt consumes the cooldown no matter how
                    # it ends — blocked OR raising: a starved (or
                    # launch-failing) node must not burn a probe, a
                    # service row, and possibly a preempted train
                    # worker on every 0.5 s sweep. Set BEFORE the
                    # call so the except path cannot skip it.
                    state.last_up_mono = now
                    ok = self._scale_up(job_id, d.bin, by_bin, entry)
                else:
                    ok = self._scale_down(job_id, d.bin, by_bin, entry)
                    if ok:
                        state.last_down_mono = now
            except Exception as e:
                ok = False
                entry["error"] = f"{type(e).__name__}: {e}"
                _log.exception("autoscale %s of %s/%s failed",
                               d.action, job_id[:8], d.bin[:12])
        entry["applied"] = ok and not self.dry_run
        # The counter label vocabulary stays FIXED: a failure detail
        # belongs in the ring entry, never in a label (cardinality).
        blocked_reason = "error" if "error" in entry else "no_capacity"
        self._record(entry, d.action if ok else f"{d.action}_blocked",
                     d.reason if ok else blocked_reason, wall, t0)
        if self._m_target is not None and ok:
            self._m_target.set(target, job=job_id[:8], bin=d.bin[:12])
        return entry

    def _scale_up(self, job_id: str, bin_id: str,
                  by_bin: Dict[str, List[Dict[str, Any]]],
                  entry: Dict[str, Any]) -> bool:
        """Attach one replica for the bin. When no EXCLUSIVE chip
        placement exists and an idle train sub-job qualifies, preempt
        one of its workers first — a time-sliced replica on saturated
        silicon adds latency, not capacity, so reclaiming a chip from
        training that isn't using it beats co-owning one."""
        registry = getattr(self.services, "node_registry", None)
        if registry is not None:
            # Failure-domain spread: with the cluster
            # fabric on, replicas of one bin land round-robin across
            # live nodes — a node death must never silence a bin's
            # ensemble vote. The registry's deterministic vote picks
            # exactly ONE placing node per pressure round; a deferring
            # node records why and lets the elected peer (seeing the
            # same shared meta rows + signals) act on ITS sweep.
            counts: Dict[str, int] = {}
            for w in by_bin.get(bin_id) or []:
                svc = self.meta.get_service(w["service_id"])
                nid = (svc or {}).get("node_id") or ""
                counts[nid] = counts.get(nid, 0) + 1
            if not registry.spread_ok(counts):
                entry["deferred_to_peer"] = True
                return False
        n_chips = self._bin_chips(by_bin.get(bin_id) or [])
        probe = f"autoscale-probe:{self.epoch}"
        group = self.services.allocator.allocate(n_chips, name=probe,
                                                 shared_ok=False)
        if group is not None:
            self.services.allocator.release(probe)
        else:
            reclaimed = self._preempt_idle_train(n_chips)
            if reclaimed:
                entry["preempted_chips"] = reclaimed
        svc = self.services.add_inference_worker(job_id, bin_id,
                                                 chips_per_worker=n_chips)
        if svc is None:
            return False
        entry["service_id"] = svc["id"][:8]
        return True

    def _scale_down(self, job_id: str, bin_id: str,
                    by_bin: Dict[str, List[Dict[str, Any]]],
                    entry: Dict[str, Any]) -> bool:
        rows = by_bin.get(bin_id) or []
        if len(rows) < 2:
            return False
        victim = rows[0]["service_id"]  # newest replica drains first
        # Short in-sweep wait: the common drain finishes within one
        # worker batch_timeout (~0.5 s); a worker wedged on a long
        # burst is hard-stopped at the deadline either way, and this
        # runs ON the supervise thread — a 15 s default here would
        # stall dead-service detection and every other decision.
        res = self.services.drain_inference_worker(victim,
                                                   drain_timeout=2.0)
        entry["service_id"] = victim[:8]
        entry["drained"] = bool(res.get("drained"))
        return True

    def _bin_chips(self, rows: List[Dict[str, Any]]) -> int:
        for w in rows:
            svc = self.meta.get_service(w["service_id"])
            if svc is not None and svc.get("chips"):
                return len(svc["chips"])
        return 1

    # --- Idle-train preemption ----------------------------------------

    def _track_idle_training(self) -> None:
        """Advance each RUNNING train sub-job's idle-sweep counter:
        below the MFU floor counts up, any sign of life resets. Runs
        every sweep (not only under pressure) so the idle verdict is
        already N sweeps deep when a starved bin needs chips."""
        floor = self.policy.knobs.mfu_floor
        if floor <= 0:
            self._idle_train.clear()
            return
        by_label = self._mfu_samples()
        live: set = set()
        for job in self.meta.get_train_jobs(status="RUNNING"):
            for sub in self.meta.get_sub_train_jobs(job["id"]):
                live.add(sub["id"])
                mfu = self._sub_job_mfu(sub["id"], by_label)
                if mfu < floor:
                    self._idle_train[sub["id"]] = \
                        self._idle_train.get(sub["id"], 0) + 1
                else:
                    self._idle_train.pop(sub["id"], None)
        for sub_id in [s for s in self._idle_train if s not in live]:
            del self._idle_train[sub_id]

    @staticmethod
    def _mfu_samples() -> Dict[str, float]:
        """MFU gauge value per ``trial`` label. The label is the
        TRUNCATED trial id (``trial_id[:12]`` — the TrialRunner's
        cardinality-bounded binding), so resolution to sub-jobs goes
        trial-row -> label prefix, never label -> meta lookup."""
        gauge = _metrics.registry().find("rafiki_tpu_train_mfu_ratio")
        if gauge is None:
            return {}
        return {labels.get("trial", ""): float(value)
                for labels, value in gauge.samples()}

    def _sub_job_mfu(self, sub_id: str,
                     by_label: Dict[str, float]) -> float:
        """max MFU over the sub-job's RUNNING trials' gauge samples
        (0.0 when none are visible — resident-runner visibility only,
        see the module docstring)."""
        if not by_label:
            return 0.0
        best = 0.0
        for trial in self.meta.get_trials(sub_id):
            if trial.get("status") != "RUNNING":
                continue
            v = by_label.get(str(trial["id"])[:12])
            if v is not None:
                best = max(best, v)
        return best

    def _idle_sub_jobs(self) -> List[str]:
        n = self.policy.knobs.idle_sweeps
        return sorted(s for s, c in self._idle_train.items() if c >= n)

    def _preempt_idle_train(self, want_chips: int) -> int:
        """Shrink idle train sub-jobs by one worker each until
        ``want_chips`` are freed (or candidates run out). A sub-job is
        never shrunk below ONE worker — the job must stay alive to be
        re-grown; trial rows are idempotent, so the stopped worker's
        in-flight trial is simply re-proposed later."""
        freed = 0
        for sub_id in self._idle_sub_jobs():
            if freed >= want_chips:
                break
            workers = [w for w in self.meta.get_train_job_workers(sub_id)
                       if self._active_train_worker(w)]
            if len(workers) < 2:
                continue
            victim = self.meta.get_service(workers[-1]["service_id"])
            n = len(victim.get("chips") or [1])
            self.services._stop_service(victim["id"])
            freed += n
            self._preempted.setdefault(sub_id, []).append(n)
            self._idle_train.pop(sub_id, None)
            if self._m_reclaimed is not None:
                self._m_reclaimed.inc(n)
            wall, t0 = time.time(), time.monotonic()
            self._record({"epoch": self.epoch, "t": round(wall, 3),
                          "job": sub_id[:8], "bin": "",
                          "action": "preempt_shrink",
                          "reason": "idle_train",
                          "chips": n, "dry_run": False,
                          "applied": True},
                         "preempt_shrink", "idle_train", wall, t0)
        return freed

    def _maybe_regrow(self, now: float) -> Optional[Dict[str, Any]]:
        """Give a preempted train sub-job its worker back once serving
        pressure has been absent for ``idle_sweeps`` sweeps — one
        worker per quiet sweep, so a regrow can never itself starve a
        ramp that returns mid-regrow."""
        if self._quiet_sweeps < self.policy.knobs.idle_sweeps \
                or not self._preempted:
            return None
        for sub_id in sorted(self._preempted):
            sub = self.meta.get_sub_train_job(sub_id)
            job = self.meta.get_train_job(sub["train_job_id"]) \
                if sub else None
            if job is None or job["status"] != "RUNNING":
                del self._preempted[sub_id]  # debt died with the job
                continue
            n = self._preempted[sub_id][-1]
            if self.dry_run:
                svc = None
            else:
                svc = self.services.add_train_worker(sub_id,
                                                     chips_per_trial=n)
            if svc is None and not self.dry_run:
                return None  # no chips yet; retry next quiet sweep
            self._preempted[sub_id].pop()
            if not self._preempted[sub_id]:
                del self._preempted[sub_id]
            wall, t0 = time.time(), time.monotonic()
            entry = {"epoch": self.epoch, "t": round(wall, 3),
                     "job": sub_id[:8], "bin": "",
                     "action": "regrow", "reason": "pressure_subsided",
                     "chips": n, "dry_run": self.dry_run,
                     "applied": not self.dry_run}
            self._record(entry, "regrow", "pressure_subsided", wall, t0)
            return entry
        return None

    def _active_train_worker(self, w: Dict[str, Any]) -> bool:
        svc = self.meta.get_service(w["service_id"])
        return svc is not None and svc["service_type"] == "TRAIN" and \
            svc["status"] in ("STARTED", "DEPLOYING", "RUNNING")

    # --- Recording -----------------------------------------------------

    def _record(self, entry: Dict[str, Any], action: str, reason: str,
                wall: float, t0: float) -> None:
        with self._lock:
            self._ring.append(entry)
        if self._m_actions is not None:
            # action/reason are a small fixed vocabulary; the whole
            # family is dropped by close()'s bare remove().
            self._m_actions.inc(action=action, reason=reason[:40])
        ctx = _trace.TraceContext(_trace.new_trace_id())
        _trace.record_event(f"autoscale.{action}", "autoscaler", [ctx],
                            wall, time.monotonic() - t0,
                            attrs={k: v for k, v in entry.items()
                                   if k in ("job", "bin", "reason",
                                            "target", "replicas",
                                            "chips", "dry_run")})
        entry["trace_id"] = ctx.trace_id

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /autoscale`` body."""
        with self._lock:
            decisions = list(self._ring)
        # dict()/list() copies are C-level (GIL-atomic): snapshot runs
        # on an HTTP handler thread while sweep() mutates on the
        # supervise thread, and a Python-level comprehension over the
        # live dicts could observe a resize mid-iteration.
        idle = dict(self._idle_train)
        preempted = {k: list(v)
                     for k, v in dict(self._preempted).items()}
        targets: Dict[str, Any] = {}
        for name, key in (("target", self._m_target),
                          ("actual", self._m_actual)):
            if key is None:
                continue
            for labels, v in key.samples():
                job = labels.get("job", "")
                targets.setdefault(job, {}).setdefault(
                    labels.get("bin", ""), {})[name] = int(v)
        return {
            "enabled": True,
            "dry_run": self.dry_run,
            "epoch": self.epoch,
            "knobs": dataclass_asdict(self.policy.knobs),
            "targets": targets,
            "idle_train_sweeps": idle,
            "preempted": preempted,
            "decisions": decisions[::-1],  # newest first for the UI
        }


def dataclass_asdict(obj) -> Dict[str, Any]:
    import dataclasses

    return dataclasses.asdict(obj)
