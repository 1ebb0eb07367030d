"""SLO engine: objective evaluation and burn-rate alerting on the
supervise sweep.

The port's copy of ``rafiki_tpu/admin/slo_engine.py``. One ``sweep()``
a supervise pass reads each RUNNING inference job's predictor
``/metrics`` (``admin/scrape.py``), joined with every worker's
advertised exposition, folds each sweep's event deltas into each
objective's window ring (``observe/slo.py``), publishes
``rafiki_tpu_slo_budget_remaining_ratio``, ``rafiki_tpu_slo_burn_rate``
and ``rafiki_tpu_slo_worker_scrape_ratio``, and advances each
instance's alert machine.

Each alert transition is counted (``rafiki_tpu_slo_alerts_total{objective,
state}``), traced (a ``slo.<transition>`` span), kept in a bounded ring
(``GET /alerts``), appended to ``<logs>/alerts.jsonl`` (rolled once to
``.1`` at ``slo_alert_log_mb``) and, with ``RAFIKI_TPU_SLO_WEBHOOK_URL``
set, posted by one sender thread.

The autoscaler reads ``slo_pressure`` each sweep: a firing latency
objective is scale-up pressure for its job, ahead of the queue signals.

Off (no ``RAFIKI_TPU_SLO_RULES``, the default) no engine exists:
supervise pays one attribute check and no ``rafiki_tpu_slo_*`` series
exists.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..observe import metrics as _metrics
from ..observe import slo as _slo
from ..observe import trace as _trace

_log = logging.getLogger(__name__)

#: Alert transitions kept for ``GET /alerts`` (a UI/debug surface, not
#: a log — the JSONL sink is the durable record).
_RING_CAP = 256

#: Instances whose source labels vanish (promotion churn, tenant LRU
#: eviction, job stop) are pruned — and their gauges removed — after
#: this many slow windows of silence.
_PRUNE_AFTER_WINDOWS = 2.0

ALERT_LOG_FILE = "alerts.jsonl"


class SloEngine:
    """Scrape → evaluate → alert, one ``sweep()`` per supervise pass.

    Constructed only when ``RAFIKI_TPU_SLO_RULES`` names at least one
    objective (LocalPlatform); ``ServicesManager.supervise`` holds a
    plain ``slo_engine`` attribute that is None otherwise.
    """

    def __init__(self, services, meta,
                 objectives: List[_slo.Objective],
                 webhook_url: str = "",
                 alert_log_mb: float = 16.0):
        self.services = services
        self.meta = meta
        self.objectives = list(objectives)
        self.webhook_url = webhook_url
        self.alert_log_mb = alert_log_mb
        self.epoch = 0
        # (job_id, objective name, instance label tuple) -> Instance
        self._instances: Dict[Tuple, _slo.Instance] = {}
        # job_id -> (serving service label, http service label) memo.
        self._labels: Dict[str, Tuple[str, str]] = {}
        self._lock = threading.Lock()
        self._ring: "collections.deque" = collections.deque(
            maxlen=_RING_CAP)
        # Webhook deliveries ride a single daemon sender thread with a
        # bounded queue (oldest dropped on overflow — best-effort by
        # contract): a slow/unreachable pager must not stall the
        # supervise thread 2 s per transition during exactly the
        # incident window the sweep is supposed to be reacting to.
        self._webhook_q: "collections.deque" = collections.deque(
            maxlen=64)
        self._webhook_wake = threading.Event()
        self._webhook_thread: Optional[threading.Thread] = None
        self._closed = False
        # job_id -> last sweep's worker-scrape coverage accounting
        # (advertised/fetched/failed/silent) — the /status and test
        # surface behind the coverage gauge.
        self.scrape_coverage: Dict[str, Dict[str, int]] = {}
        self._m_budget = self._m_burn = self._m_alerts = None
        self._m_scrape = None
        if _metrics.metrics_enabled():
            reg = _metrics.registry()
            self._m_scrape = reg.gauge(
                "rafiki_tpu_slo_worker_scrape_ratio",
                "Fraction of a job's metrics-advertising workers whose "
                "exposition the SLO sweep actually merged (1 = full "
                "bin-scope visibility; < 1 = objectives are judging "
                "partial data, NOT proof of health)")
            self._m_budget = reg.gauge(
                "rafiki_tpu_slo_budget_remaining_ratio",
                "Error budget left in each objective's rolling window "
                "(1 = untouched, 0 = exhausted), per objective "
                "instance")
            self._m_burn = reg.gauge(
                "rafiki_tpu_slo_burn_rate",
                "Error-budget burn rate per objective instance and "
                "window (fast|slow); 1 = burning the budget exactly "
                "at the window's pace")
            self._m_alerts = reg.counter(
                "rafiki_tpu_slo_alerts_total",
                "Alert state transitions per objective (state="
                "pending|firing|resolved|cleared)")

    @classmethod
    def from_env(cls, services, meta) -> "SloEngine":
        """Build from the env knobs ``NodeConfig.apply_env`` exported
        (the platform composition path; tests construct directly)."""
        objectives = _slo.rules_from_env()
        try:
            log_mb = float(os.environ.get(
                "RAFIKI_TPU_SLO_ALERT_LOG_MB", "16") or 16)
        except ValueError:
            log_mb = 16.0
        return cls(services, meta, objectives,
                   webhook_url=os.environ.get(
                       "RAFIKI_TPU_SLO_WEBHOOK_URL", "").strip(),
                   alert_log_mb=log_mb)

    def close(self) -> None:
        """Drop every SLO series (objective/job/bin/tenant labels churn
        with deployments; a stopped engine must not leak them into
        every future scrape) and stop the webhook sender."""
        self._closed = True
        self._webhook_wake.set()
        t = self._webhook_thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        for m in (self._m_budget, self._m_burn, self._m_alerts,
                  self._m_scrape):
            if m is not None:
                m.remove()

    # --- The sweep ----------------------------------------------------

    def sweep(self, scrapes=None) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the alert transitions recorded.
        Runs on the supervise thread — everything here is best-effort
        and must not raise into the sweep. ``scrapes`` is the
        sweep-shared :class:`~rafiki_torch.admin.scrape.ScrapeCache`
        (the autoscaler consumes the same endpoints right after this
        on the same pass); None fetches directly."""
        self.epoch += 1
        now = time.monotonic()
        transitions: List[Dict[str, Any]] = []
        jobs = self.meta.get_inference_jobs(status="RUNNING")
        live_ids = {j["id"] for j in jobs}
        for job in jobs:
            text = self._job_exposition(job, scrapes=scrapes)
            if text is None:
                continue
            metrics = _metrics.parse_exposition(text)
            for obj in self.objectives:
                if obj.job and not job["id"].startswith(obj.job):
                    continue
                transitions.extend(
                    self._evaluate_objective(job["id"], obj, metrics,
                                             now))
        self._prune(now, live_ids)
        return transitions

    def _job_exposition(self, job: Dict[str, Any],
                        scrapes=None) -> Optional[str]:
        """The job's predictor ``/metrics`` text (+ a one-time
        ``/stats`` label resolve), concatenated with every worker-
        advertised metrics exposition. None = skip this job this sweep.

        Under process runners the worker-owned families
        (``rafiki_tpu_serving_bin_device_seconds``) live in each worker
        process's registry, not the frontend's — workers that bound a
        metrics server advertise its address in their bus registration
        (``metrics`` key), and the concatenation is safe because
        frontend- and worker-owned families never share a name+label
        set. Worker fetch failures degrade to frontend-only (a dead
        worker must not blind the whole job's objectives)."""
        host = job.get("predictor_host")
        if not host:
            return None
        fetch = scrapes.fetch if scrapes is not None else self._scrape
        try:
            if job["id"] not in self._labels:
                stats = fetch(host, "/stats")
                self._labels[job["id"]] = (
                    stats.get("service") or "",
                    stats.get("http_service") or "")
            text = fetch(host, "/metrics")
        except (OSError, ValueError):
            self._labels.pop(job["id"], None)  # re-resolve on restart
            return None
        from .scrape import merge_worker_expositions, \
            worker_scrape_targets

        by_node, silent = worker_scrape_targets(self.services,
                                                job["id"])
        worker_text, fetched, failed = merge_worker_expositions(
            fetch, by_node)
        if worker_text:
            text += "\n" + worker_text
        advertised = fetched + failed
        self.scrape_coverage[job["id"]] = {
            "advertised": advertised, "fetched": fetched,
            "failed": failed, "silent": silent}
        if self._m_scrape is not None:
            # 1.0 when nothing advertises: resident-runner workers'
            # series already live in this process's registry, so the
            # frontend scrape IS full coverage.
            self._m_scrape.set(
                fetched / advertised if advertised else 1.0,
                job=job["id"])
        if failed:
            _log.warning(
                "slo sweep: job %s worker scrape incomplete (%d/%d "
                "advertised endpoints merged) — bin-scoped objectives "
                "are judging partial data", job["id"][:8], fetched,
                advertised)
        return text

    def _scrape(self, host: str, path: str) -> Any:
        from .scrape import fetch_endpoint

        return fetch_endpoint(host, path)

    # --- Objective evaluation -----------------------------------------

    def _evaluate_objective(self, job_id: str, obj: _slo.Objective,
                            metrics: Dict[str, Any], now: float,
                            ) -> List[Dict[str, Any]]:
        """Fold one job's scrape into every instance this objective
        spawns there (one for job scope; one per observed bin/tenant
        label otherwise) and advance their alert machines."""
        service, http_service = self._labels.get(job_id, ("", ""))
        snapshots = self._instance_snapshots(job_id, obj, metrics,
                                             service, http_service)
        out: List[Dict[str, Any]] = []
        for labels, snapshot in snapshots:
            key = (job_id, obj.name, tuple(sorted(labels.items())))
            with self._lock:
                inst = self._instances.get(key)
                if inst is None:
                    inst = _slo.Instance.create(obj, labels)
                    self._instances[key] = inst
            good, total = self._deltas(obj, inst, snapshot)
            inst.prev = snapshot
            if good is None:
                inst.last_seen = now  # basis sweep: seen, not judged
                continue
            transition = inst.evaluate(now, good, total)
            self._publish(inst)
            if transition is not None:
                out.append(self._record(job_id, inst, transition))
        return out

    def _instance_snapshots(self, job_id: str, obj: _slo.Objective,
                            metrics: Dict[str, Any], service: str,
                            http_service: str,
                            ) -> List[Tuple[Dict[str, str], Any]]:
        """``[(instance labels, cumulative snapshot), ...]`` for one
        objective against one scrape. Latency snapshots are per-le
        cumulative bucket counts; ratio snapshots are (good, bad)
        counter totals."""
        jid = job_id[:8]
        if obj.otype == "ratio":
            good = self._counter_total(
                metrics, _slo.CONSUMED_SERIES[("ratio", "good")],
                service=service)
            bad = self._counter_total(
                metrics, _slo.CONSUMED_SERIES[("ratio", "bad")],
                service=service)
            return [({"job": jid}, (good, bad))]
        name = obj.source_metric() + "_bucket"
        samples = metrics.get(name, [])
        if obj.scope == "job":
            match = {"service": http_service, "route": obj.route}
            return [({"job": jid},
                     self._bucket_cum(samples, match))]
        group_label = "bin" if obj.scope == "bin" else "tenant"
        groups: Dict[str, Dict[float, int]] = {}
        for labels, value in samples:
            if obj.scope == "bin" and \
                    labels.get("job") != job_id[:12]:
                continue
            if obj.scope == "tenant" and \
                    labels.get("service") != service:
                # The tenant histogram carries the frontend's service
                # label precisely so that co-resident frontends of
                # OTHER jobs (one shared process registry) don't fold
                # their tenants into this job's instances — a breach
                # caused by job A must not fire (and scale) job B.
                continue
            gval = labels.get(group_label)
            if gval is None:
                continue
            le = labels.get("le")
            if le is None:
                continue
            bound = float("inf") if le == "+Inf" else float(le)
            cum = groups.setdefault(gval, {})
            cum[bound] = cum.get(bound, 0) + int(value)
        return [({"job": jid, group_label: gval}, cum)
                for gval, cum in sorted(groups.items())]

    @staticmethod
    def _counter_total(metrics: Dict[str, Any], name: str,
                       **match: str) -> float:
        return sum(v for labels, v in metrics.get(name, [])
                   if all(labels.get(k) == str(mv)
                          for k, mv in match.items()))

    @staticmethod
    def _bucket_cum(samples: List[Tuple[Dict[str, str], float]],
                    match: Dict[str, str]) -> Dict[float, int]:
        cum: Dict[float, int] = {}
        for labels, value in samples:
            if any(labels.get(k) != str(v) for k, v in match.items()):
                continue
            le = labels.get("le")
            if le is None:
                continue
            bound = float("inf") if le == "+Inf" else float(le)
            cum[bound] = cum.get(bound, 0) + int(value)
        return cum

    def _deltas(self, obj: _slo.Objective, inst: _slo.Instance,
                snapshot: Any) -> Tuple[Optional[float], float]:
        """One sweep's (good, total) event deltas from the cumulative
        snapshots. ``(None, 0)`` on the basis sweep — a judge must
        never act on totals it cannot attribute to a time window. A
        counter RESET (restarted frontend/worker: any cumulative value
        moved backward) re-bases instead of folding a huge negative."""
        prev = inst.prev
        if prev is None:
            return None, 0.0
        if obj.otype == "ratio":
            good_d = snapshot[0] - prev[0]
            bad_d = snapshot[1] - prev[1]
            if good_d < 0 or bad_d < 0:
                return None, 0.0
            return good_d, good_d + bad_d
        deltas = []
        for bound in sorted(snapshot):
            d = snapshot[bound] - prev.get(bound, 0)
            if d < 0:
                return None, 0.0
            deltas.append((bound, d))
        return _slo.good_total_from_deltas(deltas,
                                           obj.threshold_ms / 1e3)

    # --- Publication ---------------------------------------------------

    def _publish(self, inst: _slo.Instance) -> None:
        if self._m_budget is None:
            return
        labels = {"objective": inst.objective.name, **inst.labels}
        self._m_budget.set(round(inst.budget_remaining, 6), **labels)
        self._m_burn.set(round(inst.burn_fast, 6), window="fast",
                         **labels)
        self._m_burn.set(round(inst.burn_slow, 6), window="slow",
                         **labels)

    def _drop_gauges(self, inst: _slo.Instance) -> None:
        if self._m_budget is None:
            return
        labels = {"objective": inst.objective.name, **inst.labels}
        self._m_budget.remove(**labels)
        self._m_burn.remove(**labels)

    def _record(self, job_id: str, inst: _slo.Instance,
                transition: str) -> Dict[str, Any]:
        wall, t0 = time.time(), time.monotonic()
        entry: Dict[str, Any] = {
            "epoch": self.epoch, "t": round(wall, 3),
            "objective": inst.objective.name,
            "labels": dict(inst.labels),
            "transition": transition,
            "state": inst.machine.state,
            "burn_fast": round(inst.burn_fast, 4),
            "burn_slow": round(inst.burn_slow, 4),
            "budget_remaining": round(inst.budget_remaining, 4),
            "job_id": job_id[:8],
        }
        with self._lock:
            self._ring.append(entry)
        if self._m_alerts is not None:
            # transition is the fixed TRANSITIONS vocabulary; the whole
            # family is dropped by close()'s bare remove().
            self._m_alerts.inc(objective=inst.objective.name,
                               state=transition)
        ctx = _trace.TraceContext(_trace.new_trace_id())
        _trace.record_event(
            f"slo.{transition}", "slo", [ctx], wall,
            time.monotonic() - t0,
            attrs={k: entry[k] for k in
                   ("objective", "labels", "burn_fast", "burn_slow",
                    "budget_remaining", "job_id")})
        entry["trace_id"] = ctx.trace_id
        self._sink(entry)
        return entry

    def _sink(self, entry: Dict[str, Any]) -> None:
        """Best-effort external fan-out: the JSONL alert log (bounded:
        rolls once to ``.1`` at the size cap) and, when configured, one
        short-timeout webhook POST. Neither may fail the sweep."""
        log_dir = getattr(self.services, "log_dir", "")
        if log_dir:
            path = os.path.join(log_dir, ALERT_LOG_FILE)
            try:
                os.makedirs(log_dir, exist_ok=True)
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(entry, separators=(",", ":"))
                            + "\n")
                    if f.tell() > self.alert_log_mb * 1024 * 1024:
                        roll = True
                    else:
                        roll = False
                if roll:
                    os.replace(path, path + ".1")
            except OSError:
                _log.warning("alert log write failed", exc_info=True)
        if self.webhook_url and not self._closed:
            self._webhook_q.append(dict(entry))
            self._webhook_wake.set()
            if self._webhook_thread is None or \
                    not self._webhook_thread.is_alive():
                self._webhook_thread = threading.Thread(
                    target=self._webhook_loop, name="slo-webhook",
                    daemon=True)
                self._webhook_thread.start()

    def _webhook_loop(self) -> None:
        """Drain queued alert transitions to the webhook, one POST at
        a time off the supervise thread (2 s timeout each; failures
        logged, never retried — the JSONL sink is the durable
        record)."""
        from urllib.request import Request, urlopen

        while not self._closed:
            try:
                entry = self._webhook_q.popleft()
            except IndexError:
                self._webhook_wake.wait(timeout=1.0)
                self._webhook_wake.clear()
                continue
            try:
                req = Request(
                    self.webhook_url,
                    data=json.dumps(entry).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urlopen(req, timeout=2) as resp:
                    resp.read()
            except OSError:
                _log.warning("alert webhook %s failed",
                             self.webhook_url, exc_info=True)

    def _prune(self, now: float, live_job_ids) -> None:
        """Drop instances whose job departed or whose source labels
        went silent (promotion churn, tenant LRU eviction) — and their
        gauges with them, so churn can never grow the scrape."""
        dropped: List[_slo.Instance] = []
        with self._lock:
            for key in list(self._instances):
                job_id, _name, _labels = key
                inst = self._instances[key]
                stale = now - inst.last_seen > \
                    _PRUNE_AFTER_WINDOWS * max(inst.objective.slow_s,
                                               inst.objective.window_s)
                if job_id not in live_job_ids or stale:
                    dropped.append(inst)
                    del self._instances[key]
        for inst in dropped:
            self._drop_gauges(inst)
        for job_id in [j for j in self._labels
                       if j not in live_job_ids]:
            del self._labels[job_id]
        for job_id in [j for j in self.scrape_coverage
                       if j not in live_job_ids]:
            del self.scrape_coverage[job_id]
            if self._m_scrape is not None:
                self._m_scrape.remove(job=job_id)

    # --- Consumers -----------------------------------------------------

    def slo_pressure(self, job_id: str) -> Optional[str]:
        """The autoscaler's pressure signal: the violating BIN label of
        a firing bin-scoped latency objective for this job, ``""`` for
        a firing job/tenant-scoped one, None when nothing fires.
        Deterministic: bin-scoped alerts win (they name a target), then
        objective-name order."""
        with self._lock:
            items = sorted(self._instances.items())
        best: Optional[str] = None
        for (jid, _name, _labels), inst in items:
            if jid != job_id or inst.machine.state != "firing" or \
                    inst.objective.otype != "latency":
                continue
            bin_label = inst.labels.get("bin")
            if bin_label:
                return bin_label
            if best is None:
                best = ""
        return best

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /slo`` body: every objective with its live
        instances (burn rates, budget bars, alert states)."""
        with self._lock:
            items = sorted(self._instances.items())
        instances: Dict[str, List[Dict[str, Any]]] = {}
        for (_job_id, name, _labels), inst in items:
            instances.setdefault(name, []).append({
                "labels": dict(inst.labels),
                "state": inst.machine.state,
                "burn_fast": round(inst.burn_fast, 4),
                "burn_slow": round(inst.burn_slow, 4),
                "budget_remaining": round(inst.budget_remaining, 4),
                "good": round(inst.good, 1),
                "total": round(inst.total, 1),
            })
        objectives = []
        for obj in self.objectives:
            spec = {"name": obj.name, "type": obj.otype,
                    "target": obj.target, "scope": obj.scope,
                    "window_s": obj.window_s, "fast_s": obj.fast_s,
                    "slow_s": obj.slow_s, "burn": obj.burn,
                    "for_s": obj.for_s, "resolve_s": obj.resolve_s}
            if obj.otype == "latency":
                spec["threshold_ms"] = obj.threshold_ms
            objectives.append({**spec,
                               "instances": instances.get(obj.name,
                                                          [])})
        return {"enabled": True, "epoch": self.epoch,
                "objectives": objectives}

    def alerts_snapshot(self) -> Dict[str, Any]:
        """The ``GET /alerts`` body (transition ring, newest first)."""
        with self._lock:
            ring = list(self._ring)
            firing = sorted({inst.objective.name
                             for inst in self._instances.values()
                             if inst.machine.state == "firing"})
        return {"enabled": True, "epoch": self.epoch,
                "firing": firing, "alerts": ring[::-1]}
