"""Serving-path counters of one predictor frontend, in the metrics
registry.

The port's copy of ``ServingStats`` (``rafiki_tpu/observe/serving.py``):
how full the admission queue runs, how many requests each super-batch
coalesced, how long each stage (fill wait, scatter, gather) takes, and
how often backpressure fired. Every number lives in the process
registry under ``rafiki_tpu_serving_*``, labelled by the frontend's
per-instance ``service`` id, so ``GET /stats`` and ``GET /metrics``
read one source. ``snapshot`` has the reference's keys.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional

from . import metrics

_STAGES = ("fill", "scatter", "gather")


def _reg():
    r = metrics.registry()
    return {
        "requests": r.counter(
            "rafiki_tpu_serving_requests_total",
            "Requests admitted by the serving frontend"),
        "queries": r.counter(
            "rafiki_tpu_serving_queries_total",
            "Queries admitted by the serving frontend"),
        "rejected": r.counter(
            "rafiki_tpu_serving_rejected_total",
            "Requests bounced with 429 backpressure"),
        "backpressure": r.counter(
            "rafiki_tpu_serving_backpressure_total",
            "429 rejections split by reason "
            "(reason=queue_full|client_share)"),
        "batches": r.counter(
            "rafiki_tpu_serving_batches_total",
            "Super-batches dispatched"),
        "batched_requests": r.counter(
            "rafiki_tpu_serving_batched_requests_total",
            "Requests carried by dispatched super-batches"),
        "batched_queries": r.counter(
            "rafiki_tpu_serving_batched_queries_total",
            "Queries carried by dispatched super-batches"),
        "queue_depth": r.gauge(
            "rafiki_tpu_serving_queue_depth_queries",
            "Queries currently admitted and unsent"),
        "inflight": r.gauge(
            "rafiki_tpu_serving_inflight_batches",
            "Super-batches scattered but not yet gathered"),
        "stage": r.histogram(
            "rafiki_tpu_serving_stage_seconds",
            "Per-super-batch stage latency (stage=fill|scatter|gather)"),
        "fill_window": r.gauge(
            "rafiki_tpu_serving_fill_window_seconds",
            "Load-adaptive fill window the last super-batch filled "
            "under"),
    }


class ServingStats:
    """Thread-safe counters for one predictor frontend, backed by the
    process metrics registry under a per-instance ``service`` label.

    ``requests``/``queries`` count admissions; ``rejected`` counts
    backpressure 429s; ``batches``/``batched_requests``/``batched_queries``
    describe dispatched super-batches (their ratio is the coalescing
    factor); ``fill``/``scatter``/``gather`` land in the
    ``rafiki_tpu_serving_stage_seconds`` histogram;
    ``queue_depth``/``inflight`` are point-in-time gauges set by the
    batcher. Peaks and per-stage maxima are per-instance extras (a
    Prometheus gauge has no native peak), kept here for ``snapshot``.
    """

    def __init__(self, service: Optional[str] = None):
        # The label must be per-instance unique within the process, or
        # two frontends' series would merge in the registry and each
        # instance's snapshot would read the other's traffic.
        self.service = service or f"svc-{uuid.uuid4().hex[:8]}"
        self._m = _reg()
        self._lock = threading.Lock()
        self.queue_depth_peak = 0
        self.inflight_peak = 0
        self._stage_max: Dict[str, float] = {s: 0.0 for s in _STAGES}

    # --- Registry-backed reads ---

    def _count(self, key: str) -> int:
        return int(self._m[key].value(service=self.service))

    @property
    def requests(self) -> int:
        return self._count("requests")

    @property
    def queries(self) -> int:
        return self._count("queries")

    @property
    def rejected(self) -> int:
        return self._count("rejected")

    @property
    def batches(self) -> int:
        return self._count("batches")

    @property
    def batched_requests(self) -> int:
        return self._count("batched_requests")

    @property
    def batched_queries(self) -> int:
        return self._count("batched_queries")

    @property
    def queue_depth(self) -> int:
        return self._count("queue_depth")

    @property
    def inflight(self) -> int:
        return self._count("inflight")

    # --- Admission ---

    def admitted(self, n_queries: int) -> None:
        self._m["requests"].inc(service=self.service)
        self._m["queries"].inc(n_queries, service=self.service)

    def backpressured(self, reason: str = "queue_full") -> None:
        self._m["rejected"].inc(service=self.service)
        self._m["backpressure"].inc(service=self.service, reason=reason)

    def set_queue_depth(self, n_queries: int) -> None:
        self._m["queue_depth"].set(n_queries, service=self.service)
        with self._lock:
            self.queue_depth_peak = max(self.queue_depth_peak, n_queries)

    # --- Super-batch lifecycle ---

    def dispatched(self, n_requests: int, n_queries: int,
                   fill_s: float, scatter_s: float,
                   inflight: Optional[int] = None,
                   fill_window: Optional[float] = None) -> None:
        self._m["batches"].inc(service=self.service)
        self._m["batched_requests"].inc(n_requests, service=self.service)
        self._m["batched_queries"].inc(n_queries, service=self.service)
        self._observe_stage("fill", fill_s)
        self._observe_stage("scatter", scatter_s)
        if fill_window is not None:
            self._m["fill_window"].set(fill_window, service=self.service)
        if inflight is not None:
            self._m["inflight"].set(inflight, service=self.service)
            with self._lock:
                self.inflight_peak = max(self.inflight_peak, inflight)

    def gathered(self, gather_s: float,
                 inflight: Optional[int] = None) -> None:
        self._observe_stage("gather", gather_s)
        if inflight is not None:
            self._m["inflight"].set(inflight, service=self.service)

    def _observe_stage(self, stage: str, seconds: float) -> None:
        self._m["stage"].observe(seconds, service=self.service,
                                 stage=stage)
        with self._lock:
            self._stage_max[stage] = max(self._stage_max[stage], seconds)

    def close(self) -> None:
        """Drop this frontend's series from the shared registry. The
        label is per-instance, so a long-lived resident runner that
        deploys/stops predictors repeatedly would otherwise grow the
        registry (and every /metrics payload) one label set per
        deployment, forever."""
        for m in self._m.values():
            m.remove(service=self.service)

    # --- Reporting ---

    def _stage_snapshot(self, stage: str) -> Dict[str, float]:
        hist = self._m["stage"]
        count = hist.count(service=self.service, stage=stage)
        total = hist.sum(service=self.service, stage=stage)
        with self._lock:  # written under _lock by _observe_stage
            stage_max = self._stage_max[stage]

        def ms(v: Optional[float]) -> float:
            return round(v * 1e3, 3) if v is not None else 0.0

        return {
            "count": count,
            "mean_ms": ms(total / count) if count else 0.0,
            "max_ms": ms(stage_max),
            "p50_ms": ms(hist.percentile(0.5, service=self.service,
                                         stage=stage)) if count else 0.0,
            "p95_ms": ms(hist.percentile(0.95, service=self.service,
                                         stage=stage)) if count else 0.0,
        }

    def snapshot(self) -> Dict[str, object]:
        batches = self.batches
        batched_requests = self.batched_requests
        batched_queries = self.batched_queries
        with self._lock:  # peaks are written under _lock
            queue_depth_peak = self.queue_depth_peak
            inflight_peak = self.inflight_peak
        return {
            "service": self.service,
            "requests": self.requests,
            "queries": self.queries,
            "rejected": self.rejected,
            "batches": batches,
            "batched_requests": batched_requests,
            "batched_queries": batched_queries,
            # requests folded into each super-batch on average: 1.0
            # = no cross-request coalescing happened, N = N requests
            # rode one scatter-gather.
            "coalescing_factor": round(batched_requests / batches, 3)
            if batches else None,
            "mean_batch_queries": round(batched_queries / batches, 2)
            if batches else None,
            "rejected_by_reason": {
                labels["reason"]: int(v)
                for labels, v in self._m["backpressure"].samples()
                if labels.get("service") == self.service},
            "queue_depth": self.queue_depth,
            "queue_depth_peak": queue_depth_peak,
            "inflight": self.inflight,
            "inflight_peak": inflight_peak,
            # The last dispatched super-batch's adaptive fill window
            # (seconds) — converges toward the max under load, the min
            # under trickle.
            "fill_window_s": self._m["fill_window"].value(
                service=self.service),
            "fill": self._stage_snapshot("fill"),
            "scatter": self._stage_snapshot("scatter"),
            "gather": self._stage_snapshot("gather"),
        }


__all__: List[str] = ["ServingStats"]
