"""Predictor core of the port: scatter queries to an inference job's
workers over the bus, gather their replies, ensemble.

The port's copy of ``ensemble_predictions`` and of the reference's
``Predictor`` (``rafiki_tpu/predictor/predictor.py:221``) without
replica sharding, resubmits, quarantine and confidence tiering: the
predictor finds the job's workers in the bus registry, groups them by
the trial bin each serves (same-bin workers are replicas, one picked a
request, rotating), sends one shard per bin with the whole batch, and
gathers the replies within ``gather_timeout``. Each query's answer is
the weighted ``ensemble_predictions`` over the bins that replied; a
query no bin answered comes back None. Shards bound for a worker that
advertises the packed wire ride one ``__ndbatch__`` frame.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..bus import BaseBus
from ..cache import WIRE_NDBATCH, Cache, PackedBatch, encode_payload


def ensemble_predictions(worker_predictions: List[Any],
                         weights: Optional[List[int]] = None) -> Any:
    """Combine one query's per-worker predictions.

    Numeric predictions (class probabilities, LM scores) → weighted
    elementwise mean. Non-numeric predictions → majority vote (one vote
    per worker, ``repr`` as the equality key), ties broken by arrival
    order. Error replies are skipped; ``__members__`` replies vote once
    per member.
    """
    pairs = []
    for i, p in enumerate(worker_predictions):
        if isinstance(p, dict) and "error" in p:
            continue
        if isinstance(p, dict) and "__members__" in p:
            pairs.extend((m, 1) for m in p["__members__"])
            continue
        pairs.append((p, weights[i] if weights else 1))
    if not pairs:
        return None
    preds = [p for p, _ in pairs]
    try:
        arr = np.asarray(preds, dtype=np.float64)
        if not np.isnan(arr).any():
            w = np.asarray([w for _, w in pairs], dtype=np.float64)
            return np.average(arr, axis=0, weights=w).tolist()
    except (ValueError, TypeError):
        pass
    counts: Counter = Counter()
    for p, w in pairs:
        counts[repr(p)] += int(w)
    winner = counts.most_common(1)[0][0]
    return next(p for p, _ in pairs if repr(p) == winner)


class Predictor:
    def __init__(self, inference_job_id: str, bus: BaseBus,
                 gather_timeout: float = 30.0,
                 worker_wait_timeout: float = 120.0):
        self.inference_job_id = inference_job_id
        self.cache = Cache(bus)
        self.gather_timeout = gather_timeout
        self.worker_wait_timeout = worker_wait_timeout
        self._rr = 0  # replica rotation
        # worker_id -> (trial bin, takes the packed wire): registration
        # info is fixed per worker id, so it is read once.
        self._info: Dict[str, Tuple[str, bool]] = {}
        self._lock = threading.Lock()

    def workers(self) -> List[str]:
        return self.cache.running_workers(self.inference_job_id)

    def _wait_workers(self) -> List[str]:
        """Workers register once their models are loaded; a query that
        arrives during the deploy waits instead of failing."""
        deadline = time.monotonic() + self.worker_wait_timeout
        while True:
            workers = self.workers()
            if workers or time.monotonic() >= deadline:
                return workers
            time.sleep(0.2)

    def _choose_workers(self) -> List[Tuple[str, str, bool]]:
        """``(worker, bin, packed_ok)``, one worker per trial bin:
        same-bin workers are replicas, and asking all of them would
        weigh their trials twice, so each request picks one, rotating."""
        workers = sorted(self._wait_workers())
        groups: Dict[str, List[str]] = {}
        with self._lock:
            if len(self._info) > 2 * len(workers) + 8:
                # Drop departed workers' rows (restarts churn ids).
                live = set(workers)
                self._info = {w: v for w, v in self._info.items()
                              if w in live}
            for w in workers:
                if w not in self._info:
                    info = self.cache.bus.get(
                        f"w:{self.inference_job_id}:{w}") or {}
                    self._info[w] = (str(info.get("trial_id") or w),
                                     WIRE_NDBATCH in (info.get("wire")
                                                      or ()))
                groups.setdefault(self._info[w][0], []).append(w)
            self._rr += 1
            picks = [members[self._rr % len(members)]
                     for _, members in sorted(groups.items())]
            return [(w, self._info[w][0], self._info[w][1]) for w in picks]

    def predict(self, queries: List[Any], *,
                pre_encoded: bool = False) -> List[Optional[Any]]:
        """Scatter, gather and ensemble a batch of queries.
        ``pre_encoded`` says the queries are already bus frames (a
        request's body), so nothing is decoded and encoded again."""
        n = len(queries)
        if not n:
            return []
        plan = self._choose_workers()
        if not plan:
            raise RuntimeError(f"no running inference workers for job "
                               f"{self.inference_job_id}")
        packed_ok = {w for w, _, ok in plan if ok}
        packed = None
        if packed_ok:
            packed = (PackedBatch.from_encoded(queries) if pre_encoded
                      else PackedBatch.from_arrays(queries))
        encoded = None
        if packed is None or len(packed_ok) < len(plan):
            encoded = (queries if pre_encoded
                       else [encode_payload(q) for q in queries])
        shards = {uuid.uuid4().hex[:12]: (w, b) for w, b, _ in plan}
        batch_id = self.cache.send_query_shards(
            [(w, 0, n, sid) for sid, (w, _) in shards.items()], encoded,
            packed=packed, packed_ok=packed_ok)
        replies = self.cache.gather_prediction_batches(
            batch_id, n_workers=len(plan), timeout=self.gather_timeout)
        rows: Dict[str, Tuple[List[Any], int]] = {}
        for r in replies:
            match = shards.get(r.get("shard"))
            if match is not None and match[1] not in rows:
                rows[match[1]] = (r.get("predictions") or [],
                                  int(r.get("weight", 1)))
        ordered = sorted(rows.items())
        out = []
        for i in range(n):
            votes = [(preds[i], w) for _, (preds, w) in ordered
                     if i < len(preds)]
            out.append(ensemble_predictions([v for v, _ in votes],
                                            weights=[w for _, w in votes]))
        return out
