"""Predictor core of the port: scatter queries to an inference job's
workers over the bus, gather their replies, ensemble.

The port's copy of ``ensemble_predictions`` and of the reference's
``Predictor`` (``rafiki_tpu/predictor/predictor.py:62-1121``). The
predictor finds the job's workers in the bus registry and groups them
by the trial bin each serves: same-bin workers are replicas. With
replica sharding on (``shard_replicas``, the default) each bin's slice
of a batch is split over all its live replicas, sized inversely to each
one's latency EWMA; off, the whole batch goes to one replica a bin,
rotating. A shard still missing at the straggler deadline
(``_partial_wait``) is resubmitted once to a sibling and its replica
quarantined, for one gather timeout doubling with each consecutive
strike: it takes no shard meanwhile while its bin has another replica
(where the reference still sends it single-query batches). A shard
whose siblings all missed the same deadline is resubmitted to the first
of them that answers its own shard (where the reference leaves it
unanswered). A bin with no sibling loses its vote instead of stalling
the batch. Each query's
answer is the weighted ``ensemble_predictions`` over the bins that
replied; a query no bin answered comes back None. Shards bound for a
worker that advertises the packed wire ride one ``__ndbatch__`` frame,
unless ``RAFIKI_TPU_SERVING_PACKED_WIRE`` was ``off`` or ``compat`` when
the predictor was built.

Confidence tiering (``tier_threshold``, else
``RAFIKI_TPU_SERVING_TIER_THRESHOLD``; 0 = off): with several bins
serving and every bin's eval score known, a batch goes to the best bin
first; a query whose softmax margin there clears the threshold is
answered by that bin's vote alone (``short_circuit``), the others are
sent on to the remaining bins and answered by every bin's vote
(``escalate``). A bin without a score sends the whole batch to every
bin (``full``). Workers report each slice's device seconds; their
per-bin, per-query EWMA prices what a short circuit or a cache hit
saved (``estimate_query_cost``, ``estimate_hit_cost``). The tier and
avoided-seconds series exist only with tiering on.

With the attribution ledger on, each plan's per-bin query counts and
the batch's admission wait are accounted, and the batch's tenant mix
rides the shard frames (an escalation carries its own subset's mix,
from the per-query ``tenant_rows``).

On the cluster fabric (``RAFIKI_TPU_CLUSTER_FABRIC``, read when the
predictor is built) the predictor knows its node (``node``, else
``RAFIKI_TPU_NODE_ID``) and each worker's, from its registration: a
scatter or a resubmit sends another node's shards through the bus relay
(``Cache.send_query_shards`` with the node map), and with
``RAFIKI_TPU_CLUSTER_LOCALITY_BOOST`` above 1 a same-node replica's
weight in the split is multiplied by it. Off the fabric the node is ""
and every scatter is as before.

``predict_submit`` scatters now and returns the finisher that gathers,
which the micro-batcher's gather thread calls while its batcher thread
scatters the next batch.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..bus import BaseBus
from ..cache import WIRE_NDBATCH, Cache, PackedBatch, encode_payload
from ..observe import attribution as _attr
from ..observe import metrics as _metrics
from ..observe import trace as _trace
from ..observe import wire as _wire

_log = logging.getLogger(__name__)

#: EWMA smoothing of a replica's gather latency: ~5 replies dominate.
_LAT_ALPHA = 0.3

#: The fraction of the gather timeout spent waiting for primary shards
#: before a missing one is resubmitted to a sibling: the fallback, and
#: the ceiling, of the straggler deadline. When every planned replica
#: has a latency EWMA the deadline is ``_STRAGGLER_K`` times the
#: slowest one instead, so a fast fleet resubmits in milliseconds.
_RESUBMIT_AT = 0.5

#: A healthy reply lands within ~1x its replica's EWMA; 4x is a
#: straggler with room for jitter.
_STRAGGLER_K = 4.0

#: Floor of the latency-relative deadline (seconds): sub-millisecond
#: EWMAs would otherwise resubmit on scheduler noise.
_STRAGGLER_MIN = 0.025

#: Ceiling of the quarantine multiplier: a replica that missed N
#: consecutive probes sits out ``gather_timeout * min(2**(N-1), 16)``.
_QUARANTINE_MAX_MULT = 16

#: EWMA smoothing of a bin's device seconds a query, from the workers'
#: ``compute_s``.
_COST_ALPHA = 0.3

#: A query position whose bin shard never replied.
_HOLE = object()


class _Shard:
    """One slice of a batch bound for one replica."""

    __slots__ = ("worker", "bin", "start", "count", "shard_id",
                 "reply", "resubmitted", "t_sent", "pair", "superseded")

    def __init__(self, worker: str, bin_id: str, start: int, count: int):
        self.worker = worker
        self.bin = bin_id
        self.start = start
        self.count = count
        self.shard_id = uuid.uuid4().hex[:12]
        self.reply: Optional[Dict[str, Any]] = None
        self.resubmitted = False
        self.t_sent = 0.0  # monotonic scatter time (latency EWMA)
        # A resubmitted shard and its original cover the same slice;
        # the first to reply supersedes the other, so the gather stops
        # waiting once the slice is covered.
        self.pair: Optional["_Shard"] = None
        self.superseded = False

    def wire(self) -> Tuple[str, int, int, str]:
        return (self.worker, self.start, self.count, self.shard_id)


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


class _WirePayload:
    """One batch's outbound wire forms, each made on first demand: the
    packed buffer only when a plan targets a packed-capable worker, the
    per-query frames only for the other shards. The same payload
    follows the batch through its resubmits."""

    __slots__ = ("capable", "_queries", "_pre_encoded", "_encoded",
                 "_packed", "_packed_done")

    def __init__(self, queries: List[Any], pre_encoded: bool,
                 capable: frozenset):
        self.capable = capable
        self._queries = queries
        self._pre_encoded = pre_encoded
        self._encoded: Optional[List[Any]] = None
        self._packed: Optional[PackedBatch] = None
        self._packed_done = False

    @property
    def packed(self) -> Optional[PackedBatch]:
        """The contiguous batch buffer, or None when the queries do not
        pack (mixed shapes, non-arrays) or no worker takes it."""
        if not self._packed_done:
            self._packed_done = True
            if self.capable:
                self._packed = (
                    PackedBatch.from_encoded(self._queries)
                    if self._pre_encoded
                    else PackedBatch.from_arrays(self._queries))
        return self._packed

    @property
    def encoded(self) -> List[Any]:
        """Per-query wire frames, made once."""
        if self._encoded is None:
            if self._pre_encoded:
                self._encoded = self._queries
            else:
                _wire.count_copies("encode", sum(
                    1 for q in self._queries if isinstance(q, np.ndarray)))
                self._encoded = [encode_payload(q) for q in self._queries]
        return self._encoded

    def for_plan(self, plan: List[_Shard],
                 ) -> Tuple[Optional[List[Any]], Optional[PackedBatch]]:
        """``(encoded_queries, packed)`` for one plan, making only the
        forms its shards need."""
        any_packed = any(s.worker in self.capable for s in plan)
        packed = self.packed if any_packed else None
        enc = (self.encoded if packed is None or
               any(s.worker not in self.capable for s in plan)
               else None)
        return enc, packed

    def take(self, indices: List[int]) -> "_WirePayload":
        """The rows ``indices`` (the tiered escalation), keeping the
        forms already made."""
        sub = _WirePayload([self._queries[i] for i in indices],
                           self._pre_encoded, self.capable)
        if self._packed_done and self._packed is not None:
            sub._packed = self._packed.take(indices)
            sub._packed_done = True
        if self._encoded is not None:
            sub._encoded = [self._encoded[i] for i in indices]
        return sub


class Predictor:
    def __init__(self, inference_job_id: str, bus: BaseBus,
                 gather_timeout: float = 30.0,
                 worker_wait_timeout: float = 120.0,
                 shard_replicas: Optional[bool] = None,
                 service: Optional[str] = None,
                 tier_threshold: Optional[float] = None,
                 node: Optional[str] = None):
        self.inference_job_id = inference_job_id
        self.cache = Cache(bus)
        self.gather_timeout = gather_timeout
        self.worker_wait_timeout = worker_wait_timeout
        # An explicit argument, else RAFIKI_TPU_SERVING_TIER_THRESHOLD;
        # 0 turns tiering off (None).
        if tier_threshold is None:
            tier_threshold = float(os.environ.get(
                "RAFIKI_TPU_SERVING_TIER_THRESHOLD", "0") or 0)
        self.tier_threshold = tier_threshold if tier_threshold > 0 \
            else None
        # An explicit argument, else RAFIKI_TPU_SERVING_SHARD_REPLICAS,
        # else on.
        if shard_replicas is None:
            from ..config import _parse_bool

            shard_replicas = _parse_bool(os.environ.get(
                "RAFIKI_TPU_SERVING_SHARD_REPLICAS", "1"))
        self.shard_replicas = shard_replicas
        # The cluster fabric, read once: this frontend's node and the
        # same-node weight boost; off, "" and 1.0.
        from ..config import NodeConfig, cluster_fabric_enabled
        from ..constants import EnvVars

        fabric = cluster_fabric_enabled()
        self._node = ((node if node is not None else
                       os.environ.get(EnvVars.NODE_ID, "")) or "") \
            if fabric else ""
        self._locality_boost = float(os.environ.get(
            NodeConfig.env_name("cluster_locality_boost"), "1.0")
            or 1.0) if fabric else 1.0
        # worker_id -> its node from its registration ("" unknown).
        self._nodes: Dict[str, str] = {}
        self._rr = 0  # replica rotation
        # worker_id -> trial bin and -> takes the packed wire: fixed per
        # worker id, so read from the registry once.
        self._bins: Dict[str, str] = {}
        self._wire_ok: Dict[str, bool] = {}
        # Packing is read once (``RAFIKI_TPU_SERVING_PACKED_WIRE``):
        # "compat" and "off" keep every shard on per-query frames.
        self._packed_wire = _wire.packed_wire_mode() == "on"
        # bin -> eval score from its registration (the best bin), and
        # bin -> EWMA of its device seconds a query (the savings).
        self._bin_score: Dict[str, float] = {}
        self._bin_cost: Dict[str, float] = {}
        # The bins of the last plan: the serving-bin vector the edge
        # cache checks.
        self._last_bins: Optional[tuple] = None
        # worker_id -> EWMA of scatter -> reply seconds (the split).
        self._lat: Dict[str, float] = {}
        # worker_id -> monotonic time of its last penalty, and its
        # consecutive missed deadlines (reset only by a real reply).
        self._penalized: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}
        # Handler threads (batcher off) and the batcher's scatter
        # thread all plan through here.
        self._state_lock = threading.Lock()
        # The per-instance metrics label; a ServingStats owner passes
        # its own, so /metrics joins the serving and shard series.
        self.service = service or f"pred-{uuid.uuid4().hex[:8]}"
        self._m_shards = self._m_resubmits = None
        self._m_replica = self._m_quarantines = None
        self._m_tier = self._m_avoided = None
        if self.tier_threshold is not None and _metrics.metrics_enabled():
            reg = _metrics.registry()
            self._m_tier = reg.counter(
                "rafiki_tpu_serving_tier_total",
                "Per-query tiered-serving outcomes (outcome="
                "short_circuit|escalate|full)")
            self._m_avoided = reg.counter(
                "rafiki_tpu_serving_chip_seconds_avoided_total",
                "Estimated chip-seconds NOT spent thanks to a serving "
                "cut-through (source=cache|tier), from the per-bin "
                "compute-cost EWMA")
        if _metrics.metrics_enabled():
            reg = _metrics.registry()
            self._m_shards = reg.counter(
                "rafiki_tpu_serving_shards_total",
                "Shards scattered to replica workers")
            self._m_resubmits = reg.counter(
                "rafiki_tpu_serving_shard_resubmits_total",
                "Shards resubmitted to a sibling replica after their "
                "primary replica missed the partial-gather deadline")
            self._m_replica = reg.histogram(
                "rafiki_tpu_serving_replica_gather_seconds",
                "Per-replica scatter->reply latency (worker= short "
                "replica id)")
            self._m_quarantines = reg.counter(
                "rafiki_tpu_serving_replica_quarantines_total",
                "Replicas penalized out of the shard plan after a "
                "missed deadline (quarantine backs off exponentially "
                "per consecutive strike)")
        # The attribution ledger's per-bin frontend series live as long
        # as this predictor; close() drops them once.
        self._attr_closed = False
        _attr.open_owner()

    def close(self) -> None:
        """Drop this predictor's series from the registry (the label is
        per instance), the ledger's per-bin frontend series included."""
        for m in (self._m_shards, self._m_resubmits, self._m_replica,
                  self._m_quarantines, self._m_tier, self._m_avoided):
            if m is not None:
                m.remove(service=self.service)
        if not self._attr_closed:
            self._attr_closed = True
            _attr.close_service(self.service)

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

    def _bin_of(self, worker_id: str) -> str:
        """Caller holds ``_state_lock``."""
        bin_id = self._bins.get(worker_id)
        if bin_id is None:
            info = self.cache.bus.get(
                f"w:{self.inference_job_id}:{worker_id}") or {}
            bin_id = str(info.get("trial_id") or worker_id)
            self._bins[worker_id] = bin_id
            self._wire_ok[worker_id] = WIRE_NDBATCH in (
                info.get("wire") or ())
            self._nodes[worker_id] = str(info.get("node") or "")
            score = info.get("score")
            if isinstance(score, (int, float)):
                self._bin_score[bin_id] = float(score)
        return bin_id

    def _group_replicas(self) -> Tuple[Dict[str, List[str]], int,
                                       Dict[str, float]]:
        """The front half of every plan: wait for workers, drop the rows
        of departed ones (restarts churn ids), expire lapsed penalties,
        group live workers by bin and advance the rotation. Returns
        ``(groups, rr, latency snapshot)``."""
        workers = sorted(self._wait_workers())
        if not workers:
            return {}, 0, {}
        with self._state_lock:
            if len(self._bins) > 2 * len(workers) + 8:
                live = set(workers)
                for table in ("_bins", "_wire_ok", "_nodes", "_lat",
                              "_penalized", "_strikes"):
                    setattr(self, table,
                            {w: v for w, v in getattr(self, table).items()
                             if w in live})
            # A penalty past its quarantine is dropped with its EWMA: the
            # replica rejoins the plan on this probe; a still-dead one
            # strikes again and its next quarantine doubles.
            now = time.monotonic()
            for w in [w for w, t in self._penalized.items()
                      if now - t >= self._quarantine_s(w)]:
                del self._penalized[w]
                self._lat.pop(w, None)
            groups: Dict[str, List[str]] = {}
            for w in workers:
                groups.setdefault(self._bin_of(w), []).append(w)
            # Promotions retire bins: their score and cost rows go once
            # they clearly outnumber the live ones.
            if len(self._bin_score) + len(self._bin_cost) > \
                    4 * len(groups) + 16:
                self._bin_score = {b: v for b, v in self._bin_score.items()
                                   if b in groups}
                self._bin_cost = {b: v for b, v in self._bin_cost.items()
                                  if b in groups}
            self._rr += 1
            self._last_bins = tuple(sorted(groups))
            return groups, self._rr, dict(self._lat)

    @staticmethod
    def _rotate_pick(members: List[str], rr: int) -> str:
        return members[rr % len(members)]

    def _choose_workers(self) -> List[str]:
        """One worker a trial bin, rotating: asking every replica would
        weigh its trials twice."""
        groups, rr, _ = self._group_replicas()
        return [self._rotate_pick(members, rr)
                for _, members in sorted(groups.items())]

    def serving_vector(self) -> Optional[tuple]:
        """The bins of the last plan (sorted): a change means a
        promotion swapped a served bin, and cached answers are stale."""
        with self._state_lock:
            return self._last_bins

    def estimate_query_cost(self,
                            exclude_bin: Optional[str] = None) -> float:
        """Device seconds one full-ensemble query costs over the live
        bins (a bin not yet measured counts 0, a retired one never);
        ``exclude_bin`` leaves one out, which prices a short circuit."""
        with self._state_lock:
            live = self._last_bins
            return sum(v for b, v in self._bin_cost.items()
                       if b != exclude_bin
                       and (live is None or b in live))

    def estimate_hit_cost(self) -> float:
        """Device seconds one cache hit saved: the full ensemble's cost,
        or with tiering on the best bin's alone (the miss would most
        likely have short-circuited), unless a bin has no score."""
        with self._state_lock:
            live = self._last_bins
            costs = {b: v for b, v in self._bin_cost.items()
                     if live is None or b in live}
            if self.tier_threshold is not None and live and len(live) > 1:
                scores = {b: self._bin_score.get(b) for b in live}
                if all(v is not None for v in scores.values()):
                    best = max(sorted(scores), key=lambda b: scores[b])
                    return costs.get(best, 0.0)
            return sum(costs.values())

    def _quarantine_s(self, worker_id: str) -> float:
        """Caller holds ``_state_lock``. Seconds a penalized replica sits
        out before its next probe: one gather timeout at the first
        strike, doubling with each consecutive one, capped."""
        strikes = self._strikes.get(worker_id, 1)
        return self.gather_timeout * float(
            min(1 << max(0, strikes - 1), _QUARANTINE_MAX_MULT))

    def _note_latency(self, worker_id: str, seconds: float) -> None:
        if seconds < 0:
            return
        with self._state_lock:
            prev = self._lat.get(worker_id)
            self._lat[worker_id] = (seconds if prev is None else
                                    _LAT_ALPHA * seconds +
                                    (1.0 - _LAT_ALPHA) * prev)
            # A real reply proves the replica alive: its strikes reset.
            # Its penalty stays until the probe expiry, which drops the
            # poisoned EWMA with it.
            self._strikes.pop(worker_id, None)
        if self._m_replica is not None:
            self._m_replica.observe(seconds, service=self.service,
                                    worker=worker_id[:8])

    def _penalize(self, worker_id: str) -> None:
        """A shard timed out on this replica: inflate its EWMA so the
        next plans lean on its siblings, and strike it."""
        with self._state_lock:
            prev = self._lat.get(worker_id, self.gather_timeout)
            self._lat[worker_id] = max(prev * 2.0, self.gather_timeout)
            self._penalized[worker_id] = time.monotonic()
            self._strikes[worker_id] = \
                self._strikes.get(worker_id, 0) + 1
        if self._m_quarantines is not None:
            self._m_quarantines.inc(service=self.service)

    def _plan_for(self, n: int, groups: Dict[str, List[str]], rr: int,
                  lat: Dict[str, float]) -> List[_Shard]:
        """The shard plan. Sharding off, a bin of one replica, or one
        query: the bin's whole batch to one rotating pick. Otherwise the
        bin's batch is sliced over all its replicas, sized inversely to
        their latency EWMAs (even until measured); a replica whose
        slice rounds to zero is skipped.

        A quarantined replica sits out while its bin has another: the
        reference leaves it in the rotating pick and in the split, so a
        single-query batch (or a large one's small slice) still lands
        on it and waits out the fixed straggler deadline.

        With a locality boost above 1, a same-node replica's weight is
        multiplied by it: the latency EWMA still rules once the measured
        gap exceeds the boost."""
        nodes: Dict[str, str] = {}
        with self._state_lock:
            out = set(self._penalized)
            if self._node and self._locality_boost > 1.0:
                nodes = dict(self._nodes)
        plan: List[_Shard] = []
        for bin_id, members in sorted(groups.items()):
            members = [w for w in members if w not in out] or members
            if not self.shard_replicas or len(members) == 1 or n == 1:
                plan.append(_Shard(self._rotate_pick(members, rr),
                                   bin_id, 0, n))
                continue
            # Rotate, so equal weights spread the larger remainders
            # over the replicas across batches.
            k = rr % len(members)
            order = members[k:] + members[:k]
            known = [v for w in order
                     if (v := lat.get(w)) is not None and v > 0]
            default = sum(known) / len(known) if known else 1.0
            weights = [(self._locality_boost
                        if nodes.get(w) == self._node else 1.0)
                       / max(lat.get(w, default), 1e-6) for w in order]
            total_w = sum(weights)
            raw = [n * w / total_w for w in weights]
            sizes = [int(r) for r in raw]
            for i in sorted(range(len(order)),
                            key=lambda i: raw[i] - sizes[i],
                            reverse=True)[:n - sum(sizes)]:
                sizes[i] += 1
            start = 0
            for w, size in zip(order, sizes):
                if size > 0:
                    plan.append(_Shard(w, bin_id, start, size))
                    start += size
        return plan

    def _partial_wait(self, plan: List[_Shard]) -> float:
        """Seconds to wait for primary shards before resubmitting the
        missing ones: ``min(_RESUBMIT_AT x gather_timeout, _STRAGGLER_K
        x the slowest planned EWMA)`` when every planned replica has
        one, else the fixed fraction."""
        fixed = self.gather_timeout * _RESUBMIT_AT
        with self._state_lock:
            ewmas = [self._lat.get(s.worker) for s in plan]
        if any(v is None or v <= 0 for v in ewmas):
            return fixed
        return min(fixed, max(_STRAGGLER_K * max(ewmas), _STRAGGLER_MIN))

    def _match_reply(self, reply: Dict[str, Any],
                     plan: List[_Shard]) -> None:
        """Attach one gathered reply to its shard: by the echoed shard
        id, else (a worker that does not echo it) the first unanswered
        shard sent to that worker."""
        sid = reply.get("shard")
        shard = None
        if sid is not None:
            shard = next((s for s in plan if s.shard_id == sid), None)
        if shard is None and sid is None:
            wid = reply.get("worker_id")
            shard = next((s for s in plan
                          if s.worker == wid and s.reply is None), None)
        recv = reply.pop("_recv_mono", None)
        if recv is not None and shard is not None:
            self._note_latency(shard.worker, recv - shard.t_sent)
        if shard is not None and shard.reply is None:
            shard.reply = reply
            if shard.pair is not None:
                shard.pair.superseded = True
            # The worker's device seconds for the slice feed its bin's
            # per-query cost EWMA.
            compute_s = reply.get("compute_s")
            n_preds = len(reply.get("predictions") or ())
            if isinstance(compute_s, (int, float)) and compute_s >= 0 \
                    and n_preds:
                per_q = float(compute_s) / n_preds
                with self._state_lock:
                    prev = self._bin_cost.get(shard.bin)
                    self._bin_cost[shard.bin] = (
                        per_q if prev is None else
                        _COST_ALPHA * per_q + (1.0 - _COST_ALPHA) * prev)

    def predict_submit(self, queries: List[Any], *,
                       pre_encoded: bool = False,
                       trace_ctxs: Optional[List[Any]] = None,
                       tenants: Optional[List[Any]] = None,
                       tenant_rows: Optional[List[Optional[str]]] = None,
                       queue_wait_s: float = 0.0,
                       ) -> Callable[[], List[Optional[Any]]]:
        """Scatter a batch now, one bus frame a shard in one
        ``push_many``; returns the finisher that gathers and ensembles.
        ``pre_encoded`` says the queries are already bus frames (a
        request's body). ``trace_ctxs`` are the coalesced requests'
        trace contexts (the batcher's thread has none of its own).
        ``tenants`` (``[(tenant, n_queries), ...]``), ``tenant_rows``
        (a query's tenant, None where unattributed) and
        ``queue_wait_s`` (the batch's admission wait) feed the
        attribution ledger. With tiering on and several bins serving,
        the batch takes the tiered path (see the module docstring)."""
        n = len(queries)
        if not n:
            return lambda: []
        groups, rr, lat = self._group_replicas()
        if not groups:
            raise RuntimeError(f"no running inference workers for job "
                               f"{self.inference_job_id}")
        wire = self._build_wire(queries, pre_encoded, groups)
        if self.tier_threshold is not None and len(groups) > 1:
            best = self._best_bin(groups)
            if best is not None:
                return self._submit_tiered(
                    n, wire, groups, rr, lat, best, trace_ctxs,
                    tenants=tenants, tenant_rows=tenant_rows,
                    queue_wait_s=queue_wait_s)
            # A bin without a score: no basis for a best bin.
            self._count_tier("full", n)
        plan = self._plan_for(n, groups, rr, lat)
        batch_id = self._scatter(plan, wire, trace_ctxs, tenants=tenants,
                                 queue_wait_s=queue_wait_s)

        def finish() -> List[Optional[Any]]:
            self._gather_shards(batch_id, plan, groups, wire, trace_ctxs)
            return self._reassemble(n, plan)

        return finish

    def _build_wire(self, queries: List[Any], pre_encoded: bool,
                    groups: Dict[str, List[str]]) -> _WirePayload:
        capable: frozenset = frozenset()
        if self._packed_wire:
            with self._state_lock:
                capable = frozenset(w for members in groups.values()
                                    for w in members if self._wire_ok.get(w))
        return _WirePayload(queries, pre_encoded, capable)

    def _plan_nodes(self, plan: List[_Shard]) -> Optional[Dict[str, str]]:
        """The worker -> node map of one plan's scatter; None off the
        fabric (every frame takes the local broker)."""
        if not self._node:
            return None
        with self._state_lock:
            return {s.worker: self._nodes.get(s.worker, "") for s in plan}

    def _scatter(self, plan: List[_Shard], wire: _WirePayload,
                 trace_ctxs: Optional[List[Any]],
                 tenants: Optional[List[Any]] = None,
                 queue_wait_s: float = 0.0) -> str:
        """Stamp and send one plan; every scatter (full, tiered, an
        escalation) accounts its per-bin query counts here."""
        now = time.monotonic()
        for s in plan:
            s.t_sent = now
        enc, packed = wire.for_plan(plan)
        batch_id = self.cache.send_query_shards(
            [s.wire() for s in plan], enc, trace_ctxs=trace_ctxs,
            packed=packed, packed_ok=wire.capable, tenants=tenants,
            worker_nodes=self._plan_nodes(plan), local_node=self._node)
        if self._m_shards is not None:
            self._m_shards.inc(len(plan), service=self.service)
        bin_queries: Dict[str, int] = {}
        for s in plan:
            bin_queries[s.bin] = bin_queries.get(s.bin, 0) + s.count
        _attr.account_scatter(self.service, bin_queries,
                              queue_wait_s=queue_wait_s)
        return batch_id

    # --- Confidence tiering ---

    def _best_bin(self, groups: Dict[str, List[str]]) -> Optional[str]:
        """The bin with the highest eval score, or None unless every bin
        has one (a bin without a score might be the best)."""
        with self._state_lock:
            scores = {b: self._bin_score.get(b) for b in groups}
        if not scores or any(v is None for v in scores.values()):
            return None
        return max(sorted(scores), key=lambda b: scores[b])

    def _count_tier(self, outcome: str, n: int) -> None:
        if self._m_tier is not None and n:
            self._m_tier.inc(n, service=self.service, outcome=outcome)

    def _submit_tiered(self, n: int, wire: _WirePayload,
                       groups: Dict[str, List[str]], rr: int,
                       lat: Dict[str, float], best: str,
                       trace_ctxs: Optional[List[Any]],
                       tenants: Optional[List[Any]] = None,
                       tenant_rows: Optional[List[Optional[str]]] = None,
                       queue_wait_s: float = 0.0,
                       ) -> Callable[[], List[Optional[Any]]]:
        """The best bin first; the finisher sends the doubtful queries
        (no vote, no confidence, or a margin under the threshold) to the
        other bins as a second plan and merges their votes with the
        best bin's, so an escalated query has one vote a bin."""
        best_groups = {best: groups[best]}
        plan1 = self._plan_for(n, best_groups, rr, lat)
        batch1 = self._scatter(plan1, wire, trace_ctxs, tenants=tenants,
                               queue_wait_s=queue_wait_s)
        threshold = self.tier_threshold

        def finish() -> List[Optional[Any]]:
            wall, t0 = time.time(), time.monotonic()
            self._gather_shards(batch1, plan1, best_groups, wire,
                                trace_ctxs)
            rows1, weights1, confs1 = self._collect_rows(n, plan1)
            best_row = rows1.get(best)
            best_conf = confs1.get(best)
            best_w = weights1.get(best, 1)
            results: List[Optional[Any]] = [None] * n
            esc: List[int] = []
            for i in range(n):
                v = best_row[i] if best_row is not None else _HOLE
                c = best_conf[i] if best_conf is not None else None
                if v is _HOLE or c is None or c < threshold:
                    esc.append(i)
                else:
                    results[i] = ensemble_predictions([v],
                                                      weights=[best_w])
            short = n - len(esc)
            self._count_tier("short_circuit", short)
            self._count_tier("escalate", len(esc))
            if short and self._m_avoided is not None:
                avoided = short * self.estimate_query_cost(
                    exclude_bin=best)
                if avoided > 0:
                    self._m_avoided.inc(avoided, service=self.service,
                                        source="tier")
            if esc:
                other = {b: ms for b, ms in groups.items() if b != best}
                esc_wire = wire.take(esc)
                plan2 = self._plan_for(len(esc), other, rr, lat)
                # The escalation's own tenant mix, from the per-query
                # column.
                esc_tenants = None
                if tenant_rows:
                    merged: Dict[str, int] = {}
                    for i in esc:
                        t = tenant_rows[i] if i < len(tenant_rows) else None
                        if t:
                            merged[t] = merged.get(t, 0) + 1
                    if merged:
                        esc_tenants = sorted(
                            merged.items(), key=lambda kv: (-kv[1], kv[0]))
                batch2 = self._scatter(plan2, esc_wire, trace_ctxs,
                                       tenants=esc_tenants)
                self._gather_shards(batch2, plan2, other, esc_wire,
                                    trace_ctxs)
                rows2, weights2, _ = self._collect_rows(len(esc), plan2)
                ordered2 = sorted(rows2.items())
                for j, i in enumerate(esc):
                    votes: List[Any] = []
                    wts: List[int] = []
                    if best_row is not None and best_row[i] is not _HOLE:
                        votes.append(best_row[i])
                        wts.append(best_w)
                    for b, row in ordered2:
                        if row[j] is not _HOLE:
                            votes.append(row[j])
                            wts.append(weights2.get(b, 1))
                    results[i] = ensemble_predictions(votes, weights=wts)
            if trace_ctxs:
                _trace.record_event(
                    "predictor.tier", self.service, trace_ctxs, wall,
                    time.monotonic() - t0,
                    attrs={"short_circuit": short, "escalated": len(esc),
                           "best_bin": str(best)[:12]})
            return results

        return finish

    def _gather_shards(self, batch_id: str, plan: List[_Shard],
                       groups: Dict[str, List[str]], wire: _WirePayload,
                       trace_ctxs: Optional[List[Any]]) -> None:
        """Collect replies until every shard is matched or the gather
        timeout lapses. Shards still missing at the partial deadline
        that have a live sibling are resubmitted to it once. A sibling
        that missed the same deadline is no rescue until it answers its
        own shard: a shard whose siblings all missed waits for the first
        of them to answer and is resubmitted to it then (the reference
        leaves it unanswered, and its bin loses the vote, when the
        siblings are merely slow)."""
        t0 = time.monotonic()
        deadline = t0 + self.gather_timeout
        can_resubmit = any(len(groups.get(s.bin, ())) > 1 for s in plan)
        partial = (t0 + self._partial_wait(plan)
                   if can_resubmit else deadline)
        resubmitted = False
        held: List[_Shard] = []  # missing, every sibling missing too

        def resubmit(retries: List[_Shard]) -> None:
            nonlocal resubmitted
            resubmitted = True
            enc, packed = wire.for_plan(retries)
            self.cache.send_query_shards(
                [s.wire() for s in retries], enc, batch_id=batch_id,
                trace_ctxs=trace_ctxs, packed=packed,
                packed_ok=wire.capable,
                worker_nodes=self._plan_nodes(retries),
                local_node=self._node)
            plan.extend(retries)
            if self._m_resubmits is not None:
                self._m_resubmits.inc(len(retries), service=self.service)
            _log.warning("batch %s: %d shard(s) missing at partial "
                         "deadline; resubmitted to sibling replicas",
                         batch_id, len(retries))

        def retry_of(s: _Shard, pick: str) -> _Shard:
            retry = _Shard(pick, s.bin, s.start, s.count)
            retry.resubmitted = True
            retry.t_sent = time.monotonic()
            retry.pair = s
            s.pair = retry
            return retry

        def rescue(worker: Optional[str]) -> None:
            """A held shard goes to the first sibling that answers."""
            ready = [s for s in held if s.reply is None
                     and worker != s.worker
                     and worker in groups.get(s.bin, ())]
            if ready:
                for s in ready:
                    held.remove(s)
                resubmit([retry_of(s, worker) for s in ready])

        def drain(until: float) -> None:
            # One reply a pop: a bulk pop would wait out the timeout for
            # a superseded shard's reply that never comes.
            while True:
                pending = sum(1 for s in plan
                              if s.reply is None and not s.superseded)
                remaining = until - time.monotonic()
                if not pending or remaining <= 0:
                    return
                replies = self.cache.gather_prediction_batches(
                    batch_id, n_workers=1, timeout=remaining,
                    reap=False, timestamps=True)
                if not replies:
                    return
                for r in replies:
                    self._match_reply(r, plan)
                    if held:
                        rescue(r.get("worker_id"))

        drain(partial)
        missing = [s for s in plan if s.reply is None]
        if missing and can_resubmit:
            retries: List[_Shard] = []
            for s in missing:
                self._penalize(s.worker)
            # The latency snapshot after the penalties; a sibling that
            # missed the same deadline is not a rescue yet.
            with self._state_lock:
                lat = dict(self._lat)
            missing_workers = {s.worker for s in missing}
            for s in missing:
                members = [w for w in groups.get(s.bin, ())
                           if w != s.worker]
                siblings = [w for w in members if w not in missing_workers]
                if siblings:
                    retries.append(retry_of(
                        s, min(siblings, key=lambda w: lat.get(w, 1.0))))
                elif members:
                    held.append(s)
            if retries:
                resubmit(retries)
        drain(deadline)
        unmatched = [s for s in plan
                     if s.reply is None and not s.superseded]
        if unmatched:
            for s in unmatched:
                if not s.resubmitted:
                    self._penalize(s.worker)
            _log.warning("batch %s: %d/%d shards replied", batch_id,
                         len(plan) - len(unmatched), len(plan))
        # A straggler, or the slower of a resubmitted pair, may still
        # reply: the deferred sweep reaps the queue it recreates.
        self.cache.reap_reply_queue(
            batch_id, defer=bool(unmatched or resubmitted))

    def _collect_rows(self, n: int, plan: List[_Shard],
                      ) -> Tuple[Dict[str, List[Any]], Dict[str, int],
                                 Dict[str, List[Optional[float]]]]:
        """Matched replies as per-bin rows in request order (``_HOLE``
        where a shard never replied), each bin's weight, and each
        position's confidence (None where the reply carried none)."""
        rows: Dict[str, List[Any]] = {}
        confs: Dict[str, List[Optional[float]]] = {}
        bin_weight: Dict[str, int] = {}
        for s in plan:
            if s.reply is None:
                continue
            row = rows.get(s.bin)
            if row is None:
                row = rows[s.bin] = [_HOLE] * n
                confs[s.bin] = [None] * n
            crow = confs[s.bin]
            preds = s.reply.get("predictions") or []
            rconf = s.reply.get("confidence") or []
            for j in range(min(s.count, len(preds))):
                if row[s.start + j] is _HOLE:
                    row[s.start + j] = preds[j]
                    if j < len(rconf) and \
                            isinstance(rconf[j], (int, float)):
                        crow[s.start + j] = float(rconf[j])
            bin_weight[s.bin] = max(bin_weight.get(s.bin, 1),
                                    int(s.reply.get("weight", 1)))
        return rows, bin_weight, confs

    def _reassemble(self, n: int, plan: List[_Shard],
                    ) -> List[Optional[Any]]:
        """Ensemble across bins, query by query. A query whose bin shard
        never replied loses that bin's vote; one with no vote is None."""
        rows, bin_weight, _ = self._collect_rows(n, plan)
        results: List[Optional[Any]] = []
        ordered = sorted(rows.items())
        for i in range(n):
            votes = [(row[i], bin_weight[b]) for b, row in ordered
                     if row[i] is not _HOLE]
            results.append(ensemble_predictions(
                [v for v, _ in votes], weights=[w for _, w in votes]))
        return results

    def predict(self, queries: List[Any], *,
                pre_encoded: bool = False,
                tenants: Optional[List[Any]] = None,
                tenant_rows: Optional[List[Optional[str]]] = None,
                ) -> List[Optional[Any]]:
        """Scatter, gather and ensemble a batch (blocking)."""
        return self.predict_submit(queries, pre_encoded=pre_encoded,
                                   tenants=tenants,
                                   tenant_rows=tenant_rows)()
