"""Continuous cross-request micro-batching for the serving frontend.

The port's copy of ``Backpressure``, ``_Request`` and ``MicroBatcher``
(``rafiki_tpu/predictor/batcher.py:65-505``): one shared admission
queue between the HTTP handlers and the ``Predictor``.

- **Coalescing.** Requests arriving within one fill window (or up to
  ``max_batch`` queries) ride one scatter-gather super-batch; each
  request's slice comes back to its handler.
- **Keep-N-in-flight.** Super-batch K+1 is filled and scattered while
  K's gather still waits: a batcher thread scatters, a gather thread
  completes batches in dispatch order, at most ``max_inflight``
  scattered and ungathered.
- **Backpressure.** The queue is bounded in queries; past
  ``queue_cap`` ``submit`` raises ``Backpressure`` at once and the HTTP
  route answers 429 with ``Retry-After``.
- **Adaptive fill window.** The window follows an EWMA of the time
  between arrivals: near ``fill_window_min`` under a trickle, where
  waiting would only add latency, opening toward ``fill_window_max``
  as arrivals tighten. ``fill_window_min == fill_window_max`` pins it.
- **Per-client fairness.** With ``client_share`` and a client key from
  the caller, one client holds at most that share of the queue.

Counters ride ``observe.ServingStats``; the ``predictor.scatter`` and
``predictor.gather`` spans ride ``observe.trace``. A request's hashed
tenant and its admission time go with it: at dispatch its wait is
written into its workload record (``observe.workload``), and the
batch's summed wait, tenant mix and per-query tenant column go to the
predictor for the attribution ledger.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional

from ..observe import ServingStats, trace, workload

_log = logging.getLogger(__name__)

#: Inter-arrival EWMA smoothing: the last dozen arrivals dominate.
_ARRIVAL_ALPHA = 0.15


class Backpressure(RuntimeError):
    """Admission bound hit; retry after ``retry_after`` seconds.
    ``reason`` names the bound: ``"queue_full"`` or ``"client_share"``."""

    def __init__(self, retry_after: float, depth: int, cap: int,
                 reason: str = "queue_full"):
        super().__init__(
            f"serving queue full ({depth}/{cap} queries, {reason}); "
            f"retry after {retry_after:.1f}s")
        self.retry_after = retry_after
        self.depth = depth
        self.cap = cap
        self.reason = reason


class _Request:
    """One caller's slice of a super-batch."""

    __slots__ = ("queries", "event", "result", "error", "trace",
                 "client", "tenant", "t_admit", "record")

    def __init__(self, queries: List[Any], client: Optional[str] = None,
                 tenant: Optional[str] = None,
                 record: Optional[Dict[str, Any]] = None):
        self.queries = queries
        self.event = threading.Event()
        self.result: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None
        # The handler thread's trace context, carried across the hop to
        # the batcher's threads and into the bus envelope.
        self.trace = trace.current()
        self.client = client
        # The hashed tenant key (None = unattributed), the admission
        # time (dispatch minus it is the queue wait) and the open
        # workload record (None = the recorder is off).
        self.tenant = tenant
        self.t_admit = time.monotonic()
        self.record = record

    def resolve(self, result: List[Any]) -> None:
        self.result = result
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()


class MicroBatcher:
    """The admission queue and the batcher/gather thread pair in front
    of one ``Predictor``. ``submit`` blocks the handler's thread until
    its slice of the ensembled results is ready."""

    def __init__(self, predictor: Any, *, fill_window: float = 0.005,
                 fill_window_min: float = 0.0,
                 fill_window_max: Optional[float] = None,
                 max_batch: int = 1024, max_inflight: int = 2,
                 queue_cap: int = 4096, pre_encoded: bool = True,
                 client_share: float = 0.0,
                 stats: Optional[ServingStats] = None):
        if fill_window < 0:
            raise ValueError("fill_window must be >= 0")
        if max_batch < 1 or max_inflight < 1 or queue_cap < 1:
            raise ValueError("max_batch, max_inflight and queue_cap "
                             "must be >= 1")
        self.predictor = predictor
        self.fill_window = fill_window
        self.fill_window_min = fill_window_min
        self.fill_window_max = (fill_window if fill_window_max is None
                                else fill_window_max)
        if not (0 <= self.fill_window_min <= self.fill_window_max):
            raise ValueError("need 0 <= fill_window_min <= "
                             "fill_window_max")
        if not (0.0 <= client_share <= 1.0):
            raise ValueError("client_share must be within [0, 1]")
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        self.queue_cap = queue_cap
        self.pre_encoded = pre_encoded
        # Only requests that carry a client key are held to the share;
        # anonymous traffic sees the global bound alone.
        self.client_share = client_share
        self._client_cap = max(1, int(queue_cap * client_share)) \
            if client_share > 0 else 0
        self._client_pending: Dict[str, int] = {}
        self.stats = stats or ServingStats()

        self._cond = threading.Condition()
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._pending_queries = 0
        # Inter-arrival EWMA (seconds), the window's load signal; None
        # until two arrivals.
        self._dt_ewma: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._inflight_sem = threading.Semaphore(max_inflight)
        self._inflight = 0  # gauge only; the semaphore limits
        self._inflight_lock = threading.Lock()
        # Scattered, ungathered super-batches in dispatch order:
        # (finisher, [requests]); the semaphore bounds it.
        self._completions: "collections.deque" = collections.deque()
        self._completions_cond = threading.Condition()
        # The batch the gather thread waits on (under
        # _completions_cond): stop() fails its requests at once.
        self._gathering: Optional[List[_Request]] = None
        self._stop = threading.Event()
        self._batcher = threading.Thread(
            target=self._batch_loop, name="micro-batcher", daemon=True)
        self._gatherer = threading.Thread(
            target=self._gather_loop, name="micro-gather", daemon=True)
        self._started = False

    # --- Lifecycle ---

    def start(self) -> "MicroBatcher":
        with self._cond:  # idempotent under concurrent first submits
            if self._started:
                return self
            self._started = True
        self._batcher.start()
        self._gatherer.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        """Reject later submits and fail every waiting request at once:
        those queued, those scattered and the batch the gather thread
        waits on (its gather may run on to the gather timeout). The
        threads are joined, and what they held is failed too."""
        self._stop.set()
        self._fail_stranded()
        with self._cond:
            self._cond.notify_all()
        with self._completions_cond:
            self._completions_cond.notify_all()
        for t in (self._batcher, self._gatherer):
            if t.is_alive():
                t.join(timeout=join_timeout)
        self._fail_stranded()

    def _fail_stranded(self) -> None:
        """Fail what is queued, what is scattered and ungathered, and the
        batch in gather. A late finisher then resolves requests already
        failed, which no one reads."""
        with self._cond:
            stranded = list(self._queue)
            self._queue.clear()
            self._pending_queries = 0
            self._client_pending.clear()
        with self._completions_cond:
            stranded.extend(req for _, batch in self._completions
                            for req in batch)
            self._completions.clear()
            if self._gathering:
                stranded.extend(self._gathering)
        for req in stranded:
            req.fail(RuntimeError("micro-batcher stopped"))

    # --- Caller side ---

    def submit(self, queries: List[Any], timeout: Optional[float] = None,
               client: Optional[str] = None,
               tenant: Optional[str] = None,
               record: Optional[Dict[str, Any]] = None) -> List[Any]:
        """Queue one request's queries and wait for its slice of the
        results. Raises ``Backpressure`` when the queue is full, or,
        with fairness on, when ``client``'s share of it is. ``tenant``
        is the hashed attribution key, ``record`` the request's open
        workload record."""
        if not self._started:
            self.start()
        n = len(queries)
        if n == 0:
            return []
        if self._client_cap == 0:
            client = None
        req = _Request(queries, client=client, tenant=tenant,
                       record=record)
        with self._cond:
            # Under the lock: a request admitted after stop()'s drain
            # would sit in a queue no thread reads.
            if self._stop.is_set():
                raise RuntimeError("micro-batcher stopped")
            now = time.monotonic()
            if self._last_arrival is not None:
                # Clamped: a long idle gap would poison the EWMA so that
                # a burst after it gets no window for dozens of
                # arrivals; at twice the ceiling it reopens in ~5.
                dt = min(now - self._last_arrival,
                         2.0 * self.fill_window_max)
                self._dt_ewma = (dt if self._dt_ewma is None else
                                 _ARRIVAL_ALPHA * dt +
                                 (1.0 - _ARRIVAL_ALPHA) * self._dt_ewma)
            self._last_arrival = now
            # A request larger than the whole cap is admitted only into
            # an empty queue (it could never be served otherwise).
            if self._pending_queries > 0 and \
                    self._pending_queries + n > self.queue_cap:
                self.stats.backpressured()
                raise Backpressure(self._retry_after(),
                                   self._pending_queries, self.queue_cap)
            if client is not None:
                held = self._client_pending.get(client, 0)
                if held > 0 and held + n > self._client_cap:
                    self.stats.backpressured(reason="client_share")
                    raise Backpressure(self._retry_after(), held,
                                       self._client_cap,
                                       reason="client_share")
                self._client_pending[client] = held + n
            self._queue.append(req)
            self._pending_queries += n
            self.stats.admitted(n)
            self.stats.set_queue_depth(self._pending_queries)
            self._cond.notify_all()
        if not req.event.wait(timeout):
            raise TimeoutError(
                f"micro-batched predict did not complete in {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result if req.result is not None else []

    def _retry_after(self) -> float:
        """The 429's ``Retry-After``: a full queue is ~(cap / max_batch)
        super-batches, each at least one fill window deep; whole
        seconds, at least 1."""
        batches = max(1.0, self.queue_cap / self.max_batch)
        return max(1.0, math.ceil(batches * max(self.fill_window, 0.05)))

    # --- Batcher thread: fill + scatter ---

    def current_fill_window(self) -> float:
        """The load-adaptive window: the floor while arrivals are slower
        than the ceiling, opening to ``max - ewma`` (clamped) as they
        tighten. A stale read of the EWMA sizes one window."""
        lo, hi = self.fill_window_min, self.fill_window_max
        if lo >= hi:
            return lo  # pinned: a fixed window
        dt = self._dt_ewma
        if dt is None:
            return lo
        return min(hi, max(lo, hi - dt))

    def _drain_into(self, batch: List[_Request], total: int) -> int:
        """Move whole queued requests into ``batch`` while they fit under
        ``max_batch`` (an oversized request only as a batch's first);
        returns the new query total. Caller holds ``self._cond``."""
        while self._queue and total < self.max_batch:
            nxt = len(self._queue[0].queries)
            if batch and total + nxt > self.max_batch:
                break
            req = self._queue.popleft()
            self._pending_queries -= nxt
            if req.client is not None:
                held = self._client_pending.get(req.client, 0) - nxt
                if held > 0:
                    self._client_pending[req.client] = held
                else:
                    self._client_pending.pop(req.client, None)
            batch.append(req)
            total += nxt
        self.stats.set_queue_depth(self._pending_queries)
        return total

    def _take_batch(self):
        """Wait for a first request, then fill until the window closes
        or ``max_batch`` is reached: ``(batch, t_first, window)``, where
        the idle wait before the first request is not fill time."""
        batch: List[_Request] = []
        total = 0
        with self._cond:
            while not self._queue:
                if self._stop.is_set():
                    return batch, time.monotonic(), 0.0
                self._cond.wait(0.1)
            t_first = time.monotonic()
            window = self.current_fill_window()
            deadline = t_first + window
            while True:
                total = self._drain_into(batch, total)
                remaining = deadline - time.monotonic()
                if total >= self.max_batch or remaining <= 0 \
                        or self._stop.is_set():
                    break
                self._cond.wait(remaining)
        return batch, t_first, window

    def _top_up(self, batch: List[_Request]) -> None:
        """After the wait for an in-flight slot, take what queued
        meanwhile: under overload the slot wait is the fill window."""
        with self._cond:
            self._drain_into(batch, sum(len(r.queries) for r in batch))

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            batch, t0, window = self._take_batch()
            if not batch:
                continue
            while not self._inflight_sem.acquire(timeout=0.5):
                if self._stop.is_set():
                    for req in batch:
                        req.fail(RuntimeError("micro-batcher stopped"))
                    return
            self._top_up(batch)
            now = time.monotonic()
            fill_s = now - t0
            flat: List[Any] = []
            ctxs: List[Any] = []
            tenants: Dict[str, int] = {}
            queue_wait_s = 0.0
            for req in batch:
                flat.extend(req.queries)
                if req.trace is not None:
                    ctxs.append(req.trace)
                wait = max(0.0, now - req.t_admit)
                queue_wait_s += wait
                workload.note_queue_wait(req.record, wait)
                if req.tenant:
                    tenants[req.tenant] = (tenants.get(req.tenant, 0)
                                           + len(req.queries))
            # The per-query tenant column, only when someone in the
            # batch is attributed: a tiered escalation takes its
            # subset's mix from it.
            tenant_rows = None
            if tenants:
                tenant_rows = []
                for req in batch:
                    tenant_rows.extend([req.tenant] * len(req.queries))
            t1 = time.monotonic()
            wall = time.time()
            try:
                finisher = self.predictor.predict_submit(
                    flat, pre_encoded=self.pre_encoded, trace_ctxs=ctxs,
                    tenants=sorted(tenants.items()) or None,
                    tenant_rows=tenant_rows, queue_wait_s=queue_wait_s)
            except BaseException as e:  # noqa: BLE001 - to the callers
                self._inflight_sem.release()
                for req in batch:
                    req.fail(e)
                continue
            scatter_s = time.monotonic() - t1
            if ctxs:
                trace.record_event(
                    "predictor.scatter", self.stats.service, ctxs, wall,
                    scatter_s, attrs={"requests": len(batch),
                                      "queries": len(flat),
                                      "fill_ms": round(fill_s * 1e3, 3)})
            with self._inflight_lock:
                self._inflight += 1
                inflight = self._inflight
            self.stats.dispatched(len(batch), len(flat), fill_s,
                                  scatter_s, inflight=inflight,
                                  fill_window=window)
            with self._completions_cond:
                self._completions.append((finisher, batch))
                self._completions_cond.notify_all()

    # --- Gather thread: finish + slice ---

    def _gather_loop(self) -> None:
        while True:
            with self._completions_cond:
                while not self._completions:
                    if self._stop.is_set():
                        return
                    self._completions_cond.wait(0.1)
                finisher, batch = self._completions.popleft()
                self._gathering = batch
            t0 = time.monotonic()
            wall = time.time()
            results = error = None
            try:
                results = finisher()
            except BaseException as e:  # noqa: BLE001 - to the callers
                error = e
            finally:
                gather_s = time.monotonic() - t0
                with self._inflight_lock:
                    self._inflight -= 1
                    inflight = self._inflight
                self._inflight_sem.release()
                self.stats.gathered(gather_s, inflight=inflight)
                ctxs = [r.trace for r in batch if r.trace is not None]
                if ctxs:
                    trace.record_event("predictor.gather",
                                       self.stats.service, ctxs, wall,
                                       gather_s,
                                       attrs={"error": error is not None})
            offset = 0
            for req in batch:
                if error is not None:
                    req.fail(error)
                    continue
                n = len(req.queries)
                req.resolve(results[offset:offset + n])
                offset += n
            with self._completions_cond:
                self._gathering = None
