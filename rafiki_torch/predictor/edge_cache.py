"""Content-addressed response cache at the predictor edge.

The port's copy of ``EdgeCache`` from
``rafiki_tpu/predictor/edge_cache.py``: an admission-controlled,
TTL-bounded, byte-budget LRU in front of the micro-batcher
(``predictor/app.py`` asks it for each query before anything reaches
the bus).

- **Content addressing.** The key is a digest of the wire-encoded
  query frame, so two clients sending the same image hit one entry.
- **Second-touch admission.** A key is admitted on its
  ``admit_after``-th miss (default 2), so a one-off query never evicts
  a hot entry.
- **In-flight coalescing.** N concurrent identical queries cost one
  scatter: the first leads, the rest wait on its flight and share the
  answer (``coalesce`` events).
- **Epoch invalidation.** Each entry carries the epoch of its scatter.
  Trial promotion bumps the epoch (``POST /cache/invalidate``, and the
  serving-bin vector is checked on every miss): the cache empties and
  a scatter still in flight from before drops its insert, so a
  promoted model is never shadowed by a stale answer. Waiters already
  on a pre-promotion leader get its answer, as a request scattered a
  moment before the swap would.

Series, registered only when a cache is built (a disabled cache is
``None`` at the call site and registers none):
``rafiki_tpu_serving_cache_total{event=hit|miss|evict|coalesce|
invalidate}``, ``rafiki_tpu_serving_cache_bytes`` and the shared
``rafiki_tpu_serving_chip_seconds_avoided_total{source=cache}``. The
generative engine's prefix cache keys on ``query_key`` too.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from ..observe import metrics as _metrics

#: Bounded second-touch bookkeeping: how many distinct not-yet-admitted
#: keys the cache remembers miss counts for (LRU). A key falling out of
#: this window simply starts its admission count over.
_SEEN_CAP = 8192


def query_key(encoded_query: Any) -> str:
    """Content address of one wire-encoded query frame. The frame is
    already JSON-safe (``cache.encode_payload`` output or the raw HTTP
    body), so a sorted-key dump is canonical: the same tensor bytes
    yield the same key no matter which client framed them."""
    blob = json.dumps(encoded_query, sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.blake2b(blob.encode("utf-8"),
                           digest_size=16).hexdigest()


def _value_nbytes(value: Any) -> int:
    """Byte estimate of a cached prediction (JSON-ish payloads; the
    odd non-JSON leaf is sized via its repr)."""
    try:
        return len(json.dumps(value, default=str))
    except (TypeError, ValueError):
        return len(repr(value))


class _Flight:
    """One in-flight computation of a key; waiters block on it.
    Stamped with the cache epoch at creation: an invalidation makes the
    flight STALE — already-attached waiters still get its (old-ensemble)
    answer, but no new request may join it (see ``begin``)."""

    __slots__ = ("event", "value", "error", "epoch")

    def __init__(self, epoch: int = 0):
        self.event = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.epoch = epoch

    def wait(self, timeout: Optional[float]) -> Any:
        if not self.event.wait(timeout):
            raise TimeoutError(
                "coalesced cache wait did not complete in time")
        if self.error is not None:
            raise self.error
        return self.value


class EdgeCache:
    """Thread-safe edge cache for one predictor frontend.

    Protocol (``predictor/app.py`` drives it):

    1. ``begin(key)`` per query →
       ``("hit", value)`` | ``("wait", flight)`` | ``("lead", None)``.
    2. A leader reads ``epoch`` BEFORE scattering, computes, then calls
       ``resolve(key, value, epoch)`` (or ``fail(key, exc)``) — resolve
       inserts only when the epoch still matches AND the key has been
       missed ``admit_after`` times, and always wakes the waiters.
    3. ``note_vector(bins)`` after every scatter: a changed serving-bin
       vector (trial promotion observed from the registry) invalidates
       wholesale, belt-and-braces under the admin's explicit
       ``invalidate()``.
    """

    def __init__(self, max_bytes: int, ttl_s: float = 60.0,
                 admit_after: int = 2, service: str = ""):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive (a disabled "
                             "cache is None at the call site)")
        if ttl_s <= 0 or admit_after < 1:
            raise ValueError("need ttl_s > 0 and admit_after >= 1")
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self.admit_after = admit_after
        self.service = service
        self._lock = threading.Lock()
        #: key -> (value, nbytes, expires_at_monotonic)
        self._entries: "OrderedDict[str, Tuple[Any, int, float]]" = \
            OrderedDict()
        self._bytes = 0
        self._epoch = 0
        self._vector: Optional[tuple] = None
        #: key -> miss count (admission control; bounded LRU)
        self._seen: "OrderedDict[str, int]" = OrderedDict()
        self._flights: Dict[str, _Flight] = {}
        self._m_events = self._m_bytes = self._m_avoided = None
        if _metrics.metrics_enabled():
            reg = _metrics.registry()
            self._m_events = reg.counter(
                "rafiki_tpu_serving_cache_total",
                "Edge-cache events (event=hit|miss|evict|coalesce|"
                "invalidate)")
            self._m_bytes = reg.gauge(
                "rafiki_tpu_serving_cache_bytes",
                "Bytes held by the predictor edge cache")
            self._m_avoided = reg.counter(
                "rafiki_tpu_serving_chip_seconds_avoided_total",
                "Estimated chip-seconds NOT spent thanks to a serving "
                "cut-through (source=cache|tier), from the per-bin "
                "compute-cost EWMA")

    # --- Events ---

    def _event(self, event: str, n: int = 1) -> None:
        if self._m_events is not None and n:
            self._m_events.inc(n, service=self.service, event=event)

    def note_avoided(self, chip_seconds: float) -> None:
        """Credit estimated chip-seconds a hit/coalesce skipped (0 when
        no per-bin cost estimate exists yet — honest, not padded)."""
        if self._m_avoided is not None and chip_seconds > 0:
            self._m_avoided.inc(chip_seconds, service=self.service,
                                source="cache")

    # --- Lookup / coalescing ---

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def begin(self, key: str) -> Tuple[str, Any]:
        """Resolve one query key: cache hit, join an in-flight leader,
        or become the leader (the caller MUST then resolve/fail with
        the returned flight). A flight whose epoch predates the current
        one (an invalidation landed after its scatter began) is STALE:
        this request must NOT join it — it replaces the slot as a fresh
        leader, so a post-promotion request can never be answered by a
        pre-promotion leader's scatter."""
        outcome, value, flight, held = None, None, None, None
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                v, nbytes, expires = entry
                if time.monotonic() < expires:
                    self._entries.move_to_end(key)
                    outcome, value = "hit", v
                else:  # TTL lapsed: fall through to miss/lead
                    del self._entries[key]
                    self._bytes -= nbytes
                    held = self._bytes
            if outcome is None:
                flight = self._flights.get(key)
                if flight is not None and flight.epoch == self._epoch:
                    outcome = "wait"
                else:
                    # Leader: register the flight (replacing a stale
                    # pre-invalidation one — ITS waiters still complete
                    # through their object reference; resolve matches
                    # by identity) and count this miss toward
                    # second-touch admission (bounded LRU).
                    flight = _Flight(epoch=self._epoch)
                    self._flights[key] = flight
                    self._seen[key] = self._seen.pop(key, 0) + 1
                    while len(self._seen) > _SEEN_CAP:
                        self._seen.popitem(last=False)
                    outcome = "lead"
        if held is not None and self._m_bytes is not None:
            self._m_bytes.set(held, service=self.service)
        if outcome == "hit":
            self._event("hit")
            return "hit", value
        if outcome == "wait":
            self._event("coalesce")
            return "wait", flight
        self._event("miss")
        return "lead", flight

    def peek(self, key: str) -> Tuple[bool, Any]:
        """Read-only probe (``GET /cache/peek``): whether this cache
        holds ``key``. TTL-checked but otherwise free of side effects
        (no recency bump, no admission count, no event), so a probe
        does not distort this frontend's eviction or admission.
        Returns ``(found, value)``."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False, None
            value, _, expires = entry
            if time.monotonic() >= expires:
                return False, None
            return True, value

    def resolve(self, key: str, value: Any, epoch: int,
                flight: Optional[_Flight] = None) -> None:
        """Leader completion: insert (epoch- and admission-gated) and
        wake the waiters. An insert whose scatter began before an
        invalidation (``epoch`` mismatch) is dropped — the waiters
        still get the value; the CACHE never does. A ``None`` value is
        a FAILED ensemble answer (every shard timed out / every vote
        errored) and is never inserted either: a transient worker
        outage must not poison a hot key for the whole TTL. ``flight``
        is the leader's own flight from ``begin``: the slot is released
        only if it still holds THAT flight (a stale pre-invalidation
        leader must not tear down the fresh leader that replaced it)."""
        evicted = 0
        with self._lock:
            if flight is None:
                flight = self._flights.pop(key, None)
            elif self._flights.get(key) is flight:
                self._flights.pop(key)
            if value is not None and epoch == self._epoch and \
                    self._seen.get(key, 0) >= self.admit_after:
                nbytes = _value_nbytes(value)
                if nbytes <= self.max_bytes:
                    self._seen.pop(key, None)  # admitted; stop counting
                    prev = self._entries.pop(key, None)
                    if prev is not None:
                        self._bytes -= prev[1]
                    self._entries[key] = (
                        value, nbytes, time.monotonic() + self.ttl_s)
                    self._bytes += nbytes
                    while self._bytes > self.max_bytes \
                            and len(self._entries) > 1:
                        _, (_, ev_bytes, _) = \
                            self._entries.popitem(last=False)
                        self._bytes -= ev_bytes
                        evicted += 1
            held = self._bytes
        self._event("evict", evicted)
        if self._m_bytes is not None:
            self._m_bytes.set(held, service=self.service)
        if flight is not None:
            flight.value = value
            flight.event.set()

    def fail(self, key: str, error: BaseException,
             flight: Optional[_Flight] = None) -> None:
        """Leader failure: propagate to waiters (they surface the same
        error their own scatter would have hit). Same identity rule as
        ``resolve``: a stale leader only releases ITS OWN slot."""
        with self._lock:
            if flight is None:
                flight = self._flights.pop(key, None)
            elif self._flights.get(key) is flight:
                self._flights.pop(key)
        if flight is not None:
            flight.error = error
            flight.event.set()

    # --- Invalidation ---

    def invalidate(self) -> int:
        """Drop everything and bump the epoch (trial promotion). Any
        in-flight leader's eventual ``resolve`` carries the OLD epoch
        and will not be inserted. Returns the new epoch."""
        with self._lock:
            self._entries.clear()
            self._seen.clear()
            self._bytes = 0
            self._epoch += 1
            epoch = self._epoch
            # The serving vector is unknown until the next scatter
            # observes the post-promotion registry: leaving the OLD
            # tuple here would make that scatter's note_vector fire a
            # spurious SECOND invalidation (double-counted event, and
            # the first post-promotion insert dropped as stale).
            self._vector = None
        self._event("invalidate")
        if self._m_bytes is not None:
            self._m_bytes.set(0, service=self.service)
        return epoch

    def note_vector(self, vector: tuple) -> None:
        """Cross-check the serving-bin vector observed at scatter time:
        a change (promotion swapped a bin) invalidates even if the
        admin's explicit invalidate never reached this frontend."""
        with self._lock:
            if self._vector == vector:
                return
            first = self._vector is None
            self._vector = vector
        if not first:
            self.invalidate()

    # --- Reporting / lifecycle ---

    def info(self) -> Dict[str, Any]:
        with self._lock:
            out = {"entries": len(self._entries), "bytes": self._bytes,
                   "epoch": self._epoch, "max_bytes": self.max_bytes,
                   "ttl_s": self.ttl_s, "admit_after": self.admit_after}
        if self._m_events is not None:
            out["events"] = {
                labels["event"]: int(v)
                for labels, v in self._m_events.samples()
                if labels.get("service") == self.service}
        return out

    def close(self) -> None:
        """Drop this frontend's cache series (per-instance ``service``
        label) and fail any stranded flights."""
        with self._lock:
            flights = list(self._flights.values())
            self._flights.clear()
        for f in flights:
            f.error = RuntimeError("edge cache closed")
            f.event.set()
        for m in (self._m_events, self._m_bytes, self._m_avoided):
            if m is not None:
                m.remove(service=self.service)
