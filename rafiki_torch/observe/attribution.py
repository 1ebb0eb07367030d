"""Serving attribution ledger: per-bin and per-tenant accounting.

The port's copy of ``rafiki_tpu/observe/attribution.py``, same series
and labels.

Frontend side (the micro-batcher and the predictor's scatter):

- ``rafiki_tpu_serving_bin_queries_total{service, bin}``: queries
  scattered toward each trial bin;
- ``rafiki_tpu_serving_bin_queue_seconds_total{service, bin}``: the
  admission wait of the work bound for each bin;
- ``rafiki_tpu_serving_bin_rejected_total{service, reason}``: 429s.

Worker side (``BusInferenceWorker``, which knows its job and bin):

- ``rafiki_tpu_serving_bin_requests_total{job, bin}``: queries served;
- ``rafiki_tpu_serving_bin_compute_seconds_total{job, bin}``: a burst's
  device time, dispatch to readback;
- ``rafiki_tpu_serving_bin_device_seconds{job, bin, bucket, dtype,
  quant, mode}``: its histogram with the serving variant (``mode``
  ``stacked``/``fallback``/``members``/``single``).

Tenant rollup:

- ``rafiki_tpu_serving_tenant_requests_total{tenant}``: requests served
  per hashed client key;
- ``rafiki_tpu_serving_tenant_device_seconds_total{tenant}``: device
  time prorated over the tenant mix a burst's frames carried (the
  ``_tenant`` bus envelope, next to ``_trace``);
- ``rafiki_tpu_serving_tenant_request_seconds{tenant, service}``: the
  served requests' latency at the frontend.

The ``tenant`` label is ``blake2b(client_key)`` of 6 bytes (no raw
client identifiers in the exposition), and the live tenants are an LRU
of ``TENANT_CAP``: an evicted tenant's series go with it.

``RAFIKI_TPU_SERVING_ATTRIBUTION`` (``NodeConfig.serving_attribution``,
off by default) is read once, at first use: off, every account call is
one None check and no family is registered. A frontend's series drop on
its ``stop()`` (``close_service``), a worker's ``(job, bin)`` series
when its serve loop exits (``close_worker``), and the tenant rollup
when the last attributing owner closes.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import metrics as _metrics

ATTRIBUTION_ENV = "RAFIKI_TPU_SERVING_ATTRIBUTION"

#: Live-tenant cardinality cap (LRU): the 65th distinct client key
#: evicts (and removes the series of) the least recently seen one.
TENANT_CAP = 64

#: Bus-envelope key for the tenant carry (next to trace's ``_trace``).
#: Old frames lack it, old consumers ignore it — skew degrades to
#: "unattributed", never a failed query.
ENVELOPE_KEY = "_tenant"

#: A super-batch mixes many clients; the envelope carries at most this
#: many ``[tenant, count]`` pairs (largest first — the rest of the
#: burst's device time goes unattributed rather than unbounded).
MAX_ENVELOPE_TENANTS = 8

_lock = threading.Lock()
_state: Optional[Tuple] = None  # dict-of-metrics | (None,) sentinel
_owners = 0
_tenants: "collections.OrderedDict[str, None]" = collections.OrderedDict()


def active() -> bool:
    """Whether the ledger is resolved ON in this process (families
    registered). Cheap enough for per-batch checks; resolves the env
    on first call like every account site."""
    return _families() is not None


def enabled(raw: Optional[str] = None) -> bool:
    """Whether serving attribution is requested (construction-time
    read; the resolved metric families are cached separately)."""
    if raw is None:
        raw = os.environ.get(ATTRIBUTION_ENV, "0")
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


def tenant_key(raw: Optional[str]) -> Optional[str]:
    """Bounded-cardinality tenant label for one client key: a short
    blake2b digest — raw client identifiers (API keys, emails) must
    never appear in the exposition."""
    if not raw:
        return None
    return hashlib.blake2b(str(raw).encode("utf-8", errors="replace"),
                           digest_size=6).hexdigest()


def _clamp(tenant: Any) -> str:
    """The ONE normalization of a tenant label. Our own keys are
    12-hex ``tenant_key`` digests, but the envelope is produced by
    whatever rides the bus — clamping at every boundary keeps the
    label bounded AND keeps the LRU key identical to the series label
    (an eviction that removes a different spelling than was inc'd
    would leak the series forever)."""
    return str(tenant)[:16]


def _families() -> Optional[Dict[str, Any]]:
    """The ledger's metric families, resolved ONCE: None when
    attribution (or metrics) is off — no family registered, zero
    series, one None check per account call."""
    global _state
    # rta: disable=RTA101 double-checked init: the bare read is the fast path; the write re-checks under _lock
    s = _state
    if s is None:
        with _lock:
            s = _state
            if s is None:
                if enabled() and _metrics.metrics_enabled():
                    r = _metrics.registry()
                    fams = {
                        "bin_queries": r.counter(
                            "rafiki_tpu_serving_bin_queries_total",
                            "Queries scattered toward each serving "
                            "trial bin (frontend side)"),
                        "bin_queue": r.counter(
                            "rafiki_tpu_serving_bin_queue_seconds_total",
                            "Admission-queue wait accrued by work "
                            "bound for each bin, seconds"),
                        "bin_rejected": r.counter(
                            "rafiki_tpu_serving_bin_rejected_total",
                            "429 backpressure per attributing frontend "
                            "(reason=queue_full|client_share; no bin — "
                            "a rejected request never reached a plan)"),
                        "bin_requests": r.counter(
                            "rafiki_tpu_serving_bin_requests_total",
                            "Queries served per (job, bin) — worker "
                            "side"),
                        "bin_compute": r.counter(
                            "rafiki_tpu_serving_bin_compute_seconds_total",
                            "Burst device time per (job, bin), "
                            "seconds"),
                        "bin_device": r.histogram(
                            "rafiki_tpu_serving_bin_device_seconds",
                            "Per-dispatch device time with the serving "
                            "variant breakdown (bucket, dtype, quant, "
                            "mode=stacked|fallback|members|single)"),
                        "tenant_requests": r.counter(
                            "rafiki_tpu_serving_tenant_requests_total",
                            "Requests per hashed client key (LRU-"
                            "capped tenant cardinality)"),
                        "tenant_device": r.counter(
                            "rafiki_tpu_serving_tenant_device_seconds_total",
                            "Device seconds prorated over the tenant "
                            "mix the bursts carried"),
                        "tenant_latency": r.histogram(
                            "rafiki_tpu_serving_tenant_request_seconds",
                            "Per-request serving latency per hashed "
                            "client key + frontend service label (the "
                            "SLO plane's tenant-scoped latency "
                            "source; tenant LRU cap/lifecycle shared "
                            "with the rollup counters, service slice "
                            "dropped on frontend stop)"),
                    }
                    s = (fams,)
                else:
                    s = (None,)
                _state = s
    return s[0]


def reset_for_tests() -> None:
    """Drop the resolved state so a test that flips
    ``RAFIKI_TPU_SERVING_ATTRIBUTION`` sees its env take effect
    (production resolves once, by design)."""
    global _state, _owners
    with _lock:
        _state = None
        _owners = 0
        _tenants.clear()


# --- Owner lifecycle --------------------------------------------------

def open_owner() -> None:
    """An attributing service (frontend or worker) came up."""
    global _owners
    if _families() is None:
        return
    with _lock:
        _owners += 1


def close_owner() -> None:
    """An attributing service went away; the LAST one out clears the
    process-global tenant rollup (per-instance series are the owners'
    own ``close_service``/``close_worker`` duty)."""
    global _owners
    fams = _families()
    if fams is None:
        return
    with _lock:
        _owners = max(0, _owners - 1)
        last = _owners == 0
        if last:
            _tenants.clear()
    if last:
        fams["tenant_requests"].remove()
        fams["tenant_device"].remove()
        fams["tenant_latency"].remove()


def close_service(service: str) -> None:
    """Drop one frontend's ``service``-labeled ledger series (the
    tenant latency histogram's slice included)."""
    fams = _families()
    if fams is None:
        return
    for key in ("bin_queries", "bin_queue", "bin_rejected",
                "tenant_latency"):
        fams[key].remove(service=service)
    close_owner()


def drop_worker_bin(job: str, bin_id: str) -> None:
    """Drop one ``(job, bin)`` label set from the worker-side
    families WITHOUT touching the owner refcount — the promote-path
    restack changes a live worker's bin in place, and the old bin's
    series must not outlive the swap (promotion churn may never grow
    the scrape payload). Replicas share the label set, so a sibling
    that keeps serving simply re-creates it on its next burst (a
    counter reset, which every delta consumer here tolerates)."""
    fams = _families()
    if fams is None:
        return
    # Same truncation as account_burst, or the removal never matches.
    job, bin_id = str(job)[:12], str(bin_id)[:12]
    for key in ("bin_requests", "bin_compute", "bin_device"):
        fams[key].remove(job=job, bin=bin_id)


def close_worker(job: str, bin_id: str) -> None:
    """Drop one worker's ``(job, bin)`` ledger series and release its
    owner slot (serve-loop exit)."""
    if _families() is None:
        return
    drop_worker_bin(job, bin_id)
    close_owner()


# --- Tenant LRU -------------------------------------------------------

def _touch_tenant(fams: Dict[str, Any], tenant: str) -> None:
    """LRU-admit one tenant label; caller is about to inc its series.
    Evicting removes the evictee's series from BOTH tenant families."""
    evicted = None
    with _lock:
        if tenant in _tenants:
            _tenants.move_to_end(tenant)
        else:
            _tenants[tenant] = None
            if len(_tenants) > TENANT_CAP:
                evicted, _ = _tenants.popitem(last=False)
    if evicted is not None:
        fams["tenant_requests"].remove(tenant=evicted)
        fams["tenant_device"].remove(tenant=evicted)
        fams["tenant_latency"].remove(tenant=evicted)


# --- Frontend accounting ----------------------------------------------

def account_admitted(tenant: Optional[str], n_requests: int = 1) -> None:
    fams = _families()
    if fams is None or not tenant:
        return
    tenant = _clamp(tenant)
    _touch_tenant(fams, tenant)
    fams["tenant_requests"].inc(n_requests, tenant=tenant)


def account_tenant_latency(tenant: Optional[str], seconds: float,
                           service: str = "") -> None:
    """One SERVED request's end-to-end latency under its tenant label
    (frontend side; a tenant-scoped latency objective reads this
    histogram's bucket deltas). Unlike the process-global tenant rollup counters,
    this histogram ALSO carries the frontend's ``service`` label: two
    jobs' frontends sharing one process registry must not fold each
    other's tenant latency into their own SLO instances (the engine
    filters on it). Same LRU admission as the rollup counters, so a
    rotating-key client cannot grow the registry; ``close_service``
    drops the frontend's slice like every other service-labeled
    family."""
    fams = _families()
    if fams is None or not tenant or seconds < 0:
        return
    tenant = _clamp(tenant)
    _touch_tenant(fams, tenant)
    fams["tenant_latency"].observe(seconds, tenant=tenant,
                                   service=service)


def account_rejected(service: str, reason: str) -> None:
    fams = _families()
    if fams is None:
        return
    # reason is the fixed queue_full|client_share vocabulary on the
    # same service-labeled series close_service removes.
    fams["bin_rejected"].inc(service=service, reason=reason)


def account_scatter(service: str, bin_queries: Dict[str, int],
                    queue_wait_s: float = 0.0) -> None:
    """One plan's per-bin query counts (+ the super-batch's admission
    wait, charged to every bin it scatters to)."""
    fams = _families()
    if fams is None:
        return
    for bin_id, n in bin_queries.items():
        if n <= 0:
            continue
        fams["bin_queries"].inc(n, service=service, bin=str(bin_id)[:12])
        if queue_wait_s > 0:
            fams["bin_queue"].inc(queue_wait_s, service=service,
                                  bin=str(bin_id)[:12])


# --- Worker accounting ------------------------------------------------

def account_burst(job: str, bin_id: str, n_queries: int,
                  device_s: float, bucket: Optional[int] = None,
                  dtype: Optional[str] = None, quant: str = "",
                  mode: str = "single") -> None:
    """One served burst's device time, attributed to the worker's
    (job, bin) with the dispatch-variant breakdown."""
    fams = _families()
    if fams is None or n_queries <= 0:
        return
    job, bin_id = str(job)[:12], str(bin_id)[:12]
    fams["bin_requests"].inc(n_queries, job=job, bin=bin_id)
    fams["bin_compute"].inc(max(0.0, device_s), job=job, bin=bin_id)
    fams["bin_device"].observe(
        max(0.0, device_s), job=job, bin=bin_id,
        bucket=str(bucket) if bucket is not None else "-",
        dtype=str(dtype) if dtype else "-",
        quant=quant or "-", mode=mode or "single")


def account_tenant_device(tenants: Iterable[Tuple[str, int]],
                          device_s: float, n_queries: int) -> None:
    """Prorate one burst's device time over the tenant mix its frames
    carried (under-attributes when frames carried no tenant info —
    never fabricates)."""
    fams = _families()
    if fams is None or n_queries <= 0 or device_s <= 0:
        return
    for tenant, count in tenants:
        if not tenant or count <= 0:
            continue
        tenant = _clamp(tenant)
        _touch_tenant(fams, tenant)
        fams["tenant_device"].inc(
            device_s * min(count, n_queries) / n_queries,
            tenant=tenant)


# --- Bus-envelope carry ----------------------------------------------

def inject_tenants(tenants: Optional[List[Tuple[str, int]]],
                   ) -> Optional[List[List[Any]]]:
    """Envelope field for a query frame carrying these requests'
    tenant mix, or None when nothing is attributed (the frame then
    looks exactly like a pre-attribution frame)."""
    if not tenants:
        return None
    merged: Dict[str, int] = {}
    for tenant, count in tenants:
        if tenant and count > 0:
            merged[_clamp(tenant)] = (merged.get(_clamp(tenant), 0)
                                      + int(count))
    if not merged:
        return None
    top = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
    return [[t, n] for t, n in top[:MAX_ENVELOPE_TENANTS]]


def extract_tenants(frame: Any) -> List[Tuple[str, int]]:
    """Pop the tenant envelope off a bus frame dict; old frames and
    malformed envelopes yield ``[]`` — attribution must never fail a
    query."""
    if not isinstance(frame, dict):
        return []
    env = frame.pop(ENVELOPE_KEY, None)
    if not isinstance(env, list):
        return []
    out: List[Tuple[str, int]] = []
    try:
        for tenant, count in env:
            out.append((_clamp(tenant), int(count)))
    except (TypeError, ValueError):
        return []
    return out


def extract_frames_tenants(frames: Iterable[Any],
                           ) -> List[Tuple[str, int]]:
    """Extract + merge tenant counts across a popped burst."""
    merged: Dict[str, int] = {}
    for frame in frames:
        for tenant, count in extract_tenants(frame):
            merged[tenant] = merged.get(tenant, 0) + count
    return sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
