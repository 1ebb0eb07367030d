"""Predictor HTTP frontend of the port: ``POST /predict``, ``POST
/generate``, ``GET /``, ``GET /stats``, ``GET /metrics``, ``POST
/cache/invalidate`` and ``GET /cache/peek``.

The counterpart of ``PredictorService`` in
``rafiki_tpu/predictor/app.py``, with the same wire:

- ``{"query": q}`` -> ``{"prediction": p}``;
- ``{"queries": [q, ...]}`` -> ``{"predictions": [p, ...]}``; numpy
  queries ride as the cache's ``__nd__`` frames or as plain lists;
- 400 on a missing body or one with neither key;
- ``POST /generate`` with ``{"tokens": [...], "max_new": N,
  "temperature": t, "seed": s, "eos": id}`` -> one NDJSON line per token
  frame (``{"seq": k, "tok": [t], "done": ...}``, the last with
  ``finish`` and ``n_tokens``), streamed while later tokens are still
  decoding; 400 for a body without a non-empty ``tokens`` list or with
  malformed parameters, 503 when no worker generates, and a final
  ``{"done": true, "finish": "timeout"}`` line after the timeout;
- a request past the admission bound answers 429 with ``Retry-After``
  and ``{"error", "queue_depth", "queue_cap", "reason",
  "retry_after"}``;
- ``GET /`` is health (workers, micro-batching, queue depth); ``GET
  /stats`` the ``ServingStats`` snapshot with the knobs, the tier
  threshold and the edge cache's ``info()``; ``GET /metrics`` the
  process registry (``JsonHttpServer``);
- ``POST /cache/invalidate`` empties the edge cache and bumps its epoch
  (``{"enabled": true, "epoch": e}``, or ``{"enabled": false}`` without
  a cache); the admin's promote calls it before it answers. ``GET
  /cache/peek?key=k`` reads one entry without touching it.

A service is built one of two ways:

- ``PredictorService(workers, device=...)`` serves in-process
  ``InferenceWorker`` objects: every query goes to every worker, and a
  worker that does not answer within the timeout makes the request a
  504;
- ``PredictorService.for_job(service_id, inference_job_id, meta, bus,
  ...)`` is the platform's predictor service, the reference's
  constructor with its serving keywords: its queries and generate
  requests ride the bus to the job's registered workers
  (``Predictor``), and on ``start`` it marks its service row RUNNING
  and records its address as the inference job's ``predictor_host``.
  Concurrent requests coalesce in a ``MicroBatcher`` unless
  micro-batching is off; each bin's slice is sharded over its replicas
  unless sharding is off. A bin that does not answer within the gather
  timeout loses its vote; a query no bin answered comes back null.
  A service process (``container/services.py``) builds it on the port
  ``RAFIKI_TPU_PORT`` names (0, the default, picks a free one) and
  runs it in the foreground (``run``) until SIGTERM stops it.

Each knob resolves as the reference's: an explicit argument, then its
``RAFIKI_TPU_SERVING_*`` variable (``NodeConfig.apply_env`` exports
them), then the default: ``microbatch`` (on), ``fill_window`` (0.005 s),
``fill_window_min`` (0), ``fill_window_max`` (the fill window),
``max_batch`` (1024), ``max_inflight`` (2), ``queue_cap`` (4096),
``shard_replicas`` (on), ``client_header`` ("" = fairness off),
``client_share`` (0.25), ``cache_bytes`` (0 = no edge cache),
``cache_ttl_s`` (60), ``cache_admit_after`` (2) and ``tier_threshold``
(0 = no tiering). With micro-batching off, the client share caps one
client's queries in flight instead.

With a cache budget, ``for_job`` puts an ``EdgeCache`` in front of the
batcher: each query of a request is a hit, a wait on an identical query
in flight, or a miss this request leads; only the misses are
dispatched, and a request mixing them is answered in its own order.
Each miss checks the predictor's serving-bin vector, so a promotion
seen in the registry empties the cache even without the admin's
``POST``. Hits and waits credit the device seconds a miss would have
cost (``estimate_hit_cost``).

With ``RAFIKI_TPU_SERVING_ATTRIBUTION`` on, the client header's value,
hashed (``attribution.tenant_key``), is the request's tenant: it rides
to the workers, and a served request counts under it. With
``RAFIKI_TPU_WORKLOAD_RECORD`` on, every ``/predict`` and ``/generate``
request leaves one workload record (``observe.workload``), 429s
included.

On the cluster fabric (``RAFIKI_TPU_CLUSTER_FABRIC``, read when the
service is built, and only with an edge cache) the frontends of one job
share their caches: each registers its address in the bus's frontend
registry at ``start`` (``Cache.register_frontend``) and leaves it at
``stop``; a missed key is first asked of ONE peer, picked by the key's
hash, for at most ``RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S`` seconds (``GET
/cache/peek``), and a peer's answer is served and cached as a
scatter's; a direct ``POST /cache/invalidate`` is gossiped to every
peer with ``{"gossip": true}``, which is never passed on. The epoch is
read before the probe, so an invalidation landing meanwhile drops the
late insert. ``rafiki_tpu_serving_fabric_total{service,event}`` counts
``peer_hit``, ``peer_miss``, ``probe_error``, ``gossip_sent`` and
``gossip_recv``. Off, none of this exists: no registration, no probe,
no series.

Either way each query's per-worker (per-bin) predictions combine
through ``ensemble_predictions``, which skips a worker's error reply,
and a generate request goes to one generating worker, round-robin.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import uuid
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote
from urllib.request import Request, urlopen

from ..bus import BaseBus
from ..cache import decode_payload
from ..config import NodeConfig, _parse_bool, cluster_fabric_enabled
from ..constants import ServiceStatus
from ..observe import ServingStats, trace
from ..observe import attribution as _attr
from ..observe import metrics as obs_metrics
from ..observe import workload as _workload
from ..store import MetaStore
from ..torchenv import DeviceLike, resolve_device
from ..utils.service import HttpError, JsonHttpServer, StreamResponse
from ..worker.inference import InferenceWorker
from .batcher import Backpressure, MicroBatcher
from .edge_cache import EdgeCache, query_key
from .predictor import Predictor, ensemble_predictions

_log = logging.getLogger(__name__)

#: A started generate request: its query id and the function that pops
#: its frames, ``pop(query_id, timeout=...)``.
Started = Tuple[str, Callable[..., List[Any]]]


def _env_knob(field: str, default: str) -> str:
    return os.environ.get(NodeConfig.env_name(field), default)


class _LocalWorkers:
    """In-process serving: every query to every worker."""

    def __init__(self, workers: Sequence[InferenceWorker], timeout: float):
        self.workers = list(workers)
        self.timeout = timeout
        self._gen_rr = itertools.count()

    def n_workers(self) -> int:
        return len(self.workers)

    def predict(self, encoded: List[Any],
                tenant: Optional[str] = None) -> List[Any]:
        queries = [decode_payload(q) for q in encoded]
        futures = [w.submit(queries) for w in self.workers]
        try:
            per_worker = [f.result(self.timeout) for f in futures]
        except FutureTimeout:
            raise HttpError(504, f"no prediction within {self.timeout} s")
        return [ensemble_predictions([p[i] for p in per_worker])
                for i in range(len(queries))]

    def start_generate(self, tokens, **gen) -> Optional[Started]:
        gens = [w for w in self.workers if w.generates]
        if not gens:
            return None
        worker = gens[next(self._gen_rr) % len(gens)]
        return (worker.generate(tokens, **gen),
                worker.frames.pop_token_frames)


class _BusWorkers:
    """Serving over the bus, through a ``Predictor``."""

    def __init__(self, predictor: Predictor):
        self.predictor = predictor
        self._gen_rr = itertools.count()

    def n_workers(self) -> int:
        return len(self.predictor.workers())

    def predict(self, encoded: List[Any],
                tenant: Optional[str] = None) -> List[Any]:
        n = len(encoded)
        return self.predictor.predict(
            encoded, pre_encoded=True,
            tenants=[(tenant, n)] if tenant else None,
            tenant_rows=[tenant] * n if tenant else None)

    def start_generate(self, tokens, **gen) -> Optional[Started]:
        cache = self.predictor.cache
        info = cache.running_worker_info(self.predictor.inference_job_id)
        gens = sorted(w for w, i in info.items()
                      if isinstance(i, dict) and i.get("gen"))
        if not gens:
            return None
        worker = gens[next(self._gen_rr) % len(gens)]
        return (cache.send_generate(worker, tokens, **gen),
                cache.pop_token_frames)


class PredictorService:
    """Serves ``POST /predict`` and ``POST /generate`` over in-process
    workers that all run on ``device``; ``for_job`` builds the
    platform's service over the bus."""

    def __init__(self, workers: Sequence[InferenceWorker] = (), *,
                 device: DeviceLike = None, host: str = "127.0.0.1",
                 port: int = 0, timeout: float = 300.0,
                 _backend: Any = None, _label: Optional[str] = None):
        self.device: Optional[Any] = None
        if _backend is None:
            self.device = resolve_device(device)
            if not workers:
                raise ValueError("a predictor needs at least one worker")
            for w in workers:
                if w.device != self.device:
                    raise ValueError(f"worker on {w.device}, predictor on "
                                     f"{self.device}")
            _backend = _LocalWorkers(workers, timeout)
        self.workers = list(workers)
        self.timeout = timeout
        self._backend = _backend
        self.service_id: Optional[str] = None
        self.inference_job_id: Optional[str] = None
        self.meta: Optional[MetaStore] = None
        self.predictor: Optional[Predictor] = None
        self.batcher: Optional[MicroBatcher] = None
        self.microbatch = False
        self.client_header = ""
        self.edge_cache: Optional[EdgeCache] = None
        # The cluster fabric's cache sharing (``for_job`` with an edge
        # cache and the fabric on), else plain bool checks.
        self._fabric = False
        self._fabric_probe_timeout = 0.25
        self._m_fabric = None
        # Snapshots of the ledger's and the recorder's switches: off,
        # a request pays one bool check for each.
        self._attribution = _attr.enabled()
        self._workload = _workload.active()
        self._direct_cap = 0
        self._direct_pending: Dict[str, int] = {}
        self._direct_lock = threading.Lock()
        self._stopped = threading.Event()
        self.stats = ServingStats(
            service=_label or f"local-{uuid.uuid4().hex[:4]}")
        self._http = JsonHttpServer([
            # rta: disable=RTA702 liveness probe for supervisors/load-balancers, not in-tree code
            ("GET", "/", self._health),
            ("GET", "/stats", self._stats),
            ("POST", "/predict", self._predict),
            # rta: disable=RTA702 streamed generation is driven by external clients (tests hit it raw); no SDK wrapper yet
            ("POST", "/generate", self._generate),
            ("POST", "/cache/invalidate", self._cache_invalidate),
            ("GET", "/cache/peek", self._cache_peek),
        ], host=host, port=port, name=f"predictor-{self.stats.service}")
        self.host, self.port = self._http.host, self._http.port

    @classmethod
    def for_job(cls, service_id: str, inference_job_id: str,
                meta: MetaStore, bus: BaseBus, *, host: str = "127.0.0.1",
                port: int = 0, microbatch: Optional[bool] = None,
                fill_window: Optional[float] = None,
                fill_window_min: Optional[float] = None,
                fill_window_max: Optional[float] = None,
                max_batch: Optional[int] = None,
                max_inflight: Optional[int] = None,
                queue_cap: Optional[int] = None,
                shard_replicas: Optional[bool] = None,
                client_header: Optional[str] = None,
                client_share: Optional[float] = None,
                cache_bytes: Optional[int] = None,
                cache_ttl_s: Optional[float] = None,
                cache_admit_after: Optional[int] = None,
                tier_threshold: Optional[float] = None,
                node: Optional[str] = None,
                ) -> "PredictorService":
        """The predictor service of one inference job, over the bus. A
        request waits at most the workers' warm-up, the gather timeout
        and a minute; a generate stream then ends with a timeout
        line."""
        if shard_replicas is None:
            shard_replicas = _parse_bool(
                _env_knob("serving_shard_replicas", "1"))
        # The metrics label is unique to this instance (service ids are
        # reused within a process) and leads with the service id; the
        # predictor's series share it, so /metrics joins the serving
        # and shard families.
        label = f"{service_id[:12]}-{uuid.uuid4().hex[:4]}"
        predictor = Predictor(
            inference_job_id, bus, shard_replicas=shard_replicas,
            service=label,
            tier_threshold=(
                tier_threshold if tier_threshold is not None else
                float(_env_knob("serving_tier_threshold", "0") or 0)),
            node=node)
        svc = cls(host=host, port=port,
                  timeout=(predictor.worker_wait_timeout
                           + predictor.gather_timeout + 60.0),
                  _backend=_BusWorkers(predictor), _label=label)
        svc.predictor = predictor
        svc.service_id = service_id
        svc.inference_job_id = inference_job_id
        svc.meta = meta
        # The edge cache, or None: then a request pays one attribute
        # check and no cache series exists.
        nbytes = int(cache_bytes if cache_bytes is not None else
                     _env_knob("serving_cache_bytes", "0") or 0)
        if nbytes > 0:
            svc.edge_cache = EdgeCache(
                nbytes,
                ttl_s=float(cache_ttl_s if cache_ttl_s is not None else
                            _env_knob("serving_cache_ttl_s", "60")),
                admit_after=int(
                    cache_admit_after if cache_admit_after is not None
                    else _env_knob("serving_cache_admit_after", "2")),
                service=label)
            if cluster_fabric_enabled():
                svc._fabric = True
                svc._fabric_probe_timeout = float(
                    _env_knob("cluster_probe_timeout_s", "0.25") or 0.25)
                if obs_metrics.metrics_enabled():
                    svc._m_fabric = obs_metrics.registry().counter(
                        "rafiki_tpu_serving_fabric_total",
                        "Cache-fabric events between peer frontends "
                        "(event=peer_hit|peer_miss|probe_error|"
                        "gossip_sent|gossip_recv)")
        if microbatch is None:
            microbatch = _parse_bool(_env_knob("serving_microbatch", "1"))
        svc.microbatch = microbatch
        svc.client_header = (client_header if client_header is not None
                             else _env_knob("serving_client_header", ""))
        # One share for both paths: the batcher caps a client's queued
        # queries, the direct path its queries in flight.
        share = (float(client_share if client_share is not None else
                       _env_knob("serving_client_share", "0.25"))
                 if svc.client_header else 0.0)
        qcap = int(queue_cap if queue_cap is not None else
                   _env_knob("serving_queue_cap", "4096"))
        svc._direct_cap = max(1, int(qcap * share)) if share > 0 else 0
        if microbatch:
            fw_max_env = _env_knob("serving_fill_window_max", "")
            svc.batcher = MicroBatcher(
                predictor,
                fill_window=float(
                    fill_window if fill_window is not None else
                    _env_knob("serving_fill_window", "0.005")),
                fill_window_min=float(
                    fill_window_min if fill_window_min is not None else
                    _env_knob("serving_fill_window_min", "0.0")),
                fill_window_max=(
                    fill_window_max if fill_window_max is not None else
                    float(fw_max_env) if fw_max_env else None),
                max_batch=int(max_batch if max_batch is not None else
                              _env_knob("serving_max_batch", "1024")),
                max_inflight=int(max_inflight
                                 if max_inflight is not None else
                                 _env_knob("serving_max_inflight", "2")),
                queue_cap=qcap, client_share=share, stats=svc.stats)
        return svc

    def run(self) -> None:
        """A service process's foreground: start, then wait until
        ``stop`` (SIGTERM's handler) has stopped the service."""
        self.start()
        self._stopped.wait()

    def start(self) -> "PredictorService":
        if self.batcher is not None:
            self.batcher.start()
        self._http.start()
        if self.meta is not None:
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.RUNNING,
                                     host=self.host, port=self.port)
            self.meta.update_inference_job(
                self.inference_job_id,
                predictor_host=f"{self.host}:{self.port}")
        if self._fabric:
            # Keyed by the per-instance label (service ids are reused
            # within a process). A failed registration leaves this
            # frontend serving, unseen by its peers.
            try:
                self.predictor.cache.register_frontend(
                    self.inference_job_id, self.stats.service,
                    f"{self.host}:{self.port}")
            except (ConnectionError, OSError, RuntimeError):
                _log.warning("cache-fabric frontend registration failed",
                             exc_info=True)
        return self

    def stop(self) -> None:
        if self._fabric:
            try:
                self.predictor.cache.unregister_frontend(
                    self.inference_job_id, self.stats.service)
            except (ConnectionError, OSError, RuntimeError):
                pass  # the broker is gone, and the entry with it
        # The batcher first: it fails every waiting request at once, so
        # no handler holds the HTTP server's shutdown.
        if self.batcher is not None:
            self.batcher.stop()
        self._http.stop()
        # This frontend's series go with it (their labels are per
        # instance).
        self.stats.close()
        if self.predictor is not None:
            self.predictor.close()
        if self.edge_cache is not None:
            self.edge_cache.close()
        if self._m_fabric is not None:
            # rta: disable=RTA106 handle bound once in for_job and never rebound; remove()/inc() lock internally — a late fabric event racing stop-time series removal is benign
            self._m_fabric.remove(service=self.stats.service)
        for name in ("rafiki_tpu_http_request_seconds",
                     "rafiki_tpu_http_requests_total"):
            m = obs_metrics.registry().find(name)
            if m is not None:
                m.remove(service=self._http.name)
        if self.meta is not None:
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.STOPPED)
        self._stopped.set()

    @property
    def running(self) -> bool:
        return self._http.running

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # --- Routes ---

    def _health(self, params, body, ctx):
        return 200, {"status": "ok",
                     "inference_job_id": self.inference_job_id,
                     "n_workers": self._backend.n_workers(),
                     "microbatch": self.microbatch,
                     "queue_depth": self.stats.queue_depth}

    def _stats(self, params, body, ctx):
        snap = self.stats.snapshot()
        snap["microbatch"] = self.microbatch
        # The HTTP layer's series label by the server's name.
        snap["http_service"] = self._http.name
        snap["shard_replicas"] = (self.predictor.shard_replicas
                                  if self.predictor is not None else None)
        snap["tier_threshold"] = (self.predictor.tier_threshold
                                  if self.predictor is not None else None)
        snap["cache"] = (self.edge_cache.info()
                         if self.edge_cache is not None else None)
        if self.batcher is not None:
            snap["knobs"] = {
                "fill_window": self.batcher.fill_window,
                "fill_window_min": self.batcher.fill_window_min,
                "fill_window_max": self.batcher.fill_window_max,
                "max_batch": self.batcher.max_batch,
                "max_inflight": self.batcher.max_inflight,
                "queue_cap": self.batcher.queue_cap,
                "client_share": self.batcher.client_share,
                "client_header": self.client_header,
            }
        return 200, snap

    def _cache_invalidate(self, params, body, ctx):
        """Empty the edge cache and bump its epoch: after this answers,
        no request is served an answer computed before it. On the
        fabric a direct invalidation is gossiped to every peer; a
        gossiped one (``{"gossip": true}``) is not passed on."""
        if self.edge_cache is None:
            return 200, {"enabled": False}
        gossip = bool(body and body.get("gossip"))
        epoch = self.edge_cache.invalidate()
        if self._fabric:
            if gossip:
                self._fabric_event("gossip_recv")
            else:
                self._gossip_invalidate()
        return 200, {"enabled": True, "epoch": epoch}

    def _cache_peek(self, params, body, ctx):
        """Whether the cache holds ``key``, without touching it."""
        if self.edge_cache is None:
            return 200, {"enabled": False, "found": False}
        found, value = self.edge_cache.peek(ctx.query_one("key") or "")
        return 200, {"enabled": True, "found": found,
                     "value": value if found else None}

    # --- The cache fabric ---

    def _fabric_event(self, event: str) -> None:
        if self._m_fabric is not None:
            self._m_fabric.inc(service=self.stats.service, event=event)

    def _fabric_peers(self) -> List[str]:
        """The addresses of the job's other registered frontends, read
        from the bus at each miss (frontends come and go at deploy
        rate)."""
        try:
            peers = self.predictor.cache.frontends(self.inference_job_id)
        except (ConnectionError, OSError, RuntimeError):
            return []
        return sorted(addr for inst, addr in peers.items()
                      if inst != self.stats.service)

    def _peer_probe(self, key: str) -> Any:
        """Ask ONE peer, picked by the key's hash, whether it holds
        ``key``: its value, or None. Never raises; the probe timeout
        bounds the latency it adds."""
        peers = self._fabric_peers()
        if not peers:
            return None
        addr = peers[int(key[:8] or "0", 16) % len(peers)]
        try:
            with urlopen(f"http://{addr}/cache/peek?key={quote(key)}",
                         timeout=self._fabric_probe_timeout) as resp:
                reply = json.loads(resp.read())
        except (OSError, ValueError):
            self._fabric_event("probe_error")
            return None
        if reply.get("found"):
            self._fabric_event("peer_hit")
            return reply.get("value")
        self._fabric_event("peer_miss")
        return None

    def _gossip_invalidate(self) -> None:
        """One hop of invalidation to every peer, best effort: the
        admin's promote-path fan-out is what the promotion relies on;
        this makes a direct invalidation reach the peers within a probe
        timeout rather than a TTL."""
        for addr in self._fabric_peers():
            try:
                req = Request(f"http://{addr}/cache/invalidate",
                              data=b'{"gossip": true}',
                              headers={"Content-Type": "application/json"},
                              method="POST")
                with urlopen(req, timeout=self._fabric_probe_timeout) as r:
                    r.read()
            except OSError:
                _log.warning("cache-fabric gossip to %s failed", addr,
                             exc_info=True)
                continue
            self._fabric_event("gossip_sent")

    def _run_queries(self, encoded: List[Any],
                     client: Optional[str] = None,
                     tenant: Optional[str] = None,
                     record: Optional[Dict[str, Any]] = None) -> List[Any]:
        """One request's queries -> their answers, through the edge cache
        when there is one."""
        if self.edge_cache is None:
            return self._dispatch_queries(encoded, client, tenant=tenant,
                                          record=record)
        return self._run_cached(encoded, client, tenant=tenant,
                                record=record)

    def _run_cached(self, encoded: List[Any], client: Optional[str] = None,
                    tenant: Optional[str] = None,
                    record: Optional[Dict[str, Any]] = None) -> List[Any]:
        cache = self.edge_cache
        n = len(encoded)
        results: List[Any] = [None] * n
        misses: List[Tuple[int, str, Any]] = []  # (position, key, flight)
        lead_pos: Dict[str, int] = {}  # key -> its first position here
        dups: List[Tuple[int, int]] = []  # (position, leading position)
        waits: List[Tuple[int, Any]] = []  # (position, leader's flight)
        wall, t0 = time.time(), time.monotonic()
        n_hits = 0
        for i, q in enumerate(encoded):
            key = query_key(q)
            if key in lead_pos:
                dups.append((i, lead_pos[key]))
                continue
            kind, payload = cache.begin(key)
            if kind == "hit":
                results[i] = payload
                n_hits += 1
            elif kind == "wait":
                waits.append((i, payload))
            else:
                lead_pos[key] = i
                misses.append((i, key, payload))
        # Read before the probe and the dispatch: an invalidation landing
        # meanwhile bumps it, and resolve() then drops the stale insert.
        epoch = cache.epoch
        if misses and self._fabric:
            # A key a peer holds is computed once for the cluster.
            still = []
            for i, key, flight in misses:
                value = self._peer_probe(key)
                if value is not None:
                    results[i] = value
                    cache.resolve(key, value, epoch, flight=flight)
                else:
                    still.append((i, key, flight))
            misses = still
        if misses:
            try:
                sub = self._dispatch_queries(
                    [encoded[i] for i, _, _ in misses], client,
                    tenant=tenant, record=record)
            except BaseException as e:
                for _, key, flight in misses:
                    cache.fail(key, e, flight=flight)
                raise
            vector = self.predictor.serving_vector()
            if vector is not None:
                cache.note_vector(vector)
            for (i, key, flight), value in zip(misses, sub):
                results[i] = value
                cache.resolve(key, value, epoch, flight=flight)
        # A hit or a wait skipped the scatter; a wait is credited only
        # once its leader answered.
        est = (self.predictor.estimate_hit_cost()
               if (n_hits or waits) else 0.0)
        if n_hits:
            cache.note_avoided(n_hits * est)
        if waits:
            for i, flight in waits:
                results[i] = flight.wait(self.timeout)
            cache.note_avoided(est * sum(
                1 for i, _ in waits if results[i] is not None))
        for i, lead in dups:
            results[i] = results[lead]
        if n_hits or waits or dups:
            ctx = trace.current()
            if ctx is not None:
                trace.record_event(
                    "predictor.cache", self.stats.service, [ctx], wall,
                    time.monotonic() - t0,
                    attrs={"hits": n_hits, "coalesced": len(waits),
                           "misses": len(misses)})
        return results

    def _dispatch_queries(self, encoded: List[Any],
                          client: Optional[str] = None,
                          tenant: Optional[str] = None,
                          record: Optional[Dict[str, Any]] = None,
                          ) -> List[Any]:
        """One request's (missed) queries -> their predictions: through
        the micro-batcher when it is on (the frames stay encoded all the
        way to the bus), else straight to the workers, with the client's
        queries in flight capped."""
        if not encoded:
            return []
        if self.batcher is not None:
            return self.batcher.submit(encoded, timeout=self.timeout,
                                       client=client, tenant=tenant,
                                       record=record)
        n = len(encoded)
        if client is not None and self._direct_cap:
            with self._direct_lock:
                held = self._direct_pending.get(client, 0)
                # As the batcher: a lone over-cap request is admitted
                # when the client holds nothing.
                if held > 0 and held + n > self._direct_cap:
                    self.stats.backpressured(reason="client_share")
                    raise Backpressure(1.0, held, self._direct_cap,
                                       reason="client_share")
                self._direct_pending[client] = held + n
        try:
            self.stats.admitted(n)
            return self._backend.predict(encoded, tenant=tenant)
        finally:
            if client is not None and self._direct_cap:
                with self._direct_lock:
                    left = self._direct_pending.get(client, 0) - n
                    if left > 0:
                        self._direct_pending[client] = left
                    else:
                        self._direct_pending.pop(client, None)

    def _predict(self, params, body, ctx):
        if not body:
            return 400, {"error": "missing JSON body"}
        single = "queries" not in body
        if single and "query" not in body:
            return 400, {"error": "body needs 'query' or 'queries'"}
        queries = [body["query"]] if single else body["queries"]
        if not isinstance(queries, list):
            return 400, {"error": "'queries' must be a list"}
        client = (ctx.headers.get(self.client_header)
                  if self.client_header else None)
        # The hashed tenant key, never the raw header; the rollup counts
        # a request once it is served.
        tenant = _attr.tenant_key(client) if self._attribution else None
        # One arrival record a request, 429s included.
        record = (_workload.open_request(self.inference_job_id or "",
                                         tenant, len(queries))
                  if self._workload else None)
        t0 = time.monotonic()
        try:
            preds = self._run_queries(queries, client=client,
                                      tenant=tenant, record=record)
        except Backpressure as e:
            if self._attribution:
                _attr.account_rejected(self.stats.service, e.reason)
            _workload.commit(record, 429, time.monotonic() - t0,
                             reason=e.reason)
            return (429,
                    {"error": str(e), "queue_depth": e.depth,
                     "queue_cap": e.cap, "reason": e.reason,
                     "retry_after": e.retry_after},
                    {"Retry-After": str(int(e.retry_after))})
        dur_s = time.monotonic() - t0
        if tenant:
            _attr.account_admitted(tenant)
            _attr.account_tenant_latency(tenant, dur_s,
                                         service=self.stats.service)
        _workload.commit(record, 200, dur_s,
                         bins=(self.predictor.serving_vector()
                               if self.predictor is not None else None))
        if single:
            return 200, {"prediction": preds[0]}
        return 200, {"predictions": preds}

    def _generate(self, params, body, ctx):
        """Token generation, streamed as NDJSON: the request goes to one
        generating worker, whose decode loop admits it between steps;
        its frames come back through the worker's reply queue and out
        of this handler as HTTP chunks. Prefix reuse happens in the
        worker's engine. The stream's end (or the client leaving)
        commits its workload record: 200, 502 after an error frame, 504
        after the timeout."""
        if not body or not isinstance(body.get("tokens"), list) \
                or not body["tokens"]:
            return 400, {"error":
                         "body needs 'tokens' (non-empty id list)"}
        try:
            tokens = [int(t) for t in body["tokens"]]
            gen = {"max_new": int(body.get("max_new") or 16),
                   "temperature": float(body.get("temperature") or 0.0),
                   "seed": int(body.get("seed") or 0),
                   "eos": (int(body["eos"])
                           if body.get("eos") is not None else None)}
        except (TypeError, ValueError):
            return 400, {"error": "malformed generation parameters"}
        started = self._backend.start_generate(tokens, **gen)
        if started is None:
            return 503, {"error": "no generate-capable worker"}
        qid, pop = started
        timeout = self.timeout
        client = (ctx.headers.get(self.client_header)
                  if self.client_header else None)
        tenant = _attr.tenant_key(client) if self._attribution else None
        record = (_workload.open_request(self.inference_job_id or "",
                                         tenant, 1)
                  if self._workload else None)

        def frames():
            t0 = time.monotonic()
            deadline = t0 + timeout
            status, done = 200, False
            try:
                while not done and time.monotonic() < deadline:
                    for fr in pop(qid, timeout=0.25):
                        if fr.get("finish") == "error":
                            status = 502
                        yield json.dumps(fr) + "\n"
                        if fr.get("done"):
                            done = True
                if not done:
                    status = 504
                    yield json.dumps({"done": True,
                                      "finish": "timeout"}) + "\n"
            finally:
                dur = time.monotonic() - t0
                _workload.commit(record, status, dur)
                if tenant and status == 200:
                    _attr.account_admitted(tenant)
                    _attr.account_tenant_latency(
                        tenant, dur, service=self.stats.service)

        return 200, StreamResponse("application/x-ndjson", frames())
