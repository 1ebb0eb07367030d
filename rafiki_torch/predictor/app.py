"""Predictor HTTP frontend of the port: ``POST /predict`` and
``POST /generate``.

The counterparts of ``PredictorService._predict`` and ``_generate`` in
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
  ``{"done": true, "finish": "timeout"}`` line after the timeout.

A service is built one of two ways:

- ``PredictorService(workers, device=...)`` serves in-process
  ``InferenceWorker`` objects: every query goes to every worker, and a
  worker that does not answer within the timeout makes the request a
  504;
- ``PredictorService.for_job(service_id, inference_job_id, meta, bus)``
  is the platform's predictor service, the reference's constructor: its
  queries and generate requests ride the bus to the job's registered
  workers (``Predictor``), and on ``start`` it marks its service row
  RUNNING and records its address as the inference job's
  ``predictor_host``. A bin that does not answer within the gather
  timeout loses its vote; a query no bin answered comes back null.

Either way each query's per-worker (per-bin) predictions combine
through ``ensemble_predictions``, which skips a worker's error reply,
and a generate request goes to one generating worker, round-robin. The
reference's micro-batcher, tiering, edge cache, workload records and
tenant attribution are not ported yet.
"""

from __future__ import annotations

import itertools
import json
import time
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..bus import BaseBus
from ..cache import decode_payload
from ..constants import ServiceStatus
from ..store import MetaStore
from ..torchenv import DeviceLike, resolve_device
from ..utils.service import HttpError, JsonHttpServer, StreamResponse
from ..worker.inference import InferenceWorker
from .predictor import Predictor, ensemble_predictions

#: A started generate request: its query id and the function that pops
#: its frames, ``pop(query_id, timeout=...)``.
Started = Tuple[str, Callable[..., List[Any]]]


class _LocalWorkers:
    """In-process serving: every query to every worker."""

    def __init__(self, workers: Sequence[InferenceWorker], timeout: float):
        self.workers = list(workers)
        self.timeout = timeout
        self._gen_rr = itertools.count()

    def predict(self, encoded: List[Any]) -> List[Any]:
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

    def predict(self, encoded: List[Any]) -> List[Any]:
        return self.predictor.predict(encoded, pre_encoded=True)

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
                 _backend: Any = None):
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
        self._http = JsonHttpServer([
            ("POST", "/predict", self._predict),
            ("POST", "/generate", self._generate),
        ], host=host, port=port, name="predictor")
        self.host, self.port = self._http.host, self._http.port

    @classmethod
    def for_job(cls, service_id: str, inference_job_id: str,
                meta: MetaStore, bus: BaseBus, *, host: str = "127.0.0.1",
                port: int = 0) -> "PredictorService":
        """The predictor service of one inference job, over the bus. A
        generate stream ends with a timeout line after the longest
        honest wait: the workers' warm-up, the gather timeout and a
        minute."""
        predictor = Predictor(inference_job_id, bus)
        svc = cls(host=host, port=port,
                  timeout=(predictor.worker_wait_timeout
                           + predictor.gather_timeout + 60.0),
                  _backend=_BusWorkers(predictor))
        svc.predictor = predictor
        svc.service_id = service_id
        svc.inference_job_id = inference_job_id
        svc.meta = meta
        return svc

    def start(self) -> "PredictorService":
        self._http.start()
        if self.meta is not None:
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.RUNNING,
                                     host=self.host, port=self.port)
            self.meta.update_inference_job(
                self.inference_job_id,
                predictor_host=f"{self.host}:{self.port}")
        return self

    def stop(self) -> None:
        self._http.stop()
        if self.meta is not None:
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.STOPPED)

    @property
    def running(self) -> bool:
        return self._http.running

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _predict(self, body):
        if not body:
            return 400, {"error": "missing JSON body"}
        single = "queries" not in body
        if single and "query" not in body:
            return 400, {"error": "body needs 'query' or 'queries'"}
        queries = [body["query"]] if single else body["queries"]
        if not isinstance(queries, list):
            return 400, {"error": "'queries' must be a list"}
        preds = self._backend.predict(queries)
        if single:
            return 200, {"prediction": preds[0]}
        return 200, {"predictions": preds}

    def _generate(self, body):
        """Token generation, streamed as NDJSON: the request goes to one
        generating worker, whose decode loop admits it between steps;
        its frames come back through the worker's reply queue and out
        of this handler as HTTP chunks. Prefix reuse happens in the
        worker's engine."""
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

        def frames():
            deadline = time.monotonic() + timeout
            done = False
            while not done and time.monotonic() < deadline:
                for fr in pop(qid, timeout=0.25):
                    yield json.dumps(fr) + "\n"
                    if fr.get("done"):
                        done = True
            if not done:
                yield json.dumps({"done": True,
                                  "finish": "timeout"}) + "\n"

        return 200, StreamResponse("application/x-ndjson", frames())
