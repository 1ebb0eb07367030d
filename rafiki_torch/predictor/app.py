"""Predictor HTTP frontend of the port: ``POST /predict``.

The counterpart of ``PredictorService._predict`` in
``rafiki_tpu/predictor/app.py``, with the same wire:

- ``{"query": q}`` -> ``{"prediction": p}``;
- ``{"queries": [q, ...]}`` -> ``{"predictions": [p, ...]}``;
- 400 on a missing body or one with neither key.

Every query goes to every worker; each query's per-worker predictions
combine through ``ensemble_predictions``. The reference's micro-batcher,
edge cache, attribution and generation routes are not ported yet.
"""

from __future__ import annotations

from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, List, Sequence

from ..torchenv import DeviceLike, resolve_device
from ..utils.service import HttpError, JsonHttpServer
from ..worker.inference import InferenceWorker
from .predictor import ensemble_predictions


class PredictorService:
    """Serves ``POST /predict`` over workers that all run on
    ``device``."""

    def __init__(self, workers: Sequence[InferenceWorker], *,
                 device: DeviceLike = None, host: str = "127.0.0.1",
                 port: int = 0, timeout: float = 300.0):
        self.device = resolve_device(device)
        if not workers:
            raise ValueError("a predictor needs at least one worker")
        for w in workers:
            if w.device != self.device:
                raise ValueError(f"worker on {w.device}, predictor on "
                                 f"{self.device}")
        self.workers = list(workers)
        self.timeout = timeout
        self._http = JsonHttpServer([
            ("POST", "/predict", self._predict),
        ], host=host, port=port, name="predictor")
        self.host, self.port = self._http.host, self._http.port

    def start(self) -> "PredictorService":
        self._http.start()
        return self

    def stop(self) -> None:
        self._http.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _run_queries(self, queries: List[Any]) -> List[Any]:
        futures = [w.submit(queries) for w in self.workers]
        try:
            per_worker = [f.result(self.timeout) for f in futures]
        except FutureTimeout:
            raise HttpError(504, f"no prediction within {self.timeout} s")
        return [ensemble_predictions([p[i] for p in per_worker])
                for i in range(len(queries))]

    def _predict(self, body):
        if not body:
            return 400, {"error": "missing JSON body"}
        single = "queries" not in body
        if single and "query" not in body:
            return 400, {"error": "body needs 'query' or 'queries'"}
        queries = [body["query"]] if single else body["queries"]
        if not isinstance(queries, list):
            return 400, {"error": "'queries' must be a list"}
        preds = self._run_queries(queries)
        if single:
            return 200, {"prediction": preds[0]}
        return 200, {"predictions": preds}
