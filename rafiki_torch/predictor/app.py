"""Predictor HTTP frontend of the port: ``POST /predict`` and
``POST /generate``.

The counterparts of ``PredictorService._predict`` and ``_generate`` in
``rafiki_tpu/predictor/app.py``, with the same wire:

- ``{"query": q}`` -> ``{"prediction": p}``;
- ``{"queries": [q, ...]}`` -> ``{"predictions": [p, ...]}``;
- 400 on a missing body or one with neither key;
- ``POST /generate`` with ``{"tokens": [...], "max_new": N,
  "temperature": t, "seed": s, "eos": id}`` -> one NDJSON line per token
  frame (``{"seq": k, "tok": [t], "done": ...}``, the last with
  ``finish`` and ``n_tokens``), streamed while later tokens are still
  decoding; 400 for a body without a non-empty ``tokens`` list or with
  malformed parameters, 503 when no worker generates, and a final
  ``{"done": true, "finish": "timeout"}`` line after the timeout.

Every query goes to every worker; each query's per-worker predictions
combine through ``ensemble_predictions``, which skips a worker's error
reply: the request answers 200 with the other workers' ensemble, or
``null`` when every worker failed. A worker that does not answer within
the timeout makes the request a 504. A generate request goes to one
generating worker, round-robin. The reference's micro-batcher, edge
cache, workload records and tenant attribution are not ported yet.
"""

from __future__ import annotations

import itertools
import json
import time
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, List, Optional, Sequence

from ..torchenv import DeviceLike, resolve_device
from ..utils.service import HttpError, JsonHttpServer, StreamResponse
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
        self._gen_rr = itertools.count()
        self._http = JsonHttpServer([
            ("POST", "/predict", self._predict),
            ("POST", "/generate", self._generate),
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

    def _pick_generate_worker(self) -> Optional[InferenceWorker]:
        """Round-robin over the workers that generate; None when no
        worker does."""
        gens = [w for w in self.workers if w.generates]
        if not gens:
            return None
        return gens[next(self._gen_rr) % len(gens)]

    def _generate(self, body):
        """Token generation, streamed as NDJSON: the request goes to one
        generating worker, whose decode loop admits it between steps;
        its frames come back through the worker's frame queues and out
        of this handler as HTTP chunks. Prefix reuse happens in the
        worker's engine."""
        if not body or not isinstance(body.get("tokens"), list) \
                or not body["tokens"]:
            return 400, {"error":
                         "body needs 'tokens' (non-empty id list)"}
        try:
            tokens = [int(t) for t in body["tokens"]]
            max_new = int(body.get("max_new") or 16)
            temperature = float(body.get("temperature") or 0.0)
            seed = int(body.get("seed") or 0)
            eos = (int(body["eos"])
                   if body.get("eos") is not None else None)
        except (TypeError, ValueError):
            return 400, {"error": "malformed generation parameters"}
        worker = self._pick_generate_worker()
        if worker is None:
            return 503, {"error": "no generate-capable worker"}
        qid = worker.generate(tokens, max_new=max_new,
                              temperature=temperature, seed=seed, eos=eos)
        timeout = self.timeout

        def frames():
            deadline = time.monotonic() + timeout
            done = False
            while not done and time.monotonic() < deadline:
                for fr in worker.frames.pop_token_frames(qid,
                                                         timeout=0.25):
                    yield json.dumps(fr) + "\n"
                    if fr.get("done"):
                        done = True
            if not done:
                yield json.dumps({"done": True,
                                  "finish": "timeout"}) + "\n"

        return 200, StreamResponse("application/x-ndjson", frames())
