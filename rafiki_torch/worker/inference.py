"""Inference worker of the port: one loaded model on its device.

The counterpart of ``InferenceWorker`` in
``rafiki_tpu/worker/inference.py``, reduced to what serving one model in
one process needs: the worker loads the model on its device, takes
queries from an in-process queue, hands what is already waiting to one
``model.predict`` call without waiting for more, and gives each caller
its own predictions.

Built with ``generate=`` (the engine configuration: ``page_size``,
``n_pages``, ``decode_batch``, ``max_new_cap``,
``prefix_cache_entries``), the worker also serves token generation, the
counterpart of the reference's ``_start_generate`` /
``_route_generate`` / ``_stop_generate``: it builds the model's paged-KV
engine and a ``DecodeScheduler`` whose loop runs on its own thread, and
the token frames of each request come back through ``frames``. Where
the reference logs a failed engine construction and serves on without
generation, this worker raises: a worker asked to generate that cannot
is a fault.

A ``predict`` that raises answers each of its queries with
``{"error": "<Type>: <msg>"}``, as the reference's worker does, so one
failing worker does not fail the request. The worker serves any
``BaseModel`` of the port through ``model.predict``: the flagship LM's
scores and ``TorchFeedForward``'s class probabilities alike, the latter
built from ``(model_class, knobs, ParamStore.load(trial["params_id"]))``
for each of a train job's best trials.

The reference's bus, stacking and pipelining are not ported yet.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple, Type

from ..cache import TokenFrames
from ..model.base import BaseModel, Params
from ..torchenv import DeviceLike, resolve_device
from .decode_scheduler import DecodeScheduler

_log = logging.getLogger(__name__)


class InferenceWorker:
    """Serves ``predict`` for one model.

    ``submit(queries)`` returns a ``Future`` of the predictions;
    ``predict(queries)`` waits for it. With ``generate=``,
    ``generate(tokens, ...)`` queues a generation request and returns
    its query id, whose frames ``frames.pop_token_frames`` yields.
    ``start()`` runs the serving loop (and the decode loop) on threads,
    ``stop()`` ends them and returns every KV page.
    """

    _ids = itertools.count()

    def __init__(self, model_class: Type[BaseModel], knobs: Dict[str, Any],
                 params: Params, *, device: DeviceLike = None,
                 generate: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        self.worker_id = f"torch-worker-{next(self._ids)}"
        self.model = model_class(device=self.device,
                                 **model_class.validate_knobs(knobs))
        self.model.load_parameters(params)
        self._queue: "queue.Queue[Optional[Tuple[List[Any], Future]]]" = \
            queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self.frames = TokenFrames()
        #: Whether this worker serves token generation.
        self.generates = generate is not None
        #: The decode loop's scheduler while the worker generates.
        self.scheduler: Optional[DecodeScheduler] = None
        self._gen_thread: Optional[threading.Thread] = None
        if generate is not None:
            make = getattr(self.model, "make_generator", None)
            if make is None:
                raise TypeError(f"{model_class.__name__} has no "
                                "make_generator: it cannot generate")
            self.scheduler = DecodeScheduler(make(**generate), self.frames,
                                             self.worker_id)

    # --- lifecycle ---

    def start(self) -> "InferenceWorker":
        self._thread = threading.Thread(target=self._serve,
                                        name="torch-infer", daemon=True)
        self._thread.start()
        if self.scheduler is not None:
            self._gen_thread = threading.Thread(
                target=self.scheduler.loop, name="torch-decode",
                daemon=True)
            self._gen_thread.start()
        return self

    def stop(self, join_timeout: float = 30.0) -> None:
        self._stop_generate(join_timeout)
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                raise RuntimeError("inference worker did not stop")
            self._thread = None

    def _stop_generate(self, join_timeout: float) -> None:
        """Stop the decode loop, join its thread and release the
        engine's pages; idempotent."""
        sched, self.scheduler = self.scheduler, None
        thread, self._gen_thread = self._gen_thread, None
        if sched is None:
            return
        sched.stop()
        if thread is not None:
            thread.join(timeout=join_timeout)
            if thread.is_alive():
                raise RuntimeError("decode loop did not stop")
        sched.close()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # --- generation ---

    def generate(self, tokens: List[int], *, max_new: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos: Optional[int] = None) -> str:
        """Queue one generation request on the decode loop; its token
        frames stream to ``frames`` under the returned query id. A
        worker that does not generate answers with one error frame, so
        the caller fails fast instead of timing out."""
        query_id = uuid.uuid4().hex
        item = {"query_id": query_id, "op": "generate",
                "gen": {"tokens": list(tokens), "max_new": int(max_new),
                        "temperature": float(temperature),
                        "seed": int(seed),
                        "eos": int(eos) if eos is not None else None}}
        if self.scheduler is not None:
            self.scheduler.submit(item)
        else:
            self.frames.send_token_frame(
                query_id, self.worker_id,
                {"seq": 0, "tok": [], "done": True, "finish": "error",
                 "n_tokens": 0,
                 "error": "generative serving not available on this "
                          "worker"})
        return query_id

    # --- requests ---

    def submit(self, queries: List[Any]) -> Future:
        if not self.running:
            raise RuntimeError("inference worker is not running")
        fut: Future = Future()
        self._queue.put((list(queries), fut))
        return fut

    def predict(self, queries: List[Any],
                timeout: Optional[float] = None) -> List[Any]:
        return self.submit(queries).result(timeout)

    # --- serving loop ---

    def _take_batch(self, first) -> Tuple[List[Tuple[List[Any], Future]],
                                          bool]:
        """``first`` plus whatever is already queued, taken without
        waiting; the flag says a stop was asked for."""
        batch = [first]
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return batch, False
            if item is None:
                return batch, True
            batch.append(item)

    def _serve(self) -> None:
        stop = False
        while not stop:
            first = self._queue.get()
            if first is None:
                break
            batch, stop = self._take_batch(first)
            queries = [q for qs, _ in batch for q in qs]
            try:
                preds = self.model.predict(queries)
            except Exception as e:
                # One error reply per query, as the reference's worker
                # answers (``rafiki_tpu/worker/inference.py:1097-1101``,
                # :1145-1148): the predictor's ensemble skips it and
                # answers with the other workers' predictions.
                _log.exception("predict failed for %d queries", len(queries))
                preds = [{"error": f"{type(e).__name__}: {e}"}] * len(queries)
            i = 0
            for qs, fut in batch:
                fut.set_result(preds[i:i + len(qs)])
                i += len(qs)
