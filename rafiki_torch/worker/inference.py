"""Inference workers of the port: trained models serving ``predict``
(and token generation) on their device.

Two workers share this module:

- ``InferenceWorker`` serves one model in the caller's process: it
  loads the model on its device, takes queries from an in-process
  queue, hands what is already waiting to one ``model.predict`` call
  without waiting for more, and gives each caller its own predictions.
  Built with ``generate=`` (the engine configuration: ``page_size``,
  ``n_pages``, ``decode_batch``, ``max_new_cap``,
  ``prefix_cache_entries``) it also serves token generation: it builds
  the model's paged-KV engine and a ``DecodeScheduler`` whose loop runs
  on its own thread, and the token frames of each request come back
  through ``frames``, a ``TokenFrames`` cache. Where the reference logs
  a failed engine construction and serves on without generation, this
  worker raises: a worker asked to generate that cannot is a fault.
- ``BusInferenceWorker`` is the platform's inference service, the
  counterpart of the reference's ``InferenceWorker``
  (``rafiki_tpu/worker/inference.py``): it loads the trials of its bin
  from the meta and param stores onto its chip group's device,
  registers on the bus (``Cache.register_worker``), pops query shards,
  predicts, replies with ``send_prediction_batch`` and honours the
  drain marker. A bin of several trials (``"a,b"``, packed onto one
  chip group when groups are short) is served as the reference's
  ``_PackedEnsemble`` does, member by member. With
  ``RAFIKI_TPU_SERVING_GENERATE`` on, a worker whose model can generate
  also serves token generation from the bus, its engine sized by the
  reference's ``RAFIKI_TPU_GENERATE_*`` variables.

A ``predict`` that raises answers each of its queries with
``{"error": "<Type>: <msg>"}``, as the reference's worker does, so one
failing worker does not fail the request.

Not ported yet: stacked members (``stack_members``, ROADMAP item 4),
the staged and pipelined burst paths, int8 serving, promotion restacks,
profiling markers, the bus reconnect loop and the metrics and trace
hooks.
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np

from ..bus import BaseBus
from ..cache import DRAIN_KEY, WIRE_NDBATCH, Cache, TokenFrames
from ..constants import ServiceStatus
from ..model.base import BaseModel, Params
from ..parallel.chips import ChipGroup
from ..store import MetaStore, ParamStore
from ..torchenv import DeviceLike, resolve_device
from ..utils.model_loader import load_model_class
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


class _PackedEnsemble:
    """Several trial models sharing one chip group, served as one unit
    (the reference's ``_PackedEnsemble``, per member: stacking waits
    for ROADMAP item 4).

    ``predict`` launches every member's work (``predict_submit`` where
    the model has one) before reading any back, so the members overlap
    on the card. Numeric predictions are pre-averaged in float64 and
    ``last_weight`` counts the members that answered, so the predictor's
    weighted mean across workers stays the unweighted mean over trials;
    other predictions go out un-combined in a ``__members__`` envelope,
    one vote a trial. A failing member drops only its own vote."""

    def __init__(self, models: List[Any]):
        self.models = models
        self.last_weight = len(models)

    def predict(self, queries: List[Any]) -> List[Any]:
        finishers = []
        for m in self.models:
            submit = getattr(m, "predict_submit", None)
            try:
                finishers.append(submit(queries) if submit is not None
                                 else (lambda m=m: m.predict(queries)))
            except Exception:
                _log.exception("packed member dispatch failed; dropping "
                               "its vote")
        member_preds = []
        for f in finishers:
            try:
                member_preds.append(f())
            except Exception:
                _log.exception("packed member predict failed; dropping "
                               "its vote")
        if not member_preds:
            raise RuntimeError("every packed ensemble member failed")
        self.last_weight = len(member_preds)
        out = []
        for i in range(len(queries)):
            votes = [p[i] for p in member_preds]
            try:
                arr = np.asarray(votes, dtype=np.float64)
                if not np.isnan(arr).any():
                    out.append(np.mean(arr, axis=0).tolist())
                    continue
            except (ValueError, TypeError):
                pass
            out.append({"__members__": votes})
        return out

    def destroy(self) -> None:
        for m in self.models:
            m.destroy()


def _generate_config() -> Optional[Dict[str, int]]:
    """The engine geometry a bus worker generates with, from the
    reference's variables, or None when ``RAFIKI_TPU_SERVING_GENERATE``
    is off (absent or a falsy spelling)."""
    gate = os.environ.get("RAFIKI_TPU_SERVING_GENERATE", "")
    if gate.strip().lower() in ("", "0", "false", "no", "off"):
        return None
    env = os.environ.get
    return {"page_size": int(env("RAFIKI_TPU_GENERATE_PAGE_SIZE", "16")),
            "n_pages": int(env("RAFIKI_TPU_GENERATE_POOL_PAGES", "256")),
            "decode_batch": int(env("RAFIKI_TPU_GENERATE_DECODE_BATCH",
                                    "8")),
            "max_new_cap": int(env("RAFIKI_TPU_GENERATE_MAX_NEW", "128"))}


class BusInferenceWorker:
    """The platform's inference service: serves one trial bin from the
    bus on its chip group's device. Each pop waits up to
    ``BATCH_TIMEOUT`` seconds for a first frame and takes up to
    ``MAX_BATCH`` frames.

    ``trial_id`` is one trial id, or several joined by commas when the
    services manager packed them onto one chip group. ``start()`` runs
    ``run()`` on a thread: load the bin, mark the service RUNNING,
    register, serve until ``stop()`` or a drain marker, then mark it
    STOPPED and unregister (ERRORED when it crashes)."""

    BATCH_TIMEOUT = 0.5
    MAX_BATCH = 512

    def __init__(self, service_id: str, inference_job_id: str,
                 trial_id: str, meta: MetaStore, params: ParamStore,
                 bus: BaseBus, chips: Optional[ChipGroup] = None, *,
                 device: DeviceLike = None):
        self.service_id = service_id
        self.inference_job_id = inference_job_id
        self.trial_id = trial_id
        self.meta = meta
        self.params = params
        self.cache = Cache(bus)
        self.chips = chips
        self.device = chips.device if chips is not None \
            else resolve_device(device)
        self._gen_cfg = _generate_config()
        self._gen_sched: Optional[DecodeScheduler] = None
        self._gen_thread: Optional[threading.Thread] = None
        self.stop_flag = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.model: Optional[Any] = None

    # --- Lifecycle ---

    def start(self) -> "BusInferenceWorker":
        self._thread = threading.Thread(
            target=self.run, name=f"infer-{self.service_id[:8]}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        self.stop_flag.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # --- Setup ---

    def _load_member(self, tid: str) -> Tuple[Any, Optional[float]]:
        """One trial's model on this worker's device, and its score."""
        trial = self.meta.get_trial(tid)
        if trial is None:
            raise ValueError(f"unknown trial {tid}")
        score = (float(trial["score"])
                 if isinstance(trial.get("score"), (int, float)) else None)
        row = self.meta.get_model(trial["model_id"])
        model_class = load_model_class(row["model_class"],
                                       row.get("model_source"))
        model = model_class(device=self.device,
                            **model_class.validate_knobs(trial["knobs"]))
        model.load_parameters(self.params.load(trial["params_id"]))
        return model, score

    def _load_model(self) -> Tuple[Any, Optional[float]]:
        """The bin's model (a ``_PackedEnsemble`` for several trials)
        and its score, the best of its members'."""
        models, scores = [], []
        for tid in str(self.trial_id).split(","):
            model, score = self._load_member(tid)
            models.append(model)
            if score is not None:
                scores.append(score)
        score = max(scores) if scores else None
        if len(models) == 1:
            return models[0], score
        return _PackedEnsemble(models), score

    # --- The loop ---

    def run(self) -> None:
        try:
            self.model, score = self._load_model()
            gen_info = self._start_generate()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.RUNNING)
            # The bin rides the registration, so the predictor treats
            # same-bin workers as replicas; "wire" offers the packed
            # format; "gen" the engine geometry /generate picks by.
            self.cache.register_worker(
                self.inference_job_id, self.service_id,
                info={"trial_id": self.trial_id, "score": score,
                      "wire": [WIRE_NDBATCH], "gen": gen_info})
        except Exception:
            _log.exception("inference worker %s failed to start",
                           self.service_id)
            self._stop_generate()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.ERRORED)
            raise
        try:
            while not self.stop_flag.is_set():
                items = self.cache.pop_queries(
                    self.service_id, max_items=self.MAX_BATCH,
                    timeout=self.BATCH_TIMEOUT)
                draining = any(DRAIN_KEY in it for it in items)
                for it in items:
                    if it.get("op") == "generate":
                        self._route_generate(it)
                self._serve([it for it in items if DRAIN_KEY not in it
                             and it.get("op") != "generate"])
                if draining:
                    _log.info("inference worker %s drained",
                              self.service_id)
                    break
            self._stop_generate()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.STOPPED)
        except Exception:
            _log.exception("inference worker %s crashed", self.service_id)
            self._stop_generate()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.ERRORED)
            raise
        finally:
            self.cache.unregister_worker(self.inference_job_id,
                                         self.service_id)
            if self.model is not None:
                self.model.destroy()

    def _serve(self, items: List[Dict[str, Any]]) -> None:
        """One burst: every query of the popped shards through ONE
        ``predict``, each shard answered with its slice. A corrupt
        packed shard is answered with per-query errors at once."""
        flat: List[Any] = []
        spans = []  # (item, start, count)
        for it in items:
            if "batch" in it and it["batch"] is None:
                err = {"error": "ValueError: " + it.get(
                    "batch_error", "corrupt packed frame")}
                self.cache.send_prediction_batch(
                    it["batch_id"], self.service_id,
                    [err] * max(1, int(it.get("n", 1) or 1)),
                    shard=it.get("shard"))
                continue
            rows = it["batch"] if "batch" in it else it["queries"]
            spans.append((it, len(flat), len(rows)))
            flat.extend(rows[i] for i in range(len(rows)))
        if not spans:
            return
        try:
            preds = self.model.predict(flat) if flat else []
        except Exception as e:
            _log.exception("predict failed for %d queries", len(flat))
            preds = [{"error": f"{type(e).__name__}: {e}"}] * len(flat)
        weight = int(getattr(self.model, "last_weight", 1))
        for it, start, count in spans:
            self.cache.send_prediction_batch(
                it["batch_id"], self.service_id,
                preds[start:start + count], weight=weight,
                shard=it.get("shard"),
                packed_ok=WIRE_NDBATCH in (it.get("rw") or ()))

    # --- Generative serving ---

    def _start_generate(self) -> Optional[Dict[str, int]]:
        """Build the engine and its decode loop when generation is on
        and the model can generate; returns the registration's ``gen``
        (the engine geometry), or None. A model without
        ``make_generator`` serves without it, as the reference's does;
        a failed engine build is a fault and raises."""
        if self._gen_cfg is None:
            return None
        make = getattr(self.model, "make_generator", None)
        if make is None:
            _log.info("inference worker %s: %s cannot generate; serving "
                      "predict only", self.service_id,
                      type(self.model).__name__)
            return None
        self._gen_sched = DecodeScheduler(make(**self._gen_cfg),
                                          self.cache, self.service_id)
        self._gen_thread = threading.Thread(
            target=self._gen_sched.loop,
            name=f"decode-{self.service_id[:8]}", daemon=True)
        self._gen_thread.start()
        return dict(self._gen_cfg)

    def _route_generate(self, item: Dict[str, Any]) -> None:
        """Hand one generate frame to the decode loop; a worker that does
        not generate answers with one error frame, so the caller fails
        fast instead of timing out."""
        if self._gen_sched is not None:
            self._gen_sched.submit(item)
            return
        self.cache.send_token_frame(
            item["query_id"], self.service_id,
            {"seq": 0, "tok": [], "done": True, "finish": "error",
             "n_tokens": 0,
             "error": "generative serving not available on this worker"})

    def _stop_generate(self) -> None:
        """Stop the decode loop, join its thread and release the
        engine's pages; idempotent."""
        sched, self._gen_sched = self._gen_sched, None
        thread, self._gen_thread = self._gen_thread, None
        if sched is not None:
            sched.close(join=thread)
