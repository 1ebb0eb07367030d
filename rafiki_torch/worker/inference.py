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
  ``_PackedEnsemble`` does: congruent members stacked, one dispatch a
  burst (``RAFIKI_TPU_SERVING_STACKED``, on by default), others member
  by member; with ``RAFIKI_TPU_SERVING_QUANT=int8`` every member serves
  from int8 weights. An all-packed burst of one shape and dtype is
  copied into a pinned staging buffer of its bucket (``_HostStager``)
  and served from there. With
  ``RAFIKI_TPU_SERVING_GENERATE`` on, a worker whose model can generate
  also serves token generation from the bus, its engine sized by the
  reference's ``RAFIKI_TPU_GENERATE_*`` variables.

A ``predict`` that raises answers each of its queries with
``{"error": "<Type>: <msg>"}``, as the reference's worker does, so one
failing worker does not fail the request. A burst whose frames carry
trace envelopes records one ``worker.predict`` span under each trace
(``observe.trace``), before its replies go out.

Not ported yet: the pipelined burst path, the promote route
(``/promote``, ``send_restack``: ``_PackedEnsemble.replace_member`` is
ported, the route waits for the admin's), profiling markers, the bus
reconnect loop and the worker's metrics series.
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..bus import BaseBus
from ..cache import DRAIN_KEY, WIRE_NDBATCH, Cache, TokenFrames
from ..constants import ServiceStatus
from ..model.base import BaseModel, Params
from ..observe import trace
from ..observe.wire import quant_mode, stacked_mode
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
    (the reference's ``_PackedEnsemble``, ``inference.py:111-289``).

    With a stacked group (``stacked``, ``model.stacked.stack_members``)
    a burst is one dispatch that gives every member's probabilities;
    otherwise ``predict_submit`` launches every member's work before it
    reads any back, so the members overlap on the card. Both give
    per-member finishers to ``_finish_members``: numeric predictions are
    pre-averaged in float64 and ``last_weight`` counts the members that
    answered, so the predictor's weighted mean across workers stays the
    unweighted mean over trials; other predictions go out un-combined in
    a ``__members__`` envelope, one vote a trial. A failing member drops
    only its own vote (under stacking, by the validity mask), and a
    stacked dispatch that raises serves its burst member by member,
    logged.

    ``last_mode`` is how the last burst ran: ``"stacked"``,
    ``"fallback"`` (member by member on a worker that has a stacked
    group) or ``"members"`` (no stacked group). ``dispatches`` and
    ``bursts`` count device dispatches and bursts by mode."""

    MODES = ("stacked", "fallback", "members")

    def __init__(self, models: List[Any], stacked: Optional[Any] = None):
        self.models = models
        self.stacked = stacked
        self.last_weight = len(models)
        self.last_mode = "members"
        self.dispatches = {m: 0 for m in self.MODES}
        self.bursts = {m: 0 for m in self.MODES}

    def _count(self, mode: str, n_dispatches: int) -> None:
        self.last_mode = mode
        self.dispatches[mode] += n_dispatches
        self.bursts[mode] += 1

    def _stacked_usable(self) -> bool:
        return self.stacked is not None and self.stacked.n_valid > 0

    def _per_member_mode(self) -> str:
        return "fallback" if self.stacked is not None else "members"

    def predict_submit(self, queries: List[Any]):
        if self._stacked_usable():
            try:
                handles = self.stacked.submit(queries)
            except Exception:
                _log.exception("stacked dispatch failed; serving this "
                               "burst per-member")
            else:
                self._count("stacked", len(handles))
                return self._finish_members(
                    self.stacked.member_finishers(handles), len(queries))
        finishers = []
        for m in self.models:
            submit = getattr(m, "predict_submit", None)
            try:
                finishers.append(submit(queries) if submit is not None
                                 else (lambda m=m: m.predict(queries)))
            except Exception:
                _log.exception("packed member dispatch failed; dropping "
                               "its vote")
        self._count(self._per_member_mode(), len(finishers))
        return self._finish_members(finishers, len(queries))

    def predict_bucket(self, n: int, dtype: Any = None) -> Optional[int]:
        """The staged path's bucket for the whole pack: the stacked
        group's, or the members' when they all take the burst at one
        bucket; None sends the burst down the per-query path."""
        if self._stacked_usable():
            return self.stacked.predict_bucket(n, dtype)
        buckets = set()
        for m in self.models:
            fn = getattr(m, "predict_bucket", None)
            b = fn(n, dtype) if fn is not None else None
            if b is None:
                return None
            buckets.add(b)
        return buckets.pop() if len(buckets) == 1 else None

    def predict_staged_submit(self, buf: np.ndarray, n: int):
        """A staged burst: one dispatch of the stacked group, or every
        member's from the same staging buffer."""
        if self._stacked_usable():
            try:
                handle = self.stacked.staged_submit(buf, n)
            except Exception:
                _log.exception("stacked staged dispatch failed; serving "
                               "this burst per-member")
            else:
                self._count("stacked", 1)
                return self._finish_members(
                    self.stacked.member_finishers([handle]), n)
        finishers = []
        for m in self.models:
            try:
                finishers.append(m.predict_staged_submit(buf, n))
            except Exception:
                _log.exception("packed member staged dispatch failed; "
                               "dropping its vote")
        self._count(self._per_member_mode(), len(finishers))
        return self._finish_members(finishers, n)

    def replace_member(self, index: int, model: Any) -> None:
        """The promote path's restack: swap one member while the others
        stay on the device. A stacked group copies the member's tensors
        into its slice in place (``StackedMembers.update_member``; an
        incongruent model raises before any state changes)."""
        old = self.models[index]
        if self.stacked is not None:
            self.stacked.update_member(index, model)
        self.models[index] = model
        try:
            old.destroy()
        except Exception:
            _log.exception("replaced member destroy failed")

    def _finish_members(self, finishers: List[Any], n: int):
        """The gather half of every dispatch path: per-member fault
        isolation, float64 pre-averaging, ``__members__`` envelopes."""

        def finish() -> List[Any]:
            member_preds = []
            for f in finishers:
                try:
                    member_preds.append(f())
                except Exception:
                    _log.exception("packed member predict failed; "
                                   "dropping its vote")
            if not member_preds:
                raise RuntimeError("every packed ensemble member failed")
            self.last_weight = len(member_preds)
            out = []
            for i in range(n):
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

        return finish

    def predict(self, queries: List[Any]) -> List[Any]:
        return self.predict_submit(queries)()

    def warmup(self) -> None:
        """Build the runners that will serve: the stacked group's, or
        each member's."""
        if self.stacked is not None:
            self.stacked.warmup()
            return
        for m in self.models:
            warm = getattr(m, "warmup", None)
            if warm is not None:
                warm()

    def destroy(self) -> None:
        if self.stacked is not None:
            self.stacked.destroy()
        for m in self.models:
            m.destroy()


class _HostStager:
    """Reusable host staging buffers, two a ``(bucket, shape, dtype)``,
    made on first use and kept (the buckets are a power-of-two ladder).
    On the card they are pinned (``torch.empty(..., pin_memory=True)``
    viewed as numpy), so the copy to a runner's static input is
    asynchronous; rows past a burst's count keep stale bytes, whose
    outputs are sliced away. Two are enough: a burst's finisher reads
    its results back, which orders the copy out of its buffer before
    the burst after next refills it."""

    def __init__(self, device):
        self.pinned = torch.device(device).type == "cuda"
        #: The registration's ``staging``: ``pinned`` or ``pageable``.
        self.mode = "pinned" if self.pinned else "pageable"
        self._bufs: Dict[Any, list] = {}

    def _new(self, bucket: int, shape: tuple, dtype) -> np.ndarray:
        if not self.pinned:
            return np.empty((bucket, *shape), dtype)
        t = torch.empty((bucket, *shape),
                        dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                        pin_memory=True)
        return t.numpy()

    def buffer(self, bucket: int, shape: tuple, dtype) -> np.ndarray:
        key = (bucket, tuple(shape), np.dtype(dtype).str)
        entry = self._bufs.get(key)
        if entry is None:
            entry = [self._new(bucket, shape, dtype),
                     self._new(bucket, shape, dtype), 0]
            self._bufs[key] = entry
        entry[2] ^= 1
        return entry[entry[2]]


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
        self._quant_req = quant_mode()
        self._quant_active = False
        self._stacked_req = stacked_mode()
        self._stacked_active = False
        self._stager = _HostStager(self.device)
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
        """One trial's model on this worker's device (quantised for
        serving when ``RAFIKI_TPU_SERVING_QUANT`` asks), and its
        score."""
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
        if self._quant_req:
            enable = getattr(model, "enable_serving_quant", None)
            if enable is None:
                _log.warning("trial %s: %s has no serving quantization; "
                             "serving f32", tid, type(model).__name__)
            else:
                report = enable(self._quant_req)
                self._quant_active = True
                _log.info("trial %s quantized for serving: mode=%s int8=%d "
                          "f32-fallback=%d", tid, report["mode"],
                          report.get("n_int8", 0), report.get("n_f32", 0))
        return model, score

    def _load_model(self) -> Tuple[Any, Optional[float]]:
        """The bin's model (a ``_PackedEnsemble`` for several trials,
        stacked when ``RAFIKI_TPU_SERVING_STACKED`` is on and the members
        are congruent) and its score, the best of its members'."""
        models, scores = [], []
        for tid in str(self.trial_id).split(","):
            model, score = self._load_member(tid)
            models.append(model)
            if score is not None:
                scores.append(score)
        score = max(scores) if scores else None
        if len(models) == 1:
            return models[0], score
        stacked = None
        if self._stacked_req:
            from ..model.stacked import stack_members

            stacked = stack_members(models)
            if stacked is not None:
                _log.info("inference worker %s: %d same-family members "
                          "stacked, one dispatch a burst", self.service_id,
                          stacked.n_members)
        self._stacked_active = stacked is not None
        return _PackedEnsemble(models, stacked=stacked), score

    # --- The loop ---

    def run(self) -> None:
        try:
            self.model, score = self._load_model()
            # The runners (CUDA graphs on the card) are built before the
            # worker takes traffic.
            warm = getattr(self.model, "warmup", None)
            if warm is not None:
                warm()
            gen_info = self._start_generate()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.RUNNING)
            # The bin rides the registration, so the predictor treats
            # same-bin workers as replicas; "wire" offers the packed
            # format; "gen" the engine geometry /generate picks by;
            # "quant", "stacked" and "staging" say how the bin serves.
            self.cache.register_worker(
                self.inference_job_id, self.service_id,
                info={"trial_id": self.trial_id, "score": score,
                      "wire": [WIRE_NDBATCH], "gen": gen_info,
                      "quant": (self._quant_req if self._quant_active
                                else None),
                      "stacked": self._stacked_active,
                      "staging": self._stager.mode})
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
        predict, each shard answered with its slice. A corrupt packed
        shard is answered with per-query errors at once. An all-packed
        burst of one shape and dtype is copied, a frame at a time, into
        the staging buffer of its bucket and served from there
        (``predict_staged_submit``); any other burst goes through
        ``predict`` query by query."""
        trace_ctxs = trace.extract_frames(items)
        wall, t0 = time.time(), time.monotonic()
        good = []
        for it in items:
            if "batch" in it and it["batch"] is None:
                err = {"error": "ValueError: " + it.get(
                    "batch_error", "corrupt packed frame")}
                self.cache.send_prediction_batch(
                    it["batch_id"], self.service_id,
                    [err] * max(1, int(it.get("n", 1) or 1)),
                    shard=it.get("shard"))
            else:
                good.append(it)
        if not good:
            return
        spans, preds = self._staged(good)
        if spans is None:
            flat: List[Any] = []
            spans = []  # (item, start, count)
            for it in good:
                rows = it["batch"] if "batch" in it else it["queries"]
                spans.append((it, len(flat), len(rows)))
                flat.extend(rows[i] for i in range(len(rows)))
            try:
                preds = self.model.predict(flat) if flat else []
            except Exception as e:
                _log.exception("predict failed for %d queries", len(flat))
                preds = [{"error": f"{type(e).__name__}: {e}"}] * len(flat)
        if trace_ctxs:
            trace.record_event(
                "worker.predict", self.service_id, trace_ctxs, wall,
                time.monotonic() - t0,
                attrs={"n_queries": len(preds),
                       "trial_id": str(self.trial_id)})
        weight = int(getattr(self.model, "last_weight", 1))
        for it, start, count in spans:
            self.cache.send_prediction_batch(
                it["batch_id"], self.service_id,
                preds[start:start + count], weight=weight,
                shard=it.get("shard"),
                packed_ok=WIRE_NDBATCH in (it.get("rw") or ()))

    def _staged(self, items: List[Dict[str, Any]]):
        """``(spans, predictions)`` of the staged path, or ``(None,
        None)`` when the burst cannot take it."""
        arrays = [it.get("batch") for it in items]
        if not all(isinstance(a, np.ndarray) for a in arrays):
            return None, None
        first = arrays[0]
        if any(a.shape[1:] != first.shape[1:] or a.dtype != first.dtype
               for a in arrays[1:]):
            return None, None
        bucket_fn = getattr(self.model, "predict_bucket", None)
        total = sum(a.shape[0] for a in arrays)
        bucket = bucket_fn(total, first.dtype) if bucket_fn else None
        if bucket is None:
            return None, None
        buf = self._stager.buffer(bucket, first.shape[1:], first.dtype)
        spans, start = [], 0
        for it, a in zip(items, arrays):
            spans.append((it, start, a.shape[0]))
            buf[start:start + a.shape[0]] = a
            start += a.shape[0]
        try:
            preds = self.model.predict_staged_submit(buf, total)()
        except Exception as e:
            _log.exception("staged predict failed for %d queries", total)
            preds = [{"error": f"{type(e).__name__}: {e}"}] * total
        return spans, preds

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
