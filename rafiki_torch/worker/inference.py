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
  predicts, replies with ``send_prediction_batch`` (a single query of
  ``Cache.send_query`` with ``send_prediction``) and honours the drain
  marker. Its registration offers the packed wire (``"wire":
  ["ndbatch1"]``) only when ``RAFIKI_TPU_SERVING_PACKED_WIRE`` is on
  when it is built. A bin of several trials (``"a,b"``, packed onto one
  chip group when groups are short) is served as the reference's
  ``_PackedEnsemble`` does: congruent members stacked, one dispatch a
  burst (``RAFIKI_TPU_SERVING_STACKED``, on by default), others member
  by member; with ``RAFIKI_TPU_SERVING_QUANT=int8`` every member serves
  from int8 weights. An all-packed burst of one shape and dtype is
  copied into a pinned staging buffer of its bucket
  (``parallel.transfer.HostStager``)
  and served from there. With
  ``RAFIKI_TPU_SERVING_GENERATE`` on, a worker whose model can generate
  also serves token generation from the bus, its engine sized by the
  reference's ``RAFIKI_TPU_GENERATE_*`` variables.

The bus worker's lifecycle, as the reference's:

- **Pipelining.** A burst is dispatched (``_dispatch_batch``) and later
  completed (``_complete_batch``: read back, reply). With pipelining on,
  burst N+1 is dispatched before burst N completes, so N's readback
  hides behind N+1's device work. ``RAFIKI_TPU_SERVING_PIPELINE`` is
  ``1``, ``0`` or ``auto`` (the default): auto measures the device's
  sync round trip at start-up and pipelines when it is at least
  ``RAFIKI_TPU_PIPELINE_SYNC_MIN`` seconds. The registration carries
  ``pipeline`` and the measured ``sync_latency_ms``.
- **Restacks.** A ``__restack__`` marker (``Cache.send_restack``, from
  the admin's promote) swaps one member of a stacked bin in place after
  the burst it arrived with: the incoming trial's model is loaded and
  copied into the stacked group's storage (``replace_member``), so no
  runner is rebuilt; the meta mapping row follows the new bin and the
  registration is re-asserted with it. A restack that fails leaves the
  old member set serving and the old registration standing, which the
  admin reads as the failure. ``__drain__`` serves what came before it
  and exits.
- **Confidence.** With ``RAFIKI_TPU_SERVING_TIER_THRESHOLD`` above 0,
  each reply carries each query's softmax margin
  (``prediction_confidence``) and the slice's device seconds, for a
  tiering predictor.
- **Attribution.** With the ledger on, each burst's device seconds go
  to the worker's ``(job, bin)`` with the dispatch mode, and are
  prorated over the tenants its frames carried.

A ``predict`` that raises answers each of its queries with
``{"error": "<Type>: <msg>"}``, as the reference's worker does, so one
failing worker does not fail the request. A burst whose frames carry
trace envelopes records one ``worker.predict`` span under each trace
(``observe.trace``), before its replies go out.

A ``__profile__`` marker (``Cache.send_profile``, from the admin's
``profile_inference_job``) starts a bounded ``torch.profiler`` session
between bursts (``observe.profiling.start_device_profile``); the serve
loop stops it once its deadline passes, or when the loop ends. The loop
also resolves, each lap, the held spans of traces minted in another
process (``trace.flush_remote_expired``).

The worker outlives its bus. A broker keeps its queues and registry in
memory, so a restarted broker has forgotten every registration: the
worker re-asserts its registration every ``RAFIKI_TPU_WORKER_REREGISTER``
seconds (5 by default), and a bus failure in the serve loop (the broker
gone mid-pop) is absorbed: the burst in flight is completed if it can
be, the worker waits a second, registers again and serves on, without a
supervise restart. A broker that keeps REPORTING failures
(``BusOpError``: a protocol mismatch, not an outage) for more than
``RAFIKI_TPU_WORKER_MAX_OP_ERRORS`` laps in a row (30) with no good lap
between is a fault: the loop raises and the service goes ERRORED.
``kill()`` is the hard stop: the worker leaves its row RUNNING and its
registration standing, what a dead node leaves, so the supervise sweep
is what notices.

The bus worker is a ``worker`` fault site (``faults.site_hook``,
resolved when it is built; None when the plane is disarmed), asked
before each burst's dispatch: ``worker.slow`` sleeps there, and
``worker.crash`` raises ``InjectedCrash``, which kills the serve loop as
``kill()`` does (row left RUNNING, registration stale, the burst in
flight lost). ``queries_served`` counts the queries its bursts took to
the device.

On the cluster fabric the registration carries ``node``, the id of the
node that placed the worker (its service environment's
``RAFIKI_TPU_NODE_ID``); a shard that came from another node carries
that node's id (``onode``), and its reply is relayed back there.
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

from .. import faults
from ..bus import BaseBus, BusOpError
from ..cache import (DRAIN_KEY, PROFILE_KEY, RESTACK_KEY, WIRE_NDBATCH,
                     Cache, TokenFrames)
from ..config import parse_tristate_bool
from ..constants import ServiceStatus
from ..model.base import BaseModel, Params
from ..observe import attribution as _attr
from ..observe import lm as _lm_obs
from ..observe import profiling
from ..observe import trace
from ..observe import wire as _wire
from ..parallel.chips import ChipGroup
from ..parallel.transfer import HostStager
from ..store import MetaStore, ParamStore
from ..torchenv import DeviceLike, resolve_device
from ..utils.model_loader import load_model_class
from .decode_scheduler import DecodeScheduler

_log = logging.getLogger(__name__)


def prediction_confidence(pred: Any) -> Optional[float]:
    """A query's confidence for tiered serving: the softmax margin (top-1
    minus top-2 probability) of a flat numeric vector, else None (labels,
    ``__members__`` envelopes and error replies escalate)."""
    try:
        if isinstance(pred, np.ndarray):
            arr = pred
        elif isinstance(pred, (list, tuple)) and len(pred) >= 2 and \
                not isinstance(pred[0], (list, tuple, dict, str)):
            arr = np.asarray(pred)
        else:
            return None
        if arr.ndim != 1 or arr.size < 2 or \
                not np.issubdtype(arr.dtype, np.number):
            return None
        arr = arr.astype(np.float64, copy=False)
        if not np.isfinite(arr).all():
            return None
        top2 = np.partition(arr, arr.size - 2)[-2:]
        return float(top2[1] - top2[0])
    except (TypeError, ValueError):
        return None


def sync_latency(device: torch.device, n: int = 3) -> float:
    """Best of ``n`` round trips of a tiny dispatch on ``device`` read
    back to the host: the latency a pipelined worker hides."""
    x = torch.zeros((8, 8), dtype=torch.float32, device=device)
    float((x + 1.0).sum())  # the first launch outside the timing
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        float((x + 1.0).sum())
        best = min(best, time.perf_counter() - t0)
    return best


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

    def _count(self, mode: str, n_dispatches: int, n_queries: int) -> None:
        """One burst's mode, counted here and, for a worker that has a
        stacked group, in the serving dispatch series."""
        self.last_mode = mode
        self.dispatches[mode] += n_dispatches
        self.bursts[mode] += 1
        if mode != "members":
            _wire.count_stacked_dispatch(mode, n_dispatches)
            _wire.observe_dispatches_per_query(n_dispatches, n_queries)

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
                self._count("stacked", len(handles), len(queries))
                return self._finish_members(
                    self.stacked.member_finishers(handles), len(queries))
        finishers = []
        for m in self.models:
            try:
                finishers.append(m.predict_submit(queries))
            except Exception:
                _log.exception("packed member dispatch failed; dropping "
                               "its vote")
        self._count(self._per_member_mode(), len(finishers), len(queries))
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
                self._count("stacked", 1, n)
                return self._finish_members(
                    self.stacked.member_finishers([handle]), n)
        finishers = []
        for m in self.models:
            try:
                finishers.append(m.predict_staged_submit(buf, n))
            except Exception:
                _log.exception("packed member staged dispatch failed; "
                               "dropping its vote")
        self._count(self._per_member_mode(), len(finishers), n)
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


def _generate_config() -> Optional[Dict[str, int]]:
    """The engine geometry a bus worker generates with, from the
    reference's variables, or None when ``RAFIKI_TPU_SERVING_GENERATE``
    is off (absent or a falsy spelling)."""
    if not _lm_obs.generate_enabled():
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
    ``BATCH_TIMEOUT`` seconds for a first frame (none while a burst is
    in flight) and takes up to ``MAX_BATCH`` frames.

    ``trial_id`` is one trial id, or several joined by commas when the
    services manager packed them onto one chip group. ``pipeline`` is
    True, False or None (auto); None reads
    ``RAFIKI_TPU_SERVING_PIPELINE``. ``start()`` runs ``run()`` on a
    thread: load the bin, mark the service RUNNING, register, serve
    until ``stop()`` or a drain marker, then mark it STOPPED and
    unregister (ERRORED when it crashes)."""

    BATCH_TIMEOUT = 0.5
    MAX_BATCH = 512

    def __init__(self, service_id: str, inference_job_id: str,
                 trial_id: str, meta: MetaStore, params: ParamStore,
                 bus: BaseBus, chips: Optional[ChipGroup] = None, *,
                 device: DeviceLike = None,
                 pipeline: Optional[bool] = None, node: str = ""):
        self.service_id = service_id
        # The placing node's id on the cluster fabric, "" off it.
        self.node = node
        self.inference_job_id = inference_job_id
        self.trial_id = trial_id
        self.meta = meta
        self.params = params
        self.cache = Cache(bus)
        self.chips = chips
        self.device = chips.device if chips is not None \
            else resolve_device(device)
        if pipeline is None:
            pipeline = parse_tristate_bool(os.environ.get(
                "RAFIKI_TPU_SERVING_PIPELINE", "auto"))
        self.pipeline = pipeline
        self.pipeline_sync_min = float(os.environ.get(
            "RAFIKI_TPU_PIPELINE_SYNC_MIN", "0.02"))
        #: The measured sync round trip (ms) of an auto decision.
        self.sync_ms: Optional[float] = None
        # Confidence rides the replies only for a tiering predictor.
        self.send_confidence = float(os.environ.get(
            "RAFIKI_TPU_SERVING_TIER_THRESHOLD", "0") or 0) > 0
        self._gen_cfg = _generate_config()
        # The packed wire is offered ("wire" in the registration) only
        # when RAFIKI_TPU_SERVING_PACKED_WIRE is on at construction.
        self._wire_formats = ([WIRE_NDBATCH]
                              if _wire.packed_wire_mode() == "on" else [])
        self._quant_req = _wire.quant_mode()
        self._quant_active = False
        self._stacked_req = _wire.stacked_mode()
        self._stacked_active = False
        self._stager = HostStager(self.device)
        self._gen_sched: Optional[DecodeScheduler] = None
        self._gen_thread: Optional[threading.Thread] = None
        self._reg_info: Dict[str, Any] = {}
        self._attr_closed = False
        # The registration is a lease, re-asserted this often.
        self.reregister_interval = float(os.environ.get(
            "RAFIKI_TPU_WORKER_REREGISTER", "5.0"))
        # Reported bus failures in a row before the worker errors out.
        self.max_op_errors = int(os.environ.get(
            "RAFIKI_TPU_WORKER_MAX_OP_ERRORS", "30"))
        # Set by kill(): the loop's exit skips the clean shutdown.
        self.hard_killed = False
        self.stop_flag = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.model: Optional[Any] = None
        # The on-demand profile session in progress (almost always
        # None), stopped by the serve loop at its deadline.
        self._profile: Optional[profiling.DeviceProfileSession] = None
        #: Queries this worker's bursts took to the device.
        self.queries_served = 0
        # None when the fault plane is disarmed.
        self._fault = faults.site_hook("worker")

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

    def kill(self, join_timeout: float = 10.0) -> None:
        """The hard stop: the serve loop exits at its next pop and the
        worker dies without marking its row or unregistering (a burst
        already in flight still completes)."""
        # rta: disable=RTA106 monotonic one-way bool (False -> True once) read by the serve loop after it exits — the documented benign flag case
        self.hard_killed = True
        self.stop_flag.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # --- Setup ---

    def _load_member(self, tid: str) -> Tuple[Any, Optional[float]]:
        """One trial's model on this worker's device (quantised for
        serving when ``RAFIKI_TPU_SERVING_QUANT`` asks), and its score.
        The first load and a restack share it, so a restacked member
        is quantised as a fresh worker's would be."""
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
        from ..utils.service_logs import bind_service_log

        bind_service_log(getattr(self, "log_path", None))
        # The group's devices for every mesh a model builds on this
        # thread (ref :565-566); unbound on the way out.
        if self.chips is not None:
            self.chips.bind_to_thread()
        try:
            self.model, score = self._load_model()
            # The runners (CUDA graphs on the card) are built before the
            # worker takes traffic.
            warm = getattr(self.model, "warmup", None)
            if warm is not None:
                warm()
            if self.pipeline is None:
                latency = sync_latency(self.device)
                self.sync_ms = round(latency * 1e3, 3)
                self.pipeline = latency >= self.pipeline_sync_min
                _log.info("inference worker %s: sync latency %.3f ms -> "
                          "pipelining %s", self.service_id, latency * 1e3,
                          "on" if self.pipeline else "off")
            gen_info = self._start_generate()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.RUNNING)
            # The bin rides the registration, so the predictor treats
            # same-bin workers as replicas and ranks bins by "score";
            # "wire" offers the packed format; "gen" the engine geometry
            # /generate picks by; "pipeline", "quant", "stacked" and
            # "staging" say how the bin serves (the admin restacks only
            # a stacked bin).
            self._reg_info = {
                "trial_id": self.trial_id, "score": score,
                "pipeline": bool(self.pipeline),
                "sync_latency_ms": self.sync_ms,
                "wire": self._wire_formats, "gen": gen_info,
                "quant": (self._quant_req if self._quant_active
                          else None),
                "stacked": self._stacked_active,
                "staging": self._stager.mode,
                "node": self.node or None}
            self.cache.register_worker(self.inference_job_id,
                                       self.service_id, info=self._reg_info)
            _attr.open_owner()
        except Exception:
            _log.exception("inference worker %s failed to start",
                           self.service_id)
            self._stop_generate()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.ERRORED)
            if self.chips is not None:
                ChipGroup.unbind_thread()
            raise
        killed = False
        try:
            self._serve_loop()
            self._stop_generate()
            self._close_attr_owner()
            if self.hard_killed:
                # A dead node's wreckage: the row stays RUNNING and the
                # registration stale; what is the process's own goes.
                killed = True
                _log.error("inference worker %s killed: row left RUNNING, "
                           "registration stale", self.service_id)
                return
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.STOPPED)
        except faults.InjectedCrash:
            # The injected kill -9: as kill(), what the process held
            # goes, and the row and the registration are left to the
            # supervise sweep.
            killed = True
            self._stop_generate()
            self._close_attr_owner()
            _log.error("inference worker %s: injected crash; row left "
                       "RUNNING, registration stale", self.service_id)
        except Exception:
            _log.exception("inference worker %s crashed", self.service_id)
            self._stop_generate()
            self._close_attr_owner()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.ERRORED)
            raise
        finally:
            self._stop_profile()
            if not killed:
                self._unregister_best_effort()
            if self.model is not None:
                self.model.destroy()
            if self.chips is not None:
                ChipGroup.unbind_thread()

    def _unregister_best_effort(self) -> None:
        """Drop the registration on the way out; a broker that is gone
        forgot it anyway."""
        try:
            self.cache.unregister_worker(self.inference_job_id,
                                         self.service_id)
        except (ConnectionError, OSError, RuntimeError):
            pass

    def _start_profile(self, req: Any) -> None:
        """Apply one ``__profile__`` marker: begin a bounded device
        profile. A malformed request, a session already running here or
        a busy profiler skips it; serving goes on either way."""
        out_dir = req.get("dir") if isinstance(req, dict) else None
        if not out_dir:
            _log.warning("inference worker %s: malformed profile request "
                         "%r; ignoring", self.service_id, req)
            return
        if self._profile is not None:
            _log.info("inference worker %s: a profile session is already "
                      "running; request for %s skipped", self.service_id,
                      out_dir)
            return
        try:
            duration = float(req.get("duration_s", 5.0) or 5.0)
        except (TypeError, ValueError):
            duration = 5.0
        self._profile = profiling.start_device_profile(out_dir, duration)

    def _stop_profile(self) -> None:
        if self._profile is not None:
            self._profile.stop()
            self._profile = None

    def _serve_loop(self) -> None:
        """Pop, dispatch, complete. With pipelining on, the burst just
        dispatched stays pending while the next pop (which does not
        wait) and dispatch run; markers apply after the burst they came
        with, in queue order. The registration is re-asserted every
        ``reregister_interval`` seconds; a bus failure costs the burst
        in flight at most (its clients time out and retry), then a
        second's wait and a new registration."""
        pending = None
        last_reg = time.monotonic()
        op_errors = 0
        while not self.stop_flag.is_set():
            try:
                if time.monotonic() - last_reg >= self.reregister_interval:
                    self.cache.register_worker(self.inference_job_id,
                                               self.service_id,
                                               info=self._reg_info)
                    last_reg = time.monotonic()
                items = self.cache.pop_queries(
                    self.service_id, max_items=self.MAX_BATCH,
                    timeout=(0.0 if pending is not None
                             else self.BATCH_TIMEOUT))
                draining = any(DRAIN_KEY in it for it in items)
                restacks = [it[RESTACK_KEY] for it in items
                            if RESTACK_KEY in it]
                for it in items:
                    if PROFILE_KEY in it:
                        self._start_profile(it[PROFILE_KEY])
                    elif it.get("op") == "generate":
                        self._route_generate(it)
                items = [it for it in items if DRAIN_KEY not in it
                         and RESTACK_KEY not in it
                         and PROFILE_KEY not in it
                         and it.get("op") != "generate"]
                handle = self._dispatch_batch(items) if items else None
                # Everything queued before a restack marker, this burst
                # included, was dispatched to the old member set.
                for req in restacks:
                    self._restack_member(req)
                    last_reg = time.monotonic()
                if not self.pipeline and handle is not None:
                    self._complete_batch(*handle)
                    handle = None
                if pending is not None:
                    self._complete_batch(*pending)
                pending = handle
                op_errors = 0
                # Held spans resolve on span writes; an idle worker
                # writes none, so sweep here (one lock check when
                # nothing waits).
                trace.flush_remote_expired()
                if self._profile is not None and \
                        self._profile.expired(time.monotonic()):
                    self._stop_profile()
                if draining:
                    _log.info("inference worker %s drained",
                              self.service_id)
                    break
            except (ConnectionError, OSError, RuntimeError) as e:
                # A transport failure heals when the broker is back, so
                # it is retried for ever; a reported one that persists
                # does not.
                if isinstance(e, BusOpError):
                    op_errors += 1
                    if op_errors > self.max_op_errors:
                        raise
                else:
                    op_errors = 0
                _log.warning("inference worker %s lost the bus; "
                             "registering again and serving on",
                             self.service_id, exc_info=True)
                if pending is not None:
                    try:
                        self._complete_batch(*pending)
                    except (ConnectionError, OSError, RuntimeError):
                        pass  # the burst is lost; its clients retry
                    pending = None
                self.stop_flag.wait(1.0)
                try:
                    self.cache.register_worker(self.inference_job_id,
                                               self.service_id,
                                               info=self._reg_info)
                    last_reg = time.monotonic()
                except (ConnectionError, OSError, RuntimeError):
                    pass  # the broker is still down; the next lap retries
        if pending is not None:
            self._complete_batch(*pending)

    def _dispatch_batch(self, items: List[Dict[str, Any]]):
        """Launch one burst: every query of the popped shards through one
        dispatch. A corrupt packed shard is answered with per-query
        errors at once. An all-packed burst of one shape and dtype is
        copied, a frame at a time, into the staging buffer of its
        bucket (``predict_staged_submit``); any other goes through
        ``predict_submit`` query by query. Returns the arguments of
        ``_complete_batch``; the mode and the bin are taken now, since a
        later dispatch or a restack changes them before completion."""
        if self._fault is not None:
            # worker.slow sleeps here; worker.crash raises through the
            # serve loop (n= counts these dispatches).
            self._fault(op="predict")
        trace_ctxs = trace.extract_frames(items)
        tenants = _attr.extract_frames_tenants(items)
        t0 = (time.time(), time.monotonic())
        good = []
        for it in items:
            if "batch" in it and it["batch"] is None:
                err = {"error": "ValueError: " + it.get(
                    "batch_error", "corrupt packed frame")}
                self.cache.send_prediction_batch(
                    it["batch_id"], self.service_id,
                    [err] * max(1, int(it.get("n", 1) or 1)),
                    shard=it.get("shard"), origin_node=it.get("onode"))
            else:
                good.append(it)
        attr = {"tenants": tenants, "bucket": None, "dtype": None,
                "bin": self.trial_id}
        finisher, spans, n = self._staged(good, attr)
        if finisher is None:
            flat: List[Any] = []
            spans = []  # (item, start, count)
            for it in good:
                if "batch" in it or "queries" in it:
                    rows = it["batch"] if "batch" in it else it["queries"]
                    spans.append((it, len(flat), len(rows)))
                    flat.extend(rows[i] for i in range(len(rows)))
                else:  # one query of Cache.send_query
                    spans.append((it, len(flat), 1))
                    flat.append(it["query"])
            n = len(flat)
            if not flat:
                finisher = lambda: []  # noqa: E731 - an all-corrupt burst
            else:
                finisher = self._submit(
                    lambda: self.model.predict_submit(flat), n)
        attr["mode"] = getattr(self.model, "last_mode", "single")
        return finisher, spans, n, trace_ctxs, t0, attr

    def _submit(self, launch, n: int):
        """``launch()``'s finisher, or one that answers ``n`` errors
        when the launch raised."""
        try:
            return launch()
        except Exception as e:
            _log.exception("predict dispatch failed for %d queries", n)
            err = {"error": f"{type(e).__name__}: {e}"}
            return lambda: [err] * n

    def _staged(self, items: List[Dict[str, Any]], attr: Dict[str, Any]):
        """``(finisher, spans, n)`` of the staged path, or ``(None,
        None, 0)`` when the burst cannot take it."""
        arrays = [it.get("batch") for it in items]
        if not arrays or not all(isinstance(a, np.ndarray)
                                 for a in arrays):
            return None, None, 0
        first = arrays[0]
        if any(a.shape[1:] != first.shape[1:] or a.dtype != first.dtype
               for a in arrays[1:]):
            return None, None, 0
        bucket_fn = getattr(self.model, "predict_bucket", None)
        total = sum(a.shape[0] for a in arrays)
        bucket = bucket_fn(total, first.dtype) if bucket_fn else None
        if bucket is None:
            return None, None, 0
        attr.update(bucket=bucket, dtype=str(first.dtype))
        buf = self._stager.buffer(bucket, first.shape[1:], first.dtype)
        spans, start = [], 0
        for it, a in zip(items, arrays):
            spans.append((it, start, a.shape[0]))
            buf[start:start + a.shape[0]] = a
            start += a.shape[0]
        _wire.count_copies("assemble", total)
        return self._submit(
            lambda: self.model.predict_staged_submit(buf, total),
            total), spans, total

    def _complete_batch(self, finisher, spans, n: int, trace_ctxs,
                        t0, attr: Dict[str, Any]) -> None:
        """Read one dispatched burst back and answer its shards: its
        span, its attribution, and each shard's slice with its
        confidences and device seconds."""
        try:
            preds = finisher()
        except Exception as e:
            _log.exception("predict failed for %d queries", n)
            preds = [{"error": f"{type(e).__name__}: {e}"}] * n
        wall, mono = t0
        burst_s = time.monotonic() - mono
        if trace_ctxs:
            trace.record_event(
                "worker.predict", self.service_id, trace_ctxs, wall,
                burst_s, attrs={"n_queries": n,
                                "trial_id": str(attr["bin"])})
        weight = int(getattr(self.model, "last_weight", 1))
        self.queries_served += n
        if self._quant_active:
            _wire.count_quant(n, self._quant_req)
        if n:
            _attr.account_burst(
                self.inference_job_id, attr["bin"], n, burst_s,
                bucket=attr["bucket"], dtype=attr["dtype"],
                quant=self._quant_req if self._quant_active else "",
                mode=attr["mode"])
            if attr["tenants"]:
                _attr.account_tenant_device(attr["tenants"], burst_s, n)
        confidence = ([prediction_confidence(p) for p in preds]
                      if self.send_confidence else None)
        for it, start, count in spans:
            if "batch_id" not in it:
                self.cache.send_prediction(it["query_id"], self.service_id,
                                           preds[start], weight=weight)
                continue
            self.cache.send_prediction_batch(
                it["batch_id"], self.service_id,
                preds[start:start + count], weight=weight,
                shard=it.get("shard"),
                confidence=(confidence[start:start + count]
                            if confidence is not None else None),
                compute_s=round(burst_s * count / max(n, 1), 6),
                packed_ok=WIRE_NDBATCH in (it.get("rw") or ()),
                origin_node=it.get("onode"))

    # --- Promotion ---

    def _restack_member(self, req: Any) -> None:
        """Apply one restack (``{"old": tid, "new": tid}``): load the
        incoming trial's model and copy it into the served ensemble in
        place, then point the meta row and the registration at the new
        bin. On any failure the old member set keeps serving and the
        old registration stands, which the admin's wait reads as the
        failure (and rolls back)."""
        old_tid = (req or {}).get("old")
        new_tid = (req or {}).get("new")
        tids = str(self.trial_id).split(",")
        if not new_tid or old_tid not in tids:
            _log.warning("inference worker %s: stale restack request %r "
                         "(serving %s); ignoring", self.service_id, req,
                         self.trial_id)
            return
        if not isinstance(self.model, _PackedEnsemble):
            _log.warning("inference worker %s: restack requested but the "
                         "bin is not a packed ensemble; ignoring",
                         self.service_id)
            return
        try:
            model, _ = self._load_member(new_tid)
            self.model.replace_member(tids.index(old_tid), model)
        except Exception:
            _log.exception("inference worker %s: restack %s -> %s failed; "
                           "the old member set keeps serving",
                           self.service_id, old_tid, new_tid)
            return
        old_bin = self.trial_id
        tids[tids.index(old_tid)] = new_tid
        self.trial_id = ",".join(tids)
        _attr.drop_worker_bin(self.inference_job_id, old_bin)
        scores = [s for s in (self._trial_score(t) for t in tids)
                  if s is not None]
        self._reg_info["trial_id"] = self.trial_id
        self._reg_info["score"] = max(scores) if scores else None
        try:
            self.meta.update_inference_job_worker(self.service_id,
                                                  self.trial_id)
        except Exception:
            _log.exception("restack meta update failed; the registration "
                           "still shows the swap")
        self.cache.register_worker(self.inference_job_id, self.service_id,
                                   info=self._reg_info)
        _log.info("inference worker %s restacked %s -> %s (bin now %s)",
                  self.service_id, old_tid, new_tid, self.trial_id)

    def _trial_score(self, tid: str) -> Optional[float]:
        score = (self.meta.get_trial(tid) or {}).get("score")
        return float(score) if isinstance(score, (int, float)) else None

    def _close_attr_owner(self) -> None:
        if not self._attr_closed:
            self._attr_closed = True
            _attr.close_worker(self.inference_job_id, self.trial_id)

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
