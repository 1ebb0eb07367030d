"""TrialRunner: the propose → train → evaluate → persist loop.

The port's copy of ``_PersistStage``, ``BudgetTracker`` and
``TrialRunner`` from ``rafiki_tpu/worker/runner.py`` (:37-631). A trial
is: propose → retrieve the proposal's shared parameters (a retrieval
error errs the trial) → ``create_trial`` → train → evaluate →
``dump_parameters`` → ``advisor.feedback`` → the persist tail
(``ParamStore.save``, ``mark_trial_completed``). The score is final once
evaluate returns, so the advisor hears it before the persist tail. A
failed trial is marked errored and the advisor told to ``forget`` its
proposal; ``max_consecutive_errors`` failures in a row end the run.

The proposal's metadata, as the reference reads it:

- ``params_scope``: the worker scope the shared parameters are
  retrieved from (else the runner's ``worker_id``), and
  ``params_save_scope`` the scope they are saved under (PBT inherits a
  winner's weights and keeps writing its own lineage);
- ``cold_start_knobs``: knobs laid over the proposal's when nothing was
  retrieved, and ``record_knobs``: knobs laid over the recorded ones
  (PBT's cumulative budget);
- ``train_kwargs``: passed to ``train`` (ASHA's ``schedule_total_epochs``);
- ``ckpt_scope``: the checkpoint directory
  ``<params_dir>/ckpt/<sub_train_job>-<scope>``, shared by every trial
  of the scope and kept after the trial, with ``checkpoint_final_epoch``
  (ASHA's rungs resume it); ``cleanup_scoped_checkpoints`` sweeps a
  sub-job's scopes once it is over.

Without a scope, ``RAFIKI_TPU_CKPT=1`` turns on crash resume: the
checkpoint directory is keyed by the sub-job and the knobs, so the
trial proposed again after a worker died resumes the dead attempt's
epochs; once the trial ends the directory is renamed to a
``.spent-<trial>`` tombstone at once (a same-knobs successor must not
resume it) and deleted in the persist tail.

With ``pipeline_persist`` the persist tail runs on a single-slot
background stage (``_PersistStage``): trial N+1's propose and model
build overlap trial N's persistence, trial N's meta writes land before
trial N+1's, a tail not yet committed counts toward the budget, a
failed tail errs its trial after the fact, and the trial's log records
are buffered and flushed by the tail. Without it the tail runs inline
and the records go to the meta store as they come.

The runner builds each model on ``device`` (CUDA unless the caller asks
for the CPU). As the reference's, it observes the ``propose``,
``train``, ``eval`` and ``persist`` phases (``observe.phases``), binds
the ``trial`` label for the train loop's step-time histogram and MFU
gauge and removes those series when the trial ends, traces train and
eval into ``$RAFIKI_TPU_TRACE_DIR/<trial_id>/`` when that is set
(``observe.profiling.trace_session``; a busy profiler skips the trace),
and records the persist tail as a ``trial.persist`` span with its
stages, under the calling thread's trace or else one whose id is the
trial id (``GET /trace/<trial_id>``). It binds the sub-train job as
the ``stage_owner`` of the residency caches' entries around train and
eval, as the reference does. A ``stop_flag``
(a ``threading.Event``) ends the run before the next trial.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Type

from ..advisor.base import Proposal
from ..constants import BudgetOption, TrialStatus
from ..model.base import BaseModel
from ..model.dataset import stage_owner
from ..model.logger import logger
from ..observe import metrics
from ..observe import phases as _phases
from ..observe import trace as _trace
from ..observe.profiling import trace_session, trial_trace_dir
from ..store import MetaStore, ParamStore
from ..torchenv import DeviceLike, resolve_device

_log = logging.getLogger(__name__)

#: ``1`` turns on the unscoped crash-resume checkpoints
#: (``NodeConfig.checkpoint_trials``).
CKPT_ENV = "RAFIKI_TPU_CKPT"


class _PersistStage:
    """The single-slot background stage of the persist tail.

    One trial's tail may be in flight: ``submit`` first waits for the
    previous tail, so trial N's meta writes land before trial N+1's,
    with one trial of overlap. A submitted tail that has not committed
    is a completion the meta store cannot see yet: ``completed_count``
    adds the pending tails to the caller's COMPLETED count under the
    lock the tail's commit holds, so the budget check neither counts a
    completion twice nor proposes a trial past ``MODEL_TRIAL_COUNT``.
    Tails never raise: a failed tail notes its failure here (the
    runner's breaker reads it) and marks its trial errored."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="trial-persist")
        self._last: Optional[Future] = None
        self._lock = threading.Lock()
        self._pending = 0
        self._failures = 0
        self._failed_ids: set = set()
        self._commits = 0

    def note_failure(self, trial_id: str = "") -> None:
        with self._lock:
            self._failures += 1
            if trial_id:
                self._failed_ids.add(str(trial_id))

    def failure_count(self) -> int:
        with self._lock:
            return self._failures

    def has_failed(self, trial_id: str) -> bool:
        """Whether this trial's own tail noted a failure: a fast tail
        can err its trial before ``run_one`` reads the row, and the
        breaker must count that trial once."""
        with self._lock:
            return str(trial_id) in self._failed_ids

    def commit_count(self) -> int:
        """Tails that committed: the breaker resets only on these."""
        with self._lock:
            return self._commits

    def submit(self, fn: Callable[[Callable], None]) -> None:
        """``fn(commit)`` runs on the persist thread and calls
        ``commit(meta_write)`` at most once; the meta write and the
        pending count's decrement happen under one lock."""
        if self._last is not None:
            self._last.result()  # one slot; tails do not raise
        with self._lock:
            self._pending += 1

        def run() -> None:
            committed = [False]

            def commit(meta_write: Callable[[], None]) -> None:
                with self._lock:
                    meta_write()
                    self._pending -= 1
                    self._commits += 1
                committed[0] = True

            try:
                fn(commit)
            finally:
                if not committed[0]:
                    with self._lock:
                        self._pending -= 1

        self._last = self._pool.submit(run)

    def completed_count(self, count_fn: Callable[[], int]) -> int:
        with self._lock:
            return int(count_fn()) + self._pending

    def drain(self) -> None:
        """Wait for the tail in flight: afterwards no row of a submitted
        tail is RUNNING."""
        if self._last is not None:
            self._last.result()

    def close(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)


class BudgetTracker:
    """Budget of one sub-train-job: ``MODEL_TRIAL_COUNT`` completed
    trials and ``TIME_HOURS`` of wall time."""

    def __init__(self, budget: Optional[Dict[str, Any]] = None):
        budget = dict(budget or {})
        self.max_trials = int(budget.get(BudgetOption.MODEL_TRIAL_COUNT, 5))
        self.max_hours = float(budget.get(BudgetOption.TIME_HOURS, 0) or 0)
        self._t0 = time.time()

    def exhausted(self, n_trials_done: int) -> bool:
        if n_trials_done >= self.max_trials:
            return True
        if self.max_hours > 0 and \
                (time.time() - self._t0) >= self.max_hours * 3600:
            return True
        return False


class TrialRunner:
    """Runs trials for one (sub_train_job, model_class) against the
    stores."""

    def __init__(self, model_class: Type[BaseModel], advisor: Any,
                 train_dataset_path: str, val_dataset_path: str,
                 meta_store: MetaStore, param_store: ParamStore,
                 sub_train_job_id: str, model_id: str = "",
                 worker_id: str = "local",
                 budget: Optional[Dict[str, Any]] = None,
                 max_consecutive_errors: int = 3,
                 device: DeviceLike = None,
                 stop_flag: Optional[Any] = None,
                 pipeline_persist: bool = False):
        self.device = resolve_device(device)
        self.model_class = model_class
        self.advisor = advisor
        self.train_dataset_path = train_dataset_path
        self.val_dataset_path = val_dataset_path
        self.meta = meta_store
        self.params = param_store
        self.sub_train_job_id = sub_train_job_id
        self.model_id = model_id
        self.worker_id = worker_id
        self.budget = BudgetTracker(budget)
        # Errored trials refund their budget slot (advisor.forget) and
        # never count as completed: without this breaker a model that
        # fails every time would loop forever.
        self.max_consecutive_errors = max_consecutive_errors
        self.stop_flag = stop_flag
        # Off by default for direct construction (callers that read the
        # meta store right after run_one); the TrainWorker turns it on.
        # With it on, run_one may return a RUNNING row whose tail is in
        # flight: run() and drain_persist() settle them.
        self._persist = _PersistStage() if pipeline_persist else None

    # --- Loop ---

    def run(self) -> List[Dict[str, Any]]:
        """Run trials until the budget is spent, the advisor stops
        proposing or too many trials fail in a row; returns the trial
        rows as the meta store has them once every tail has settled."""
        done: List[Dict[str, Any]] = []
        consecutive_errors = 0
        tail_failures_seen = 0
        tail_commits_seen = 0
        finished = False
        try:
            while not finished:
                while not self._should_stop():
                    row = self.run_one()
                    if row is None:  # advisor: search is over
                        finished = True
                        break
                    done.append(row)
                    # A failed tail errs its trial after run_one read
                    # the row: its failures count by their change, the
                    # trial it already erred once, and the streak
                    # resets only on a commit (ref :232-278).
                    new_failures = int(
                        row["status"] == TrialStatus.ERRORED
                        and not (self._persist is not None
                                 and self._persist.has_failed(row["id"])))
                    if self._persist is not None:
                        f = self._persist.failure_count()
                        new_failures += f - tail_failures_seen
                        tail_failures_seen = f
                        c = self._persist.commit_count()
                        new_commits = c - tail_commits_seen
                        tail_commits_seen = c
                    else:
                        new_commits = int(not new_failures)
                    if new_commits:
                        consecutive_errors = 0
                    if new_failures:
                        consecutive_errors += new_failures
                        if consecutive_errors >= \
                                self.max_consecutive_errors:
                            _log.error(
                                "worker %s: %d consecutive trial "
                                "failures; giving up on %s",
                                self.worker_id, consecutive_errors,
                                self.sub_train_job_id)
                            finished = True
                            break
                if finished:
                    break
                # The budget counted a tail in flight: settle it and ask
                # again, so a tail that failed refunds its slot and a
                # replacement trial runs.
                self.drain_persist()
                if self._should_stop():
                    finished = True
        finally:
            self.drain_persist()
        if self._persist is not None:
            done = [self.meta.get_trial(row["id"]) or row for row in done]
        return done

    def drain_persist(self) -> None:
        """Wait for the persist tail in flight (none without the
        pipeline); afterwards every submitted trial row is terminal."""
        if self._persist is not None:
            self._persist.drain()

    def close(self) -> None:
        if self._persist is not None:
            self._persist.close()

    def _should_stop(self) -> bool:
        if self.stop_flag is not None and self.stop_flag.is_set():
            return True

        def n_completed() -> int:
            return len(self.meta.get_trials(self.sub_train_job_id,
                                            status=TrialStatus.COMPLETED))

        n_done = (self._persist.completed_count(n_completed)
                  if self._persist is not None else n_completed())
        return self.budget.exhausted(n_done)

    # --- One trial ---

    def _forget(self, proposal: Proposal) -> None:
        forget = getattr(self.advisor, "forget", None)
        if forget is not None:
            forget(proposal)

    def run_one(self, proposal: Optional[Proposal] = None,
                ) -> Optional[Dict[str, Any]]:
        if proposal is None:
            t_prop = time.monotonic()
            proposal = self.advisor.propose()
            _phases.observe_phase("propose", time.monotonic() - t_prop)
        if proposal is None:  # advisor side says: search is over
            return None
        # The shared parameters are resolved before the knobs are
        # validated: ``cold_start_knobs`` apply only when nothing was
        # retrieved. A retrieval ERROR is not absence: cold-starting
        # silently would feed an artificially poor score back into the
        # search, so it errs the trial and refunds the proposal.
        params_scope = proposal.meta.get("params_scope") or self.worker_id
        try:
            shared = self.params.retrieve(
                proposal.params_type, session_id=self.sub_train_job_id,
                worker_id=params_scope)
        except Exception:
            err = traceback.format_exc()
            trial = self.meta.create_trial(
                self.sub_train_job_id, self.model_id,
                no=proposal.trial_no, status=TrialStatus.RUNNING,
                worker_id=self.worker_id,
                knobs=_jsonable_knobs(proposal.knobs),
                proposal=proposal.to_json())
            self.meta.mark_trial_errored(trial["id"], err)
            self._forget(proposal)
            _log.warning("trial #%d: shared-params retrieval failed:\n%s",
                         proposal.trial_no, err)
            return self.meta.get_trial(trial["id"])
        raw_knobs = dict(proposal.knobs)
        if shared is None:
            raw_knobs.update(proposal.meta.get("cold_start_knobs") or {})
        knobs = self.model_class.validate_knobs(raw_knobs)
        # The recorded knobs are the reproducible configuration.
        recorded = {**knobs, **(proposal.meta.get("record_knobs") or {})}
        trial = self.meta.create_trial(
            self.sub_train_job_id, self.model_id, no=proposal.trial_no,
            status=TrialStatus.RUNNING, worker_id=self.worker_id,
            knobs=_jsonable_knobs(recorded), proposal=proposal.to_json())
        trial_id = trial["id"]

        # The trial's records go to the meta store (buffered for the
        # persist tail under the pipeline) AND on to the sink this
        # thread already had, which is restored afterwards.
        prior_sink = logger.current_sink()
        buffering = self._persist is not None
        log_buffer: List[Any] = []

        def _trial_sink(rec, _tid=trial_id, _prior=prior_sink):
            if buffering:
                log_buffer.append(rec)
            else:
                self.meta.add_trial_log(_tid, rec)
            if _prior is not None:
                _prior(rec)

        logger.set_sink(_trial_sink)
        t0 = time.time()
        try:
            model = self.model_class(device=self.device, **knobs)
            ckpt_scope = proposal.meta.get("ckpt_scope")
            if ckpt_scope:
                ckpt_dir: Optional[str] = os.path.join(
                    self.params.params_dir, "ckpt",
                    f"{self.sub_train_job_id}-{ckpt_scope}")
            else:
                ckpt_dir = self._ckpt_dir(knobs)
            train_kwargs: Dict[str, Any] = \
                {"checkpoint_dir": ckpt_dir} if ckpt_dir else {}
            if ckpt_scope:
                train_kwargs["checkpoint_final_epoch"] = True
            train_kwargs.update(proposal.meta.get("train_kwargs") or {})
            try:
                # The label context attributes the train loop's MFU
                # gauge and step-time histogram to this trial; the
                # optional trace covers train and eval. stage_owner
                # marks the cache entries the trial makes as this
                # sub-train job's, so evictions under budget pressure
                # take other jobs' sets first (ref :435-450).
                with trace_session(trial_trace_dir(trial_id)):
                    t_train = time.monotonic()
                    with metrics.label_context(trial=trial_id[:12]), \
                            stage_owner(self.sub_train_job_id):
                        model.train(self.train_dataset_path,
                                    shared_params=shared, **train_kwargs)
                    _phases.observe_phase("train",
                                          time.monotonic() - t_train)
                    t_eval = time.monotonic()
                    with stage_owner(self.sub_train_job_id):
                        score = float(
                            model.evaluate(self.val_dataset_path))
                    _phases.observe_phase("eval",
                                          time.monotonic() - t_eval)
                save_scope = proposal.meta.get("params_save_scope") \
                    or params_scope
                dumped = model.dump_parameters()
            finally:
                model.destroy()
            # The unscoped crash-resume directory is keyed by the knobs,
            # not the trial: it is spent now, by a rename, so a
            # same-knobs successor neither resumes this trial's last
            # checkpoint nor has its own directory deleted under it. The
            # tail deletes the tombstone.
            ckpt_tomb = None
            if ckpt_dir and not ckpt_scope:
                tomb = f"{ckpt_dir}.spent-{trial_id[:8]}"
                try:
                    os.rename(ckpt_dir, tomb)
                    ckpt_tomb = tomb
                except OSError:
                    pass  # no checkpoint was written
            # The score is final once evaluate returned: feedback first,
            # then the persist tail, which owns the trial's log buffer
            # and terminal status from here on.
            self.advisor.feedback(proposal, score)
            self._finish_trial(trial_id, score, dumped, save_scope,
                               log_buffer, ckpt_tomb)
            _log.info("trial %s #%d done: score=%.4f (%.1fs)",
                      trial_id[:8], proposal.trial_no, score,
                      time.time() - t0)
        except Exception:
            err = traceback.format_exc()
            for rec in log_buffer:  # buffered records outlive the error
                self.meta.add_trial_log(trial_id, rec)
            self.meta.mark_trial_errored(trial_id, err)
            self._forget(proposal)
            _log.warning("trial %s #%d errored:\n%s", trial_id[:8],
                         proposal.trial_no, err)
        finally:
            logger.set_sink(prior_sink)
            # The train series are the current trial's: a trial that
            # ended stops reporting its last values as live, and its
            # labels do not pile up in the registry.
            for name in ("rafiki_tpu_train_mfu_ratio",
                         "rafiki_tpu_train_step_seconds"):
                m = metrics.registry().find(name)
                if m is not None:
                    m.remove(trial=trial_id[:12])
        return self.meta.get_trial(trial_id)

    def _finish_trial(self, trial_id: str, score: float, dumped: Any,
                      save_scope: str, log_buffer: List[Any],
                      ckpt_tomb: Optional[str]) -> None:
        """The persist tail: flush the buffered log records, save the
        parameters under ``save_scope``, mark the trial COMPLETED and
        delete the spent crash-resume tombstone; inline without the
        pipeline, on the persist stage with it. A failure marks the
        trial ERRORED; the advisor's feedback stands, since the score
        was real. The tail is one ``trial.persist`` span with its
        stages' times, under the thread's trace (captured here: the
        persist thread has none) or else one whose id is the trial's."""
        ctx = _trace.current() or _trace.TraceContext(str(trial_id))

        def tail(commit: Callable[[Callable], None]) -> None:
            t_persist = time.monotonic()
            wall0 = time.time()
            flush_s = save_s = commit_s = 0.0
            try:
                t = time.monotonic()
                for rec in log_buffer:
                    self.meta.add_trial_log(trial_id, rec)
                flush_s = time.monotonic() - t
                t = time.monotonic()
                params_id = self.params.save(
                    dumped, session_id=self.sub_train_job_id,
                    worker_id=save_scope, score=score)
                save_s = time.monotonic() - t
                t = time.monotonic()
                commit(lambda: self.meta.mark_trial_completed(
                    trial_id, score, params_id))
                commit_s = time.monotonic() - t
                # Scoped checkpoints outlive the trial (the next rung
                # resumes them); cleanup_scoped_checkpoints sweeps them.
                if ckpt_tomb:
                    shutil.rmtree(ckpt_tomb, ignore_errors=True)
            except Exception:
                err = traceback.format_exc()
                _log.warning("trial %s: persist tail failed; marking "
                             "errored:\n%s", trial_id[:8], err)
                if self._persist is not None:
                    self._persist.note_failure(trial_id)
                try:
                    self.meta.mark_trial_errored(trial_id, err)
                except Exception:
                    _log.exception("trial %s: could not record persist "
                                   "failure", trial_id[:8])
            finally:
                dur = time.monotonic() - t_persist
                _phases.observe_phase("persist", dur)
                _trace.record_event(
                    "trial.persist", self.worker_id, [ctx], wall0, dur,
                    attrs={"trial_id": str(trial_id)[:12],
                           "log_flush_ms": round(flush_s * 1e3, 3),
                           "params_save_ms": round(save_s * 1e3, 3),
                           "meta_commit_ms": round(commit_s * 1e3, 3)})

        if self._persist is not None:
            self._persist.submit(tail)
        else:
            tail(lambda meta_write: meta_write())

    def cleanup_scoped_checkpoints(self) -> None:
        """Remove every scoped checkpoint directory of this sub-job
        (``<params_dir>/ckpt/<sub_id>-<scope>``). They persist across
        trials by design, so nothing in the trial loop deletes them; the
        TrainWorker calls this once the budget is spent, and the
        ServicesManager sweeps alike on every stop of a job. A sibling
        worker's trial that loses its directory mid-flight trains its
        whole proposed budget from scratch, the documented fallback."""
        root = os.path.join(self.params.params_dir, "ckpt")
        if not os.path.isdir(root):
            return
        prefix = f"{self.sub_train_job_id}-"
        for name in os.listdir(root):
            if name.startswith(prefix):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    def _ckpt_dir(self, knobs: Dict[str, Any]) -> Optional[str]:
        """The crash-resume directory of (sub-job, knobs) under
        ``RAFIKI_TPU_CKPT=1``, else None."""
        if os.environ.get(CKPT_ENV) != "1":
            return None
        digest = hashlib.sha1(json.dumps(
            {"sub": self.sub_train_job_id,
             "knobs": _jsonable_knobs(knobs)},
            sort_keys=True, default=str).encode()).hexdigest()[:16]
        return os.path.join(self.params.params_dir, "ckpt", digest)


def _jsonable_knobs(knobs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in knobs.items():
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            v = v.item()
        out[k] = v
    return out
