"""TrialRunner: the propose → train → evaluate → persist loop.

The port's copy of ``BudgetTracker`` and ``TrialRunner`` from
``rafiki_tpu/worker/runner.py`` (:151-631). A trial is: propose →
retrieve the proposal's shared parameters (a retrieval error errs the
trial) → ``create_trial`` → train → evaluate → ``dump_parameters`` →
``advisor.feedback`` → ``ParamStore.save`` → ``mark_trial_completed``
(the score is final once evaluate returns, so the advisor hears it
before the persist tail, as in the reference). A failed trial is marked errored and the advisor told to ``forget`` its
proposal; ``max_consecutive_errors`` failures in a row end the run. The
model's log records go to the trial's log in the meta store (and on to
whatever sink the calling thread had).

The runner builds each model on ``device`` (CUDA unless the caller asks
for the CPU). As the reference's, it observes the ``propose``,
``train``, ``eval`` and ``persist`` phases (``observe.phases``), binds
the ``trial`` label for the train loop's step-time histogram and MFU
gauge and removes those series when the trial ends, traces train and
eval into ``$RAFIKI_TPU_TRACE_DIR/<trial_id>/`` when that is set
(``observe.profiling.trace_session``; a busy profiler skips the trace),
and records the persist tail as a ``trial.persist`` span with its
stages, under the calling thread's trace or else one whose id is the
trial id (``GET /trace/<trial_id>``). It leaves out the reference's
dataset stage owners and checkpoints (scoped or crash-resume), the
proposal metadata of the advisors not ported yet
(``params_scope``, ``params_save_scope``, ``cold_start_knobs``,
``record_knobs``, ``train_kwargs``: warm starts here are scoped to the
runner's ``worker_id``), and ``pipeline_persist`` (not ported yet): the
persist tail runs inline, as the reference's does with the pipeline
off. A ``stop_flag`` (a ``threading.Event``) ends the run before the
next trial, as the reference's does.
"""

from __future__ import annotations

import logging
import time
import traceback
from typing import Any, Dict, List, Optional, Type

from ..advisor.base import Proposal
from ..constants import BudgetOption, TrialStatus
from ..model.base import BaseModel
from ..model.logger import logger
from ..observe import metrics
from ..observe import phases as _phases
from ..observe import trace as _trace
from ..observe.profiling import trace_session, trial_trace_dir
from ..store import MetaStore, ParamStore
from ..torchenv import DeviceLike, resolve_device

_log = logging.getLogger(__name__)


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
                 stop_flag: Optional[Any] = None):
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

    # --- Loop ---

    def run(self) -> List[Dict[str, Any]]:
        """Run trials until the budget is spent, the advisor stops
        proposing or too many trials fail in a row; returns the trial
        rows."""
        done: List[Dict[str, Any]] = []
        consecutive_errors = 0
        while not self._should_stop():
            row = self.run_one()
            if row is None:  # advisor: search is over
                break
            done.append(row)
            if row["status"] != TrialStatus.ERRORED:
                consecutive_errors = 0
                continue
            consecutive_errors += 1
            if consecutive_errors >= self.max_consecutive_errors:
                _log.error("worker %s: %d consecutive trial failures; "
                           "giving up on %s", self.worker_id,
                           consecutive_errors, self.sub_train_job_id)
                break
        return done

    def _should_stop(self) -> bool:
        if self.stop_flag is not None and self.stop_flag.is_set():
            return True
        n_done = len(self.meta.get_trials(self.sub_train_job_id,
                                          status=TrialStatus.COMPLETED))
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
        # A retrieval ERROR is not absence: cold-starting silently would
        # feed an artificially poor score back into the search, so it
        # errs the trial and refunds the proposal.
        try:
            shared = self.params.retrieve(
                proposal.params_type, session_id=self.sub_train_job_id,
                worker_id=self.worker_id)
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
        knobs = self.model_class.validate_knobs(dict(proposal.knobs))
        trial = self.meta.create_trial(
            self.sub_train_job_id, self.model_id, no=proposal.trial_no,
            status=TrialStatus.RUNNING, worker_id=self.worker_id,
            knobs=_jsonable_knobs(knobs), proposal=proposal.to_json())
        trial_id = trial["id"]

        # The trial's records go to the meta store AND on to the sink
        # this thread already had, which is restored afterwards.
        prior_sink = logger.current_sink()

        def _trial_sink(rec, _tid=trial_id, _prior=prior_sink):
            self.meta.add_trial_log(_tid, rec)
            if _prior is not None:
                _prior(rec)

        logger.set_sink(_trial_sink)
        t0 = time.time()
        try:
            model = self.model_class(device=self.device, **knobs)
            try:
                # The label context attributes the train loop's MFU
                # gauge and step-time histogram to this trial; the
                # optional trace covers train and eval.
                with trace_session(trial_trace_dir(trial_id)):
                    t_train = time.monotonic()
                    with metrics.label_context(trial=trial_id[:12]):
                        model.train(self.train_dataset_path,
                                    shared_params=shared)
                    _phases.observe_phase("train",
                                          time.monotonic() - t_train)
                    t_eval = time.monotonic()
                    score = float(model.evaluate(self.val_dataset_path))
                    _phases.observe_phase("eval",
                                          time.monotonic() - t_eval)
                dumped = model.dump_parameters()
            finally:
                model.destroy()
            # The score is final once evaluate returned: feedback first,
            # then the persist tail.
            self.advisor.feedback(proposal, score)
            self._finish_trial(trial_id, score, dumped)
            _log.info("trial %s #%d done: score=%.4f (%.1fs)",
                      trial_id[:8], proposal.trial_no, score,
                      time.time() - t0)
        except Exception:
            err = traceback.format_exc()
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

    def _finish_trial(self, trial_id: str, score: float,
                      dumped: Any) -> None:
        """The persist tail: save the parameters, then mark the trial
        COMPLETED. A failure here marks the trial ERRORED; the advisor's
        feedback stands, since the score was real. The tail is one
        ``trial.persist`` span with its stages' times, under the
        thread's trace or else one whose trace id is the trial id."""
        ctx = _trace.current() or _trace.TraceContext(str(trial_id))
        t_persist = time.monotonic()
        wall0 = time.time()
        save_s = commit_s = 0.0
        try:
            t = time.monotonic()
            params_id = self.params.save(
                dumped, session_id=self.sub_train_job_id,
                worker_id=self.worker_id, score=score)
            save_s = time.monotonic() - t
            t = time.monotonic()
            self.meta.mark_trial_completed(trial_id, score, params_id)
            commit_s = time.monotonic() - t
        except Exception:
            err = traceback.format_exc()
            _log.warning("trial %s: persist tail failed; marking "
                         "errored:\n%s", trial_id[:8], err)
            self.meta.mark_trial_errored(trial_id, err)
        finally:
            dur = time.monotonic() - t_persist
            _phases.observe_phase("persist", dur)
            # The trial's log records went to the meta store as they
            # came (no buffer to flush), so log_flush_ms is 0.
            _trace.record_event(
                "trial.persist", self.worker_id, [ctx], wall0, dur,
                attrs={"trial_id": str(trial_id)[:12],
                       "log_flush_ms": 0.0,
                       "params_save_ms": round(save_s * 1e3, 3),
                       "meta_commit_ms": round(commit_s * 1e3, 3)})


def _jsonable_knobs(knobs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in knobs.items():
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            v = v.item()
        out[k] = v
    return out
