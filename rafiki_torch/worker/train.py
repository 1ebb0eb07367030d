"""TrainWorker: a trial-running service bound to a chip group.

The port's copy of ``rafiki_tpu/worker/train.py`` (:41-148). The worker
resolves its sub-train-job's model class from the meta store, proxies
the job's advisor service over the bus (``RemoteAdvisor``) and hands
the loop to ``TrialRunner``, which builds every model on its chip
group's device. Its service row goes RUNNING, then STOPPED when the
budget is spent (or its stop flag is set), or ERRORED when it crashes.

As the reference's, the worker wraps the advisor in a
``PrefetchAdvisor`` unless ``RAFIKI_TPU_ADVISOR_PREFETCH`` is off (the
next proposal computes while a trial trains, one observation stale),
runs the runner with ``pipeline_persist`` (the persist tail on a
thread), sweeps the sub-job's scoped checkpoints once its budget is
spent (not after a stop: the ServicesManager sweeps then), and closes
the runner and the prefetcher on every way out, which refunds the last
prefetched proposal.

``TrainWorker.from_env`` builds one from a service process's
environment (the stores, the bus, the chip group and the device that
``RAFIKI_TPU_PLATFORM`` names). A worker given a log file
(``log_path``) writes its thread's records there.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Mapping, Optional

from ..advisor.prefetch import PrefetchAdvisor
from ..advisor.worker import RemoteAdvisor
from ..bus import BaseBus, connect
from ..config import _parse_bool
from ..constants import EnvVars, ServiceStatus, TrialStatus
from ..parallel.chips import ChipGroup
from ..store import MetaStore, ParamStore
from ..torchenv import DeviceLike, resolve_device
from ..utils.model_loader import load_model_class
from .runner import TrialRunner

_log = logging.getLogger(__name__)

#: The advisor-prefetch switch (``NodeConfig.advisor_prefetch``), on
#: unless it reads false; read when the worker's loop starts.
ADVISOR_PREFETCH_ENV = "RAFIKI_TPU_ADVISOR_PREFETCH"


class TrainWorker:
    def __init__(self, service_id: str, sub_train_job_id: str,
                 meta: MetaStore, params: ParamStore, bus: BaseBus,
                 chips: Optional[ChipGroup] = None,
                 advisor: Optional[Any] = None,
                 device: DeviceLike = None):
        self.service_id = service_id
        self.sub_id = sub_train_job_id
        self.meta = meta
        self.params = params
        self.bus = bus
        self.chips = chips
        self.device = chips.device if chips is not None \
            else resolve_device(device)
        self.advisor = advisor or RemoteAdvisor(bus, sub_train_job_id)
        self.stop_flag = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None,
                 ) -> "TrainWorker":
        """The worker a service environment (``os.environ`` by default)
        names, on the device ``RAFIKI_TPU_PLATFORM`` names."""
        from ..torchenv import env_device

        env = environ if environ is not None else dict(os.environ)
        device = env_device(env)
        chips = (ChipGroup.from_env(env[EnvVars.CHIPS], device.type)
                 if env.get(EnvVars.CHIPS) else None)
        return cls(env[EnvVars.SERVICE_ID], env[EnvVars.SUB_TRAIN_JOB_ID],
                   MetaStore(env[EnvVars.META_URI]),
                   ParamStore(env[EnvVars.PARAMS_DIR]),
                   connect(env.get(EnvVars.BUS_URI, "")), chips=chips,
                   device=device)

    # --- Service lifecycle ---

    def start(self) -> "TrainWorker":
        self._thread = threading.Thread(
            target=self.run, name=f"train-{self.service_id[:8]}", daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        self.stop_flag.set()
        self.join(join_timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # --- The loop ---

    def run(self) -> None:
        from ..utils.service_logs import bind_service_log

        bind_service_log(getattr(self, "log_path", None))
        sub = self.meta.get_sub_train_job(self.sub_id)
        if sub is None:
            raise ValueError(f"unknown sub_train_job {self.sub_id}")
        job = self.meta.get_train_job(sub["train_job_id"])
        model_row = self.meta.get_model(sub["model_id"])
        model_class = load_model_class(model_row["model_class"],
                                       model_row.get("model_source"))
        # The group's devices for every mesh a model builds on this
        # thread (ref :104-108); unbound on the way out.
        if self.chips is not None:
            self.chips.bind_to_thread()
        self.meta.update_service(self.service_id,
                                 status=ServiceStatus.RUNNING)
        advisor = self.advisor
        prefetch: Optional[PrefetchAdvisor] = None
        if _parse_bool(os.environ.get(ADVISOR_PREFETCH_ENV, "1")):
            advisor = prefetch = PrefetchAdvisor(advisor)
        runner = TrialRunner(
            model_class, advisor, job["train_dataset_path"],
            job["val_dataset_path"], self.meta, self.params, self.sub_id,
            model_id=sub["model_id"], worker_id=self.service_id,
            budget=job["budget"], device=self.device,
            stop_flag=self.stop_flag, pipeline_persist=True)
        try:
            runner.run()
            # The job is over (its budget spent, not a stop or a crash):
            # its halving configurations' scoped checkpoints go.
            if not self.stop_flag.is_set() and runner.budget.exhausted(
                    len(self.meta.get_trials(
                        self.sub_id, status=TrialStatus.COMPLETED))):
                runner.cleanup_scoped_checkpoints()
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.STOPPED)
        except Exception:
            _log.exception("train worker %s crashed", self.service_id)
            self.meta.update_service(self.service_id,
                                     status=ServiceStatus.ERRORED)
            raise
        finally:
            # run() drained the persist stage; close() ends its thread,
            # and the prefetcher's close refunds the proposal it holds.
            runner.close()
            if prefetch is not None:
                prefetch.close()
            if self.chips is not None:
                ChipGroup.unbind_thread()
