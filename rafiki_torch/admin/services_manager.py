"""ServicesManager: how many services each job gets, and on which chips.

The port's copy of ``rafiki_tpu/admin/services_manager.py``: the
resource is the node's CUDA devices (``ChipAllocator``), each service's
environment carries its chip group as ``EnvVars.CHIPS``, and its worker
runs on that group's device.

Budget keys (the reference's):

- ``MODEL_TRIAL_COUNT``: trials per model (the advisor caps them);
- ``CHIP_COUNT``: chips for a model's search. Workers =
  ``ceil(CHIP_COUNT / CHIPS_PER_TRIAL)``; 0 -> one worker on one chip.
  ``GPU_COUNT`` is its alias;
- ``CHIPS_PER_TRIAL``: the chip-group size of one worker (default 1).

Every service a job owns (train workers and the advisor, inference
workers and the predictor) is recorded in the job's worker mapping, so
stop and supervise walk one list. When chip groups are short, an
inference job's trials are packed into bins, one worker a bin: on one
card, two trials make one worker serving the bin ``"a,b"``. A job's
first worker may share a chip already in use (the time-sliced tier,
thread services only), so a full card still admits a second job.

Services are stamped with the node that launched them. A node
supervises and stops only its own services (and, on a primary that
adopts them, rows without a node); another node's RUNNING rows are
credible while that node's heartbeat is at most ``NODE_LEASE`` seconds
old (``RAFIKI_TPU_NODE_LEASE``, read when the manager is built), and a
sweep marks them ERRORED once it lapses. So several nodes (a primary
and the ``join`` nodes beside it) share one meta store, params
directory and TCP bus.

Every service's environment carries what a service process needs to
open the same substrate: the store URIs, the bus URI, the log
directory, the node's id and its device type (``RAFIKI_TPU_PLATFORM``),
and the operator's ``RAFIKI_TPU_ADVISOR_PREFETCH`` where it is set.
The thread runtime ignores them and uses the platform's shared context.

Promotion's two primitives: ``swap_inference_worker`` launches a worker
for a trial and waits for its bus registration before it stops the
workers it replaces, so a bin never loses its vote; and
``drain_inference_worker`` retires one worker gracefully (unregistered,
then a ``__drain__`` marker: it answers what was queued and exits).

On the cluster fabric the platform attaches a node registry
(``node_registry``, ``admin/nodes.py``), whose announce rides
``heartbeat``; off it, it stays None. The manager is a ``node`` fault
site (``faults.site_hook``, resolved when it is built): a ``node.kill``
whose ``op`` matches this node's id hard-kills every running service it
owns at the end of a supervise sweep (rows left RUNNING, registrations
stale), so its next sweep finds the wreckage and respawns it.

The serving control loop rides the supervise sweep: the platform
attaches an SLO engine (``slo_engine``, ``admin/slo_engine.py``) when
``RAFIKI_TPU_SLO_RULES`` names objectives and an autoscaler
(``autoscaler``, ``admin/autoscaler.py``) when ``RAFIKI_TPU_AUTOSCALE``
is on. After the dead-service pass both read one ``ScrapeCache``, the
SLO sweep first, so a firing alert is the autoscaler's pressure in the
same sweep. Off, each is None and costs one attribute check.

Every stop of a train job sweeps its sub-jobs' scoped rung
checkpoints (``<params_dir>/ckpt/<sub_id>-*``).
"""

from __future__ import annotations

import logging
import math
import os
import shutil
import time
from typing import Any, Dict, List, Optional

from .. import faults
from ..cache import Cache
from ..constants import (BudgetOption, EnvVars, InferenceJobStatus,
                         ServiceStatus, ServiceType, TrainJobStatus)
from ..container.manager import ContainerManager
from ..parallel.chips import ChipAllocator
from ..store import MetaStore
from ..torchenv import PLATFORM_ENV

_log = logging.getLogger(__name__)

CHIPS_PER_TRIAL = "CHIPS_PER_TRIAL"

#: The trial id recorded for an inference job's predictor service row.
PREDICTOR_TRIAL = "__predictor__"

_ACTIVE = (ServiceStatus.STARTED, ServiceStatus.DEPLOYING,
           ServiceStatus.RUNNING)


def normalize_budget(budget: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    b = dict(budget or {})
    if BudgetOption.GPU_COUNT in b and BudgetOption.CHIP_COUNT not in b:
        b[BudgetOption.CHIP_COUNT] = b.pop(BudgetOption.GPU_COUNT)
    b.pop(BudgetOption.GPU_COUNT, None)
    return b


class ServicesManager:
    def __init__(self, meta: MetaStore, container: ContainerManager,
                 allocator: ChipAllocator, node_id: str,
                 log_dir: str = "", *, meta_uri: str = ":memory:",
                 params_dir: str = "", bus_uri: str = "",
                 adopt_unowned: bool = True):
        self.meta = meta
        self.container = container
        self.allocator = allocator
        self.node_id = node_id
        # The services' shared log directory (the span log); "" = none.
        self.log_dir = log_dir
        # What a service process opens; thread services ignore them.
        self.meta_uri = meta_uri
        self.params_dir = params_dir
        self.bus_uri = bus_uri
        # Only the node that owns the workdir (the primary) adopts rows
        # without a node: a join node stopping or sweeping them would
        # disrupt the primary's jobs.
        self.adopt_unowned = adopt_unowned
        # The liveness lease of another node's rows, seconds; the
        # platform's heartbeat refreshes this node's four times a lease.
        self.NODE_LEASE = float(os.environ.get("RAFIKI_TPU_NODE_LEASE",
                                               120.0))
        # The bus to reap stale registrations on, opened at first use
        # when the container manager has no shared context.
        self._reap_bus = None
        # Dead inference workers whose respawn found no chips: their
        # rows are ERRORED, out of the RUNNING scan, so each sweep
        # retries them until a worker lands or the job stops.
        self._pending_respawns: List[Dict[str, Any]] = []
        # The control loop (admin/autoscaler.py, admin/slo_engine.py),
        # attached by the platform only when armed; None costs supervise
        # one attribute check each.
        self.autoscaler = None
        self.slo_engine = None
        # The cluster node registry, attached by the platform only on
        # the fabric; None costs heartbeat one attribute check.
        self.node_registry = None
        # The node.kill site; None when the fault plane is disarmed.
        self._node_faults = faults.site_hook("node")

    # --- Launch plumbing ---

    def _launch(self, service_type: str,
                extra_env: Dict[str, str]) -> Dict[str, Any]:
        svc = self.meta.create_service(service_type, ServiceStatus.DEPLOYING,
                                       node_id=self.node_id)
        env = self._base_env(svc["id"], service_type)
        env.update(extra_env)
        try:
            container_id = self.container.create_service(svc["id"], env)
        except Exception:
            self.meta.update_service(svc["id"], status=ServiceStatus.ERRORED)
            raise
        self.meta.update_service(svc["id"], container_id=container_id)
        return self.meta.get_service(svc["id"])

    def _base_env(self, service_id: str, service_type: str,
                  ) -> Dict[str, str]:
        env = {
            EnvVars.META_URI: self.meta_uri,
            EnvVars.PARAMS_DIR: self.params_dir,
            EnvVars.BUS_URI: self.bus_uri,
            EnvVars.SERVICE_ID: service_id,
            EnvVars.SERVICE_TYPE: service_type,
            EnvVars.NODE_ID: self.node_id,
            PLATFORM_ENV: self.allocator.device_type,
        }
        if self.log_dir:
            env[EnvVars.LOG_DIR] = self.log_dir
        # The operator's prefetch switch reaches every child, whatever
        # environment its container gives it (ref :156-158).
        if "RAFIKI_TPU_ADVISOR_PREFETCH" in os.environ:
            env["RAFIKI_TPU_ADVISOR_PREFETCH"] = \
                os.environ["RAFIKI_TPU_ADVISOR_PREFETCH"]
        return env

    def _stop_service(self, service_id: str) -> None:
        svc = self.meta.get_service(service_id)
        if svc is None:
            return
        self.container.destroy_service(svc["container_id"] or service_id)
        if svc["status"] in _ACTIVE:
            self.meta.update_service(service_id, status=ServiceStatus.STOPPED)
        self._release_chips_of(svc)

    def _alloc_name(self, service_id: str) -> str:
        return f"svc:{service_id}"

    def _release_chips_of(self, svc: Dict[str, Any]) -> None:
        self.allocator.release(self._alloc_name(svc["id"]))

    def _sharing_ok(self) -> bool:
        """Whether time-sliced chip co-ownership is allowed: only with
        thread services, and not with ``RAFIKI_TPU_CHIP_SHARE=0``. It is
        a liveness fallback for a job's FIRST worker, never extra
        capacity."""
        return self.container.supports_chip_sharing \
            and os.environ.get("RAFIKI_TPU_CHIP_SHARE", "1") != "0"

    def _launch_on_group(self, svc_row: Dict[str, Any], group,
                         env: Dict[str, str]) -> Dict[str, Any]:
        """Launch one service holding a chip group. On failure its chips
        are released and its row marked ERRORED before re-raising."""
        chips = list(group.indices)
        env[EnvVars.CHIPS] = group.to_env()
        try:
            container_id = self.container.create_service(svc_row["id"], env)
        except Exception:
            self.allocator.release(self._alloc_name(svc_row["id"]))
            self.meta.update_service(svc_row["id"],
                                     status=ServiceStatus.ERRORED)
            raise
        self.meta.update_service(svc_row["id"], container_id=container_id,
                                 chips=chips)
        return self.meta.get_service(svc_row["id"])

    # --- Train services ---

    def create_train_services(self, train_job_id: str) -> List[Dict[str, Any]]:
        job = self.meta.get_train_job(train_job_id)
        budget = normalize_budget(job["budget"])
        chips_per_trial = max(1, int(budget.get(CHIPS_PER_TRIAL, 1)))
        chip_count = int(budget.get(BudgetOption.CHIP_COUNT, 0) or 0)
        n_workers = max(1, math.ceil(chip_count / chips_per_trial))

        services = []
        for sub in self.meta.get_sub_train_jobs(train_job_id):
            advisor_svc = self._launch(
                ServiceType.ADVISOR, {EnvVars.SUB_TRAIN_JOB_ID: sub["id"]})
            self.meta.add_train_job_worker(advisor_svc["id"], sub["id"])
            services.append(advisor_svc)
            launched = 0
            for _ in range(n_workers):
                # Only the first worker may share a chip: it keeps a new
                # job live on a full card; more workers are capacity.
                svc = self.add_train_worker(
                    sub["id"], chips_per_trial,
                    shared_ok=(launched == 0 and self._sharing_ok()))
                if svc is None:
                    _log.warning("chip allocation exhausted for %s after "
                                 "%d workers", sub["id"], launched)
                    break
                services.append(svc)
                launched += 1
            if launched == 0:
                self._stop_service(advisor_svc["id"])
                raise RuntimeError(
                    f"no chips available for train job {train_job_id}")
        return services

    def add_train_worker(self, sub_id: str, chips_per_trial: int = 1,
                         shared_ok: bool = False,
                         ) -> Optional[Dict[str, Any]]:
        """Attach one train worker for ``sub_id`` on this node's chips;
        None when they are exhausted (``shared_ok`` admits the
        time-sliced tier)."""
        svc_row = self.meta.create_service(ServiceType.TRAIN,
                                           ServiceStatus.DEPLOYING,
                                           node_id=self.node_id)
        group = self.allocator.allocate(chips_per_trial,
                                        name=self._alloc_name(svc_row["id"]),
                                        shared_ok=shared_ok)
        if group is None:
            self.meta.update_service(svc_row["id"],
                                     status=ServiceStatus.STOPPED)
            return None
        env = self._base_env(svc_row["id"], ServiceType.TRAIN)
        env[EnvVars.SUB_TRAIN_JOB_ID] = sub_id
        svc = self._launch_on_group(svc_row, group, env)
        self.meta.add_train_job_worker(svc_row["id"], sub_id)
        return svc

    def stop_train_services(self, train_job_id: str) -> None:
        """Every stop of a train job (``stop_train_job``, its wind-down,
        its end after the workers gave up) comes here, so this is also
        where the job's scoped rung checkpoints are swept: a stopped job
        never reaches the workers' own sweep (ref :276-300). A worker
        restarted mid-job does not come through here."""
        for sub in self.meta.get_sub_train_jobs(train_job_id):
            for w in self.meta.get_train_job_workers(sub["id"]):
                self._stop_service(w["service_id"])
            self._sweep_scoped_checkpoints(sub["id"])

    def _sweep_scoped_checkpoints(self, sub_id: str) -> None:
        if not self.params_dir:
            return
        root = os.path.join(self.params_dir, "ckpt")
        if not os.path.isdir(root):
            return
        for name in os.listdir(root):
            if name.startswith(f"{sub_id}-"):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    def _ownership(self, svc: Dict[str, Any]) -> str:
        """``"local"``, ``"foreign"`` or ``"unowned-skip"``: a row
        without a node is this node's when it adopts such rows (a
        primary), and neither stopped nor judged by a join node."""
        nid = svc.get("node_id")
        if nid == self.node_id:
            return "local"
        if nid is None:
            return "local" if self.adopt_unowned else "unowned-skip"
        return "foreign"

    def is_local(self, svc: Dict[str, Any]) -> bool:
        """Whether this node launched (or adopted) the service."""
        return self._ownership(svc) == "local"

    @staticmethod
    def last_heartbeat(svc: Dict[str, Any]) -> float:
        """A service's last liveness signal (its creation counts)."""
        return svc.get("heartbeat_at") or svc.get("created_at") or 0.0

    def _lease_fresh(self, svc: Dict[str, Any]) -> bool:
        return time.time() - self.last_heartbeat(svc) <= self.NODE_LEASE

    def heartbeat(self) -> None:
        """Refresh this node's liveness lease, and its node registry
        record when there is one (a broker outage must not starve the
        lease)."""
        self.meta.touch_node_services(self.node_id)
        if self.node_registry is not None:
            try:
                self.node_registry.announce()
            except (ConnectionError, OSError, RuntimeError):
                _log.warning("node registry announce failed",
                             exc_info=True)

    def train_services_active(self, train_job_id: str) -> bool:
        """True while any TRAIN worker of the job is alive: this node's
        by its container manager, another node's (a join node's) by its
        row while that node's lease is fresh, so a node that died
        without shutting down stops holding the job open once its lease
        lapses."""
        for sub in self.meta.get_sub_train_jobs(train_job_id):
            for w in self.meta.get_train_job_workers(sub["id"]):
                svc = self.meta.get_service(w["service_id"])
                if svc["service_type"] != ServiceType.TRAIN \
                        or svc["status"] not in _ACTIVE:
                    continue
                if self._ownership(svc) != "local":
                    if self._lease_fresh(svc):
                        return True
                    continue
                if self.container.service_alive(
                        svc["container_id"] or svc["id"]):
                    return True
        return False

    # --- Inference services ---

    def create_inference_services(self, inference_job_id: str,
                                  trial_ids: List[str],
                                  chips_per_worker: int = 1,
                                  ) -> List[Dict[str, Any]]:
        """One worker a chip group, as many groups as fit up to one a
        trial, the trials dealt round-robin into the groups' bins, then
        the predictor. The first group may be time-sliced."""
        grabbed: List[Dict[str, Any]] = []
        for _ in trial_ids:
            svc_row = self.meta.create_service(ServiceType.INFERENCE,
                                               ServiceStatus.DEPLOYING,
                                               node_id=self.node_id)
            group = self.allocator.allocate(
                chips_per_worker, name=self._alloc_name(svc_row["id"]),
                shared_ok=(not grabbed and self._sharing_ok()))
            if group is None:
                self.meta.update_service(svc_row["id"],
                                         status=ServiceStatus.STOPPED)
                break
            grabbed.append({"row": svc_row, "group": group})
        if not grabbed:
            raise RuntimeError(
                f"no chips available for inference job {inference_job_id} "
                f"(need {chips_per_worker}/worker; "
                f"{self.allocator.free_chips} free)")
        bins: List[List[str]] = [[] for _ in grabbed]
        for i, tid in enumerate(trial_ids):
            bins[i % len(grabbed)].append(tid)

        services = []
        for holder, bin_ids in zip(grabbed, bins):
            svc_row = holder["row"]
            try:
                svc = self._launch_inference_worker(
                    svc_row, holder["group"], inference_job_id,
                    ",".join(bin_ids))
            except Exception:
                # Roll back the holders not yet launched and the workers
                # already launched for this job.
                launched_ids = {s["id"] for s in services}
                for h in grabbed:
                    hid = h["row"]["id"]
                    if hid in launched_ids or hid == svc_row["id"]:
                        continue
                    self.allocator.release(self._alloc_name(hid))
                    self.meta.update_service(hid,
                                             status=ServiceStatus.STOPPED)
                for launched in services:
                    self._stop_service(launched["id"])
                raise
            services.append(svc)
        predictor = self._launch(ServiceType.PREDICT,
                                 {EnvVars.INFERENCE_JOB_ID: inference_job_id})
        self.meta.add_inference_job_worker(predictor["id"], inference_job_id,
                                           PREDICTOR_TRIAL)
        services.append(predictor)
        return services

    def _launch_inference_worker(self, svc_row: Dict[str, Any], group,
                                 inference_job_id: str, trial_id: str,
                                 ) -> Dict[str, Any]:
        env = self._base_env(svc_row["id"], ServiceType.INFERENCE)
        env[EnvVars.INFERENCE_JOB_ID] = inference_job_id
        env[EnvVars.TRIAL_ID] = trial_id
        svc = self._launch_on_group(svc_row, group, env)
        self.meta.add_inference_job_worker(svc_row["id"], inference_job_id,
                                           trial_id)
        return svc

    def add_inference_worker(self, inference_job_id: str, trial_id: str,
                             chips_per_worker: int = 1,
                             ) -> Optional[Dict[str, Any]]:
        """One more worker for an already-served trial bin on this node's
        chips (what ``supervise`` respawns a dead worker with); None
        when the chips are exhausted, even time-sliced."""
        svc_row = self.meta.create_service(ServiceType.INFERENCE,
                                           ServiceStatus.DEPLOYING,
                                           node_id=self.node_id)
        group = self.allocator.allocate(
            chips_per_worker, name=self._alloc_name(svc_row["id"]),
            shared_ok=self._sharing_ok())
        if group is None:
            self.meta.update_service(svc_row["id"],
                                     status=ServiceStatus.STOPPED)
            return None
        return self._launch_inference_worker(svc_row, group,
                                             inference_job_id, trial_id)

    def serving_bus(self):
        """The bus this node's serving plane rides: the thread services'
        shared one, else a client of ``bus_uri``, opened once."""
        bus = getattr(getattr(self.container, "ctx", None), "bus", None)
        if bus is not None:
            return bus
        if self._reap_bus is None:
            from ..bus import connect

            self._reap_bus = connect(self.bus_uri)
        return self._reap_bus

    def _reap_worker_registration(self, job_id: str,
                                  service_id: str) -> None:
        """Drop a dead worker's bus registration, best effort: a broker
        that is down forgot it anyway."""
        try:
            Cache(self.serving_bus()).unregister_worker(job_id, service_id)
        except (ConnectionError, OSError, RuntimeError):
            _log.warning("could not reap the bus registration of dead "
                         "worker %s", service_id[:8], exc_info=True)

    def active_inference_workers(self, inference_job_id: str,
                                 ) -> List[Dict[str, Any]]:
        """The job's worker mapping rows (the predictor's left out) whose
        services are active: what is served now. A replaced worker's row
        stays for history, so liveness is its service's status."""
        rows = []
        for w in self.meta.get_inference_job_workers(inference_job_id):
            if w["trial_id"] == PREDICTOR_TRIAL:
                continue
            svc = self.meta.get_service(w["service_id"])
            if svc is not None and svc["status"] in _ACTIVE:
                rows.append(w)
        return rows

    def swap_inference_worker(self, inference_job_id: str, trial_id: str,
                              replace_service_ids: List[str] = (),
                              register_timeout: float = 180.0,
                              ) -> Dict[str, Any]:
        """Launch a worker for ``trial_id``, wait for its bus registration
        (a worker registers once its model is loaded and warm), and only
        then stop the ``replace_service_ids`` workers. A timeout or a
        worker that errors at start stops the new one and raises; the
        replaced workers are untouched. Callers serialise swaps (the
        admin's promote lock)."""
        new_svc = self.add_inference_worker(inference_job_id, trial_id)
        if new_svc is None:
            raise RuntimeError(
                "no chips available for the incoming trial's worker")
        cache = Cache(self.serving_bus())
        deadline = time.monotonic() + register_timeout
        while new_svc["id"] not in cache.running_workers(inference_job_id):
            if time.monotonic() >= deadline:
                self._stop_service(new_svc["id"])
                raise RuntimeError(
                    f"incoming worker {new_svc['id'][:8]} did not "
                    f"register within {register_timeout}s; swap rolled "
                    f"back")
            row = self.meta.get_service(new_svc["id"])
            if row and row["status"] == ServiceStatus.ERRORED:
                self._stop_service(new_svc["id"])
                raise RuntimeError(
                    f"incoming worker {new_svc['id'][:8]} errored "
                    f"during startup")
            time.sleep(0.2)
        stopped = []
        for sid in replace_service_ids:
            self._stop_service(sid)
            stopped.append(sid)
        return {"new_service": new_svc, "stopped_service_ids": stopped}

    def drain_inference_worker(self, service_id: str,
                               drain_timeout: float = 15.0,
                               ) -> Dict[str, Any]:
        """Retire one inference worker gracefully: unregister it, so the
        predictor's next plan leaves it out, and queue a drain marker,
        so it answers everything queued before and exits; then stop the
        service and release its chips. A shard sent after the marker
        goes unanswered and is resubmitted to a sibling. A worker still
        running after ``drain_timeout`` is stopped hard; either way the
        row ends STOPPED. Returns ``{"service_id", "drained"}``."""
        row = self.meta.get_inference_job_worker(service_id)
        drained = False
        if row is not None:
            cache = Cache(self.serving_bus())
            cache.unregister_worker(row["inference_job_id"], service_id)
            cache.send_drain(service_id)
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                svc = self.meta.get_service(service_id)
                if svc is None or svc["status"] not in _ACTIVE:
                    drained = True
                    break
                time.sleep(0.05)
        self._stop_service(service_id)
        return {"service_id": service_id, "drained": drained}

    def stop_inference_services(self, inference_job_id: str) -> None:
        for w in self.meta.get_inference_job_workers(inference_job_id):
            self._stop_service(w["service_id"])

    def stop_own_services(self) -> None:
        """Stop every still-active service this node launched: a node
        leaving a shared meta store must leave no row that reads as a
        live worker."""
        for svc in self.meta.get_services():
            if svc["status"] in _ACTIVE and self.is_local(svc):
                self._stop_service(svc["id"])

    # --- Supervision ---

    def supervise(self) -> List[str]:
        """One sweep over the RUNNING services: mark this node's dead
        ones ERRORED, restart a dead train worker on a fresh chip group
        and give a dead inference worker's bin a fresh worker while its
        job is live; mark another node's rows ERRORED once its lease
        lapsed. Returns the ids of the restarted services."""
        restarted: List[str] = []
        pending, self._pending_respawns = self._pending_respawns, []
        try:
            for svc in self.meta.get_services(status=ServiceStatus.RUNNING):
                own = self._ownership(svc)
                if own == "unowned-skip":
                    continue
                if own == "foreign":
                    if not self._lease_fresh(svc):
                        self.meta.update_service(
                            svc["id"], status=ServiceStatus.ERRORED)
                        _log.warning("lease expired on %s from node %s; "
                                     "marked errored", svc["id"][:8],
                                     svc["node_id"])
                    continue
                if self.container.service_alive(svc["container_id"]
                                                or svc["id"]):
                    continue
                self.meta.update_service(svc["id"],
                                         status=ServiceStatus.ERRORED)
                self._release_chips_of(svc)
                new_svc = None
                if svc["service_type"] == ServiceType.TRAIN:
                    new_svc = self._respawn_train_worker(svc)
                elif svc["service_type"] == ServiceType.INFERENCE:
                    try:
                        new_svc = self._respawn_inference_worker(svc)
                    except Exception:
                        _log.exception("respawn of dead inference worker "
                                       "%s failed; queued for retry",
                                       svc["id"][:8])
                        self._pending_respawns.append(svc)
                self._note_restart(svc, new_svc, restarted)
            while pending:
                self._note_restart(
                    pending[0],
                    self._respawn_inference_worker(pending[0], reap=False),
                    restarted)
                pending.pop(0)
        finally:
            self._pending_respawns.extend(pending)
        if self.slo_engine is not None or self.autoscaler is not None:
            self._sweep_control_loop()
        if self._node_faults is not None:
            # At the sweep's end, so what it kills stays dead until the
            # next sweep respawns it.
            act = self._node_faults(op=self.node_id)
            if act is not None and act[0] == "kill":
                self._kill_node_services()
        return restarted

    def _sweep_control_loop(self) -> None:
        """The SLO sweep, then the autoscaler's, over one shared scrape
        cache (each endpoint fetched once). Each is isolated: its failure
        is logged and the supervise sweep goes on."""
        from .scrape import ScrapeCache

        scrapes = ScrapeCache()
        for name, consumer in (("slo", self.slo_engine),
                               ("autoscale", self.autoscaler)):
            if consumer is None:
                continue
            try:
                consumer.sweep(scrapes=scrapes)
            except Exception:
                _log.exception("%s sweep failed", name)

    def _kill_node_services(self) -> None:
        """The whole node's death (``node.kill``): hard-kill every
        RUNNING service this node owns, with no meta update and no chip
        release; the next sweep's dead-service path does the rest."""
        victims = [svc for svc in self.meta.get_services()
                   if svc["status"] == ServiceStatus.RUNNING
                   and self.is_local(svc)]
        _log.warning("node.kill fired on node %s: hard-killing %d running "
                     "services", self.node_id, len(victims))
        for svc in victims:
            try:
                self.container.kill_service(svc["container_id"]
                                            or svc["id"])
            except Exception:
                _log.exception("node.kill: hard kill of %s failed",
                               svc["id"][:8])

    @staticmethod
    def _note_restart(svc: Dict[str, Any],
                      new_svc: Optional[Dict[str, Any]],
                      restarted: List[str]) -> None:
        if new_svc is None:
            return
        restarted.append(new_svc["id"])
        _log.warning("restarted dead %s worker %s as %s",
                     svc["service_type"], svc["id"][:8], new_svc["id"][:8])

    def _respawn_train_worker(self, svc: Dict[str, Any],
                              ) -> Optional[Dict[str, Any]]:
        row = self.meta.get_train_job_worker(svc["id"])
        if row is None:
            return None
        # Only while its job is live: a worker that died as its job
        # stopped is not restarted.
        sub = self.meta.get_sub_train_job(row["sub_train_job_id"])
        job = self.meta.get_train_job(sub["train_job_id"]) if sub else None
        if job is None or job["status"] not in (TrainJobStatus.STARTED,
                                                TrainJobStatus.RUNNING):
            return None
        # shared_ok as at admission: a worker admitted time-sliced could
        # otherwise never restart on a still-full card.
        return self.add_train_worker(
            row["sub_train_job_id"],
            chips_per_trial=len(svc.get("chips") or [1]),
            shared_ok=self._sharing_ok())

    def _respawn_inference_worker(self, svc: Dict[str, Any],
                                  reap: bool = True,
                                  ) -> Optional[Dict[str, Any]]:
        """A fresh worker for a dead worker's bin, only while its job is
        live. No chips -> queued on ``_pending_respawns``."""
        row = self.meta.get_inference_job_worker(svc["id"])
        if row is None:
            return None
        job_id, trial_id = row["inference_job_id"], row["trial_id"]
        if reap:
            # A dead worker never ran its unregister: reap its stale
            # registration so the predictor stops sending it shards.
            self._reap_worker_registration(job_id, svc["id"])
        job = self.meta.get_inference_job(job_id)
        if job is None or job["status"] not in (
                InferenceJobStatus.STARTED, InferenceJobStatus.RUNNING):
            return None
        n_chips = len(svc.get("chips") or [1])
        # Probe capacity first: a failed add leaves an orphan STOPPED
        # row, and this queue retries every sweep.
        probe = f"respawn-probe:{svc['id']}"
        group = self.allocator.allocate(n_chips, name=probe,
                                        shared_ok=self._sharing_ok())
        if group is None:
            self._pending_respawns.append(svc)
            return None
        self.allocator.release(probe)
        new_svc = self.add_inference_worker(job_id, trial_id,
                                            chips_per_worker=n_chips)
        if new_svc is None:
            self._pending_respawns.append(svc)
        return new_svc

    # --- Utilization ---

    def chip_utilization(self) -> float:
        """The share of this node's chips that hold a service (a
        time-sliced chip counts once)."""
        return self.allocator.utilization()
