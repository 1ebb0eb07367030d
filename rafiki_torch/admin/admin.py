"""Admin: users, models, train jobs, inference jobs.

The port's copy of the ``Admin`` methods of ``rafiki_tpu/admin/admin.py``
that the REST service, ``Client`` and the quickstart use. The REST
frontend (``admin.app``) is a thin shell over this class; everything
here is also usable in process.

Access: ``claims`` are a bearer token's claims; ``None`` means a trusted
in-process caller. A resource is its owner's, or any admin's
(``check_access``).

Serving reads: ``get_inference_job_stats`` (the job's predictor
``/stats``), ``get_trace`` (one trace stitched from the span log under
``services.log_dir``) and ``attach_inference_workers`` (one more
replica for every served bin).

Promotion (``promote_trial``) puts a COMPLETED trial of the job's train
job into a RUNNING inference job without a restart. When the trial to
replace is a member of a stacked bin, every worker serving that bin
restacks the member in place (``Cache.send_restack``) and the promote
waits for each one's registration to show the new bin; a worker that
does not confirm in time makes the promote raise, after the workers
that did confirm are restacked back. Otherwise a worker for the trial
is launched and waited for before the replaced workers stop
(``ServicesManager.swap_inference_worker``); without
``replace_trial_id`` the ensemble grows by one bin. Either way the
predictor's edge cache is invalidated before the promote returns, so no
later request is answered from a pre-promotion entry: on every frontend
the bus's frontend registry names (the cluster fabric), else on the job
row's one predictor; each must acknowledge, or the promote raises.
Promotes are serialised by one lock.

The cluster view: ``get_nodes`` is the node registry's snapshot (the
``GET /nodes`` body; ``{"enabled": false}`` off the fabric), and
``get_status`` folds its live and registered counts in as ``cluster``.

Observability: ``profile_inference_job`` starts a bounded device
profile on one live worker of a job (``Cache.send_profile``; the
artifact lands under ``<log_dir>/profiles/<job>/<ts>``),
``get_trial_phases`` reads the trial-phase breakdown and the cache
counters (``observe.phases``), and ``get_status``'s ``mfu`` reads the
train loops' ``rafiki_tpu_train_mfu_ratio`` gauge by trial. Time-sliced
trials each publish their own, so the card's MFU is their sum.

The control loop: ``get_autoscale``, ``get_slo`` and ``get_alerts`` are
the autoscaler's and the SLO engine's snapshots (``{"enabled": false}``
when the part is off), and ``get_capacity`` is the capacity engine's
(``admin/capacity.py``), always enabled.

The operator's data: ``create_dataset`` stores an uploaded dataset
file under ``datasets_dir`` (a name the server makes, so a client's
file name cannot leave the directory) and returns its row, whose
``path`` a train job names; ``get_service_logs`` reads the tail of one
service's log file under ``services.log_dir``. A user who is not an
admin sees only the services of their own jobs, and their logs.
"""

from __future__ import annotations

import json
import logging
import os
import re
import sqlite3
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ..cache import Cache
from ..constants import (BudgetOption, InferenceJobStatus, ModelAccessRight,
                         TrainJobStatus, TrialStatus, UserType)
from ..model.knobs import knob_config_to_json
from ..observe import metrics as obs_metrics
from ..observe import trace as obs_trace
from ..store import MetaStore, ParamStore
from ..utils import auth
from ..utils.model_loader import load_model_class
from ..utils.service_logs import service_log_path, tail_log
from .services_manager import ServicesManager, normalize_budget

_log = logging.getLogger(__name__)


class Admin:
    def __init__(self, meta: MetaStore, params: ParamStore,
                 services: ServicesManager, jwt_secret: str = "rafiki-tpu",
                 superadmin_email: str = "superadmin@rafiki",
                 superadmin_password: str = "rafiki",
                 datasets_dir: str = ""):
        self.meta = meta
        self.params = params
        self.services = services
        self.jwt_secret = jwt_secret
        # Where uploads land; "" refuses uploads (a job can always name
        # a dataset by its path on the node).
        self.datasets_dir = datasets_dir
        # A promote spans a registration wait; two at once could both
        # pass the "already served" check.
        self._promote_lock = threading.Lock()
        if self.meta.get_user_by_email(superadmin_email) is None:
            self.meta.create_user(
                superadmin_email, auth.hash_password(superadmin_password),
                UserType.SUPERADMIN)

    # --- Auth / users ---

    def authenticate(self, email: str, password: str) -> Dict[str, Any]:
        user = self.meta.get_user_by_email(email)
        if user is None or not auth.verify_password(password,
                                                   user["password_hash"]):
            raise PermissionError("invalid email or password")
        if user["banned_at"] is not None:
            raise PermissionError("user is banned")
        token = auth.encode_token(
            {"user_id": user["id"], "user_type": user["user_type"]},
            self.jwt_secret)
        return {"user_id": user["id"], "user_type": user["user_type"],
                "token": token}

    def authorize(self, token: str) -> Dict[str, Any]:
        """Decode a bearer token AND re-check the user row: a ban
        revokes existing sessions at once."""
        try:
            claims = auth.decode_token(token, self.jwt_secret)
        except ValueError as e:
            raise PermissionError(f"invalid token: {e}")
        user = self.meta.get_user(claims.get("user_id", ""))
        if user is None or user["banned_at"] is not None:
            raise PermissionError("user is banned or deleted")
        return claims

    def create_user(self, email: str, password: str,
                    user_type: str) -> Dict[str, Any]:
        user = self.meta.create_user(email, auth.hash_password(password),
                                     user_type)
        return {"id": user["id"], "email": email, "user_type": user_type}

    def get_users(self) -> List[Dict[str, Any]]:
        return [{"id": u["id"], "email": u["email"],
                 "user_type": u["user_type"],
                 "banned": u["banned_at"] is not None}
                for u in self.meta.get_users()]

    def ban_user(self, user_id: str,
                 claims: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        target = self.meta.get_user(user_id)
        if target is None:
            raise ValueError(f"unknown user {user_id}")
        # The root account stays recoverable (there is no unban), and a
        # self-ban would lock out the very session asking for it.
        if target["user_type"] == UserType.SUPERADMIN:
            raise PermissionError("the superadmin cannot be banned")
        if claims is not None and claims.get("user_id") == user_id:
            raise PermissionError("cannot ban yourself")
        self.meta.ban_user(user_id)
        return {"banned": user_id}

    # --- Access control ---

    @staticmethod
    def check_access(claims: Optional[Dict[str, Any]],
                     owner_user_id: str) -> None:
        """The owner, or a platform admin; else 403."""
        if claims is None:
            return
        if claims.get("user_id") == owner_user_id:
            return
        if claims.get("user_type") in (UserType.SUPERADMIN, UserType.ADMIN):
            return
        err = PermissionError("not the owner of this resource")
        err.status = 403
        raise err

    def _owned_train_job(self, train_job_id: str,
                         claims: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        job = self.meta.get_train_job(train_job_id)
        if job is None:
            raise ValueError(f"unknown train job {train_job_id}")
        self.check_access(claims, job["user_id"])
        return job

    def _owned_inference_job(self, job_id: str,
                             claims: Optional[Dict[str, Any]],
                             ) -> Dict[str, Any]:
        job = self.meta.get_inference_job(job_id)
        if job is None:
            raise ValueError(f"unknown inference job {job_id}")
        self.check_access(claims, job["user_id"])
        return job

    # --- Models ---

    def create_model(self, user_id: str, name: str, task: str,
                     model_class: str, model_source: Optional[str] = None,
                     dependencies: Optional[Dict[str, str]] = None,
                     access_right: str = ModelAccessRight.PRIVATE,
                     ) -> Dict[str, Any]:
        # Resolved now: a model that does not import or declare knobs is
        # refused at upload, not at trial time.
        cls = load_model_class(model_class, model_source)
        knob_config = knob_config_to_json(cls.get_knob_config())
        row = self.meta.create_model(
            user_id, name, task, model_class, knob_config,
            model_source=model_source, dependencies=dependencies,
            access_right=access_right)
        return {"id": row["id"], "name": name, "task": task}

    def get_models(self, user_id: str,
                   task: Optional[str] = None) -> List[Dict[str, Any]]:
        return [_public_model(m) for m in self.meta.get_models(user_id, task)]

    # --- Datasets ---

    def create_dataset(self, user_id: str, name: str, task: str,
                       data: bytes, filename: str = "") -> Dict[str, Any]:
        """Store an uploaded dataset file and return its row; its
        ``path`` is what a train job takes as a dataset path. The
        format is checked by the loader at train time; the upload only
        keeps the bytes. The stored name is the server's: only the
        client's extension survives, sanitised."""
        if not self.datasets_dir:
            raise ValueError("this node has no datasets dir configured")
        if not data:
            raise ValueError("empty dataset upload")
        os.makedirs(self.datasets_dir, exist_ok=True)
        ext = os.path.splitext(filename or "")[1]
        if not re.fullmatch(r"\.[A-Za-z0-9]{1,8}", ext or ""):
            ext = ".zip"
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", name)[:48] or "dataset"
        # The bytes land before the row: a failed write must not leave
        # a row without a file holding the name.
        path = os.path.join(self.datasets_dir,
                            f"{uuid.uuid4().hex[:12]}-{safe}{ext}")
        with open(path, "wb") as f:
            f.write(data)
        try:
            row = self.meta.create_dataset(user_id, name, task, path,
                                           len(data))
        except sqlite3.IntegrityError:
            os.unlink(path)
            raise ValueError(
                f"you already have a dataset named {name!r}; pick "
                f"another name")
        return dict(row)

    def get_datasets(self, user_id: str,
                     task: Optional[str] = None) -> List[Dict[str, Any]]:
        return self.meta.get_datasets(user_id, task=task)

    # --- Services ---

    def _sees_all_services(self,
                           claims: Optional[Dict[str, Any]]) -> bool:
        return claims is None or claims.get("user_type") in (
            UserType.SUPERADMIN, UserType.ADMIN)

    def get_services(self, claims: Optional[Dict[str, Any]] = None,
                     ) -> List[Dict[str, Any]]:
        """Service rows, newest first. Admins see every service; other
        users only those working for their own jobs."""
        rows = self.meta.get_services()
        if not self._sees_all_services(claims):
            owned = self.meta.get_owned_service_ids(claims.get("user_id"))
            rows = [r for r in rows if r["id"] in owned]
        rows.sort(key=lambda r: r["created_at"], reverse=True)
        return [{k: r.get(k) for k in
                 ("id", "service_type", "status", "chips", "node_id",
                  "created_at", "stopped_at")} for r in rows]

    def get_service_logs(self, service_id: str, max_bytes: int = 65536,
                         claims: Optional[Dict[str, Any]] = None,
                         ) -> Dict[str, Any]:
        """The tail of one service's log. Logs carry knobs, scores and
        dataset paths: only the owner of the service's job, or an
        admin, reads them. ``captured`` is false when the service never
        wrote one."""
        svc = self.meta.get_service(service_id)
        if svc is None:
            raise ValueError(f"unknown service {service_id}")
        if not self._sees_all_services(claims):
            owner = self.meta.get_service_owner(service_id)
            self.check_access(claims, owner or "")
        text = None
        if self.services.log_dir:
            text = tail_log(
                service_log_path(self.services.log_dir, service_id),
                max_bytes=max_bytes)
        return {"service_id": service_id, "status": svc["status"],
                "log": text, "captured": text is not None}

    # --- Train jobs ---

    def create_train_job(self, user_id: str, app: str, task: str,
                         model_ids: List[str], budget: Dict[str, Any],
                         train_dataset_path: str, val_dataset_path: str,
                         advisor_type: Optional[str] = None,
                         ) -> Dict[str, Any]:
        budget = normalize_budget(budget)
        budget.setdefault(BudgetOption.MODEL_TRIAL_COUNT, 5)
        if not model_ids:
            raise ValueError("model_ids must be non-empty")
        # Everything is checked BEFORE a row is written.
        for model_id in model_ids:
            model = self.meta.get_model(model_id)
            if model is None:
                raise ValueError(f"unknown model {model_id}")
            if model["task"] != task:
                raise ValueError(
                    f"model {model['name']} is for task {model['task']}, "
                    f"not {task}")
        job = self.meta.create_train_job(
            user_id, app, task, budget, train_dataset_path,
            val_dataset_path, TrainJobStatus.STARTED)
        for model_id in model_ids:
            self.meta.create_sub_train_job(job["id"], model_id, "STARTED",
                                           advisor_type=advisor_type)
        self.services.create_train_services(job["id"])
        self.meta.update_train_job(job["id"], status=TrainJobStatus.RUNNING)
        return {"id": job["id"], "app": job["app"],
                "app_version": job["app_version"]}

    def get_train_job(self, train_job_id: str,
                      claims: Optional[Dict[str, Any]] = None,
                      ) -> Dict[str, Any]:
        job = self._owned_train_job(train_job_id, claims)
        self._refresh_train_job_status(job)
        job = self.meta.get_train_job(train_job_id)
        subs = []
        for sub in self.meta.get_sub_train_jobs(train_job_id):
            trials = self.meta.get_trials(sub["id"])
            subs.append({
                "id": sub["id"], "model_id": sub["model_id"],
                "n_trials": len(trials),
                "n_completed": sum(t["status"] == TrialStatus.COMPLETED
                                   for t in trials),
                "n_errored": sum(t["status"] == TrialStatus.ERRORED
                                 for t in trials),
            })
        return {"id": job["id"], "app": job["app"],
                "app_version": job["app_version"], "task": job["task"],
                "status": job["status"], "budget": job["budget"],
                "sub_train_jobs": subs}

    def _refresh_train_job_status(self, job: Dict[str, Any]) -> None:
        if job["status"] != TrainJobStatus.RUNNING:
            return
        if not self.services.train_services_active(job["id"]):
            # The budget is spent and every worker wound down: tear the
            # services down (their chips come free).
            self.services.stop_train_services(job["id"])
            self.meta.update_train_job(job["id"],
                                       status=TrainJobStatus.STOPPED,
                                       stopped_at=time.time())

    def get_train_jobs(self, user_id: str) -> List[Dict[str, Any]]:
        return [{"id": j["id"], "app": j["app"],
                 "app_version": j["app_version"], "task": j["task"],
                 "status": j["status"]}
                for j in self.meta.get_train_jobs(user_id)]

    def stop_train_job(self, train_job_id: str,
                       claims: Optional[Dict[str, Any]] = None) -> None:
        self._owned_train_job(train_job_id, claims)
        # Marked first, as an inference job is: a supervise sweep must
        # not restart a worker of a job that is stopping.
        self.meta.update_train_job(train_job_id,
                                   status=TrainJobStatus.STOPPED,
                                   stopped_at=time.time())
        self.services.stop_train_services(train_job_id)

    def get_best_trials(self, train_job_id: str, max_count: int = 2,
                        claims: Optional[Dict[str, Any]] = None,
                        ) -> List[Dict[str, Any]]:
        self._owned_train_job(train_job_id, claims)
        return [_public_trial(t) for t in
                self.meta.get_best_trials_of_train_job(train_job_id,
                                                       max_count)]

    def get_trials(self, train_job_id: str,
                   claims: Optional[Dict[str, Any]] = None,
                   ) -> List[Dict[str, Any]]:
        self._owned_train_job(train_job_id, claims)
        return [_public_trial(t) for t in
                self.meta.get_trials_of_train_job(train_job_id)]

    def get_trial_logs(self, trial_id: str,
                       claims: Optional[Dict[str, Any]] = None,
                       ) -> List[Dict[str, Any]]:
        trial = self.meta.get_trial(trial_id)
        if trial is None:
            raise ValueError(f"unknown trial {trial_id}")
        if claims is not None:
            sub = self.meta.get_sub_train_job(trial["sub_train_job_id"])
            self._owned_train_job(sub["train_job_id"], claims)
        return self.meta.get_trial_logs(trial_id)

    def wait_until_train_job_done(self, train_job_id: str,
                                  timeout: float = 3600.0,
                                  poll: float = 1.0) -> bool:
        """Block until every train worker stops; False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.services.train_services_active(train_job_id):
                self._refresh_train_job_status(
                    self.meta.get_train_job(train_job_id))
                return True
            time.sleep(poll)
        return False

    def attach_workers(self, train_job_id: str, chips_per_trial: int = 1,
                       ) -> List[Dict[str, Any]]:
        """Training scale-out: one more train worker for each sub-job of
        a RUNNING train job, on this node's chips. A join node sharing
        the meta store, the params directory and the bus calls it; its
        workers take proposals from the job's advisor service, so the
        search stays one search."""
        job = self.meta.get_train_job(train_job_id)
        if job is None:
            raise ValueError(f"unknown train job {train_job_id}")
        if job["status"] != TrainJobStatus.RUNNING:
            raise ValueError(f"train job {train_job_id} is not RUNNING")
        attached = []
        for sub in self.meta.get_sub_train_jobs(train_job_id):
            svc = self.services.add_train_worker(sub["id"], chips_per_trial)
            if svc is not None:
                attached.append(svc)
        return attached

    def attach_inference_workers(self, inference_job_id: str,
                                 chips_per_worker: int = 1,
                                 ) -> List[Dict[str, Any]]:
        """Serving scale-out: one more replica worker for every served
        trial bin of a RUNNING inference job, on this node's chips. The
        predictor shards each bin's slice over its replicas."""
        from .services_manager import PREDICTOR_TRIAL

        job = self.meta.get_inference_job(inference_job_id)
        if job is None:
            raise ValueError(f"unknown inference job {inference_job_id}")
        if job["status"] != InferenceJobStatus.RUNNING:
            raise ValueError(
                f"inference job {inference_job_id} is not RUNNING")
        bins = {w["trial_id"]
                for w in self.meta.get_inference_job_workers(
                    inference_job_id)
                if w["trial_id"] != PREDICTOR_TRIAL}
        attached = []
        for trial_id in sorted(bins):
            svc = self.services.add_inference_worker(
                inference_job_id, trial_id, chips_per_worker)
            if svc is not None:
                attached.append(svc)
        return attached

    # --- Inference jobs ---

    def create_inference_job(self, user_id: str, train_job_id: str,
                             max_models: int = 2,
                             chips_per_worker: int = 1,
                             claims: Optional[Dict[str, Any]] = None,
                             ) -> Dict[str, Any]:
        self._owned_train_job(train_job_id, claims)
        best = self.meta.get_best_trials_of_train_job(train_job_id,
                                                      max_models)
        if not best:
            raise ValueError(
                f"train job {train_job_id} has no completed trials")
        inf = self.meta.create_inference_job(user_id, train_job_id,
                                             InferenceJobStatus.STARTED)
        try:
            self.services.create_inference_services(
                inf["id"], [t["id"] for t in best],
                chips_per_worker=chips_per_worker)
        except Exception:
            self.meta.update_inference_job(inf["id"],
                                           status=InferenceJobStatus.ERRORED)
            raise
        self.meta.update_inference_job(inf["id"],
                                       status=InferenceJobStatus.RUNNING)
        return {"id": inf["id"], "train_job_id": train_job_id,
                "trial_ids": [t["id"] for t in best]}

    def get_inference_job(self, inference_job_id: str,
                          claims: Optional[Dict[str, Any]] = None,
                          ) -> Dict[str, Any]:
        return dict(self._owned_inference_job(inference_job_id, claims))

    def promote_trial(self, inference_job_id: str, trial_id: str,
                      replace_trial_id: Optional[str] = None,
                      register_timeout: float = 180.0,
                      claims: Optional[Dict[str, Any]] = None,
                      ) -> Dict[str, Any]:
        """Promote a trained trial into a RUNNING inference job's
        ensemble (see the module docstring), replacing
        ``replace_trial_id`` or, without it, adding a bin."""
        with self._promote_lock:
            return self._promote_trial_locked(
                inference_job_id, trial_id, replace_trial_id,
                register_timeout, claims)

    def _promote_trial_locked(self, inference_job_id: str, trial_id: str,
                              replace_trial_id: Optional[str],
                              register_timeout: float,
                              claims: Optional[Dict[str, Any]],
                              ) -> Dict[str, Any]:
        job = self._owned_inference_job(inference_job_id, claims)
        if job["status"] != InferenceJobStatus.RUNNING:
            raise ValueError(
                f"inference job {inference_job_id} is not RUNNING")
        trial = self.meta.get_trial(trial_id)
        if trial is None:
            raise ValueError(f"unknown trial {trial_id}")
        if trial["status"] != TrialStatus.COMPLETED or \
                not trial.get("params_id"):
            raise ValueError(
                f"trial {trial_id} is not COMPLETED with saved params")
        sub = self.meta.get_sub_train_job(trial["sub_train_job_id"])
        if sub is None or sub["train_job_id"] != job["train_job_id"]:
            raise ValueError(
                f"trial {trial_id} does not belong to train job "
                f"{job['train_job_id']}")
        rows = self.services.active_inference_workers(inference_job_id)
        if any(trial_id in str(w["trial_id"]).split(",") for w in rows):
            raise ValueError(
                f"trial {trial_id} is already served by this job")
        old_rows: List[Dict[str, Any]] = []
        multi_rows: List[Dict[str, Any]] = []
        if replace_trial_id is not None:
            for w in rows:
                members = str(w["trial_id"]).split(",")
                if replace_trial_id not in members:
                    continue
                (multi_rows if len(members) > 1 else old_rows).append(w)
            if not old_rows and not multi_rows:
                raise ValueError(
                    f"trial {replace_trial_id} is not a served bin of "
                    f"this job")
            if multi_rows and old_rows:
                raise ValueError(
                    f"trial {replace_trial_id} is served both alone "
                    f"and inside a packed bin; promotion cannot "
                    f"target that mix")
        if multi_rows:
            result = self._restack_packed_bins(
                job, trial_id, replace_trial_id, multi_rows,
                register_timeout)
            self._invalidate_predictor_cache(job)
            return result
        swap = self.services.swap_inference_worker(
            inference_job_id, trial_id,
            replace_service_ids=[w["service_id"] for w in old_rows],
            register_timeout=register_timeout)
        self._invalidate_predictor_cache(job)
        _log.info("promoted trial %s into inference job %s (replaced %s; "
                  "stopped %d worker(s))", trial_id, inference_job_id,
                  replace_trial_id, len(swap["stopped_service_ids"]))
        return {"inference_job_id": inference_job_id,
                "promoted_trial_id": trial_id,
                "replaced_trial_id": replace_trial_id,
                "new_service_id": swap["new_service"]["id"],
                "stopped_service_ids": swap["stopped_service_ids"]}

    def _restack_packed_bins(self, job: Dict[str, Any], trial_id: str,
                             replace_trial_id: str,
                             multi_rows: List[Dict[str, Any]],
                             register_timeout: float) -> Dict[str, Any]:
        """Send a restack marker to every worker of the packed bin and
        wait until each one's registration shows the new member (a
        worker re-registers once the member is in its stacked storage).
        Only stacked workers can restack. On a timeout the workers that
        confirmed are restacked back and the promote raises."""
        inference_job_id = job["id"]
        cache = Cache(self.services.serving_bus())
        info = cache.running_worker_info(inference_job_id)
        not_stacked = [w["service_id"] for w in multi_rows
                       if not (info.get(w["service_id"]) or {})
                       .get("stacked")]
        if not_stacked:
            raise ValueError(
                f"bin {multi_rows[0]['trial_id']!r} packs several "
                f"trials and worker(s) "
                f"{[s[:8] for s in not_stacked]} serve it per-member; "
                f"promotion cannot surgically replace one member — "
                f"replace the whole bin (stacked workers restack in "
                f"place)")
        for w in multi_rows:
            cache.send_restack(w["service_id"], replace_trial_id, trial_id)
        deadline = time.monotonic() + register_timeout
        pending = {w["service_id"] for w in multi_rows}
        confirmed: List[str] = []
        while pending:
            if time.monotonic() >= deadline:
                self._rollback_restacks(cache, confirmed, trial_id,
                                        replace_trial_id, job)
                raise RuntimeError(
                    f"worker(s) {[s[:8] for s in sorted(pending)]} did "
                    f"not confirm the restack within "
                    f"{register_timeout}s; confirmed replica(s) "
                    f"{[s[:8] for s in confirmed]} were rolled back "
                    f"(reverse restack) so the old member set keeps "
                    f"serving")
            info = cache.running_worker_info(inference_job_id)
            for sid in list(pending):
                members = str((info.get(sid) or {})
                              .get("trial_id", "")).split(",")
                if trial_id in members and replace_trial_id not in members:
                    pending.discard(sid)
                    confirmed.append(sid)
            if pending:
                time.sleep(0.1)
        _log.info("promoted trial %s into inference job %s by restacking "
                  "%d packed worker(s) (replaced %s in place)", trial_id,
                  inference_job_id, len(multi_rows), replace_trial_id)
        return {"inference_job_id": inference_job_id,
                "promoted_trial_id": trial_id,
                "replaced_trial_id": replace_trial_id,
                "new_service_id": None,
                "restacked_service_ids": [w["service_id"]
                                          for w in multi_rows],
                "stopped_service_ids": []}

    def _rollback_restacks(self, cache: Cache, confirmed: List[str],
                           trial_id: str, replace_trial_id: str,
                           job: Dict[str, Any]) -> None:
        """A failed restack's undo: restack every worker that already
        swapped back to the old member, and invalidate the edge cache
        (answers of the partial window must not outlive it). Both are
        best effort: the promote raises anyway."""
        for sid in confirmed:
            try:
                cache.send_restack(sid, trial_id, replace_trial_id)
            except (ConnectionError, OSError, RuntimeError):
                _log.exception("reverse restack to %s failed; the replica "
                               "keeps the promoted member", sid[:8])
        if confirmed:
            try:
                self._invalidate_predictor_cache(job)
            except RuntimeError:
                _log.exception("edge-cache invalidation after a partial "
                               "restack failed")

    def _invalidate_predictor_cache(self, job: Dict[str, Any]) -> None:
        """``POST /cache/invalidate`` on each of the job's frontends,
        each of which must answer: raises when one does not, since its
        cached (or, through peer probes, re-exported) pre-promotion
        answers could otherwise outlive the swap. The frontends are the
        bus's frontend registry's (the cluster fabric); without an entry
        there, the job row's one predictor."""
        from urllib.request import Request, urlopen

        hosts: List[str] = []
        try:
            hosts = sorted(Cache(self.services.serving_bus())
                           .frontends(job["id"]).values())
        except (ConnectionError, OSError, RuntimeError):
            _log.warning("frontend registry unreachable; falling back to "
                         "the job row's predictor host", exc_info=True)
        if not hosts:
            host = job.get("predictor_host")
            if not host:
                return  # no frontend yet: nothing is cached
            hosts = [host]
        for host in hosts:
            try:
                req = Request(f"http://{host}/cache/invalidate",
                              data=b"{}",
                              headers={"Content-Type": "application/json"},
                              method="POST")
                with urlopen(req, timeout=10) as resp:
                    json.loads(resp.read())
            except OSError as e:
                raise RuntimeError(
                    f"promotion applied but the predictor at {host} did "
                    f"not acknowledge cache invalidation: {e}") from None

    def get_inference_jobs(self, user_id: str) -> List[Dict[str, Any]]:
        return [dict(j) for j in self.meta.get_inference_jobs(user_id)]

    def stop_inference_job(self, inference_job_id: str,
                           claims: Optional[Dict[str, Any]] = None) -> None:
        self._owned_inference_job(inference_job_id, claims)
        # The job is marked first: a supervise sweep that finds a worker
        # dead while it stops must see the job no longer live, or it
        # gives the bin a fresh worker that nothing stops.
        self.meta.update_inference_job(inference_job_id,
                                       status=InferenceJobStatus.STOPPED,
                                       stopped_at=time.time())
        self.services.stop_inference_services(inference_job_id)

    def get_inference_job_stats(self, inference_job_id: str,
                                claims: Optional[Dict[str, Any]] = None,
                                ) -> Dict[str, Any]:
        """The job's predictor ``/stats`` snapshot, read server-side
        with the ownership check every job read gets, and the
        ``/predict`` latency buckets' exemplars (with
        ``RAFIKI_TPU_METRICS_EXEMPLARS`` on)."""
        from urllib.request import urlopen

        job = self._owned_inference_job(inference_job_id, claims)
        host = job.get("predictor_host")
        if not host:
            raise ValueError(
                f"inference job {inference_job_id} has no predictor yet")
        try:
            with urlopen(f"http://{host}/stats", timeout=5) as resp:
                stats = json.loads(resp.read())
        except OSError as e:
            raise ValueError(
                f"predictor at {host} unreachable: {e}") from None
        stats["inference_job_id"] = inference_job_id
        hist = obs_metrics.registry().find(
            "rafiki_tpu_http_request_seconds")
        if hist is not None and stats.get("http_service"):
            stats["exemplars"] = hist.exemplars(
                service=stats["http_service"], route="/predict")
        return stats

    def profile_inference_job(self, inference_job_id: str,
                              duration_s: float = 5.0,
                              claims: Optional[Dict[str, Any]] = None,
                              ) -> Dict[str, Any]:
        """Start a bounded on-demand device profile on one live worker
        of the job (``POST /inference_jobs/<id>/profile``). The request
        travels as a ``__profile__`` marker in the worker's queue, so
        the worker starts the session between bursts and its serve loop
        stops it at the deadline: serving never pauses. The trace lands
        under ``<log_dir>/profiles/<job[:8]>/<ts>-<rand>``; a worker
        whose profiler is busy skips the request, which the caller sees
        as an empty directory."""
        import tempfile

        from ..observe.profiling import PROFILE_MAX_S

        job = self._owned_inference_job(inference_job_id, claims)
        if job["status"] != InferenceJobStatus.RUNNING:
            raise ValueError(
                f"inference job {inference_job_id} is not RUNNING")
        try:
            duration_s = float(duration_s)
        except (TypeError, ValueError):
            raise ValueError(f"duration_s {duration_s!r} is not a "
                             f"number") from None
        # The profiler holds buffers and the process's one session, so
        # a long request is clamped, not honoured.
        duration_s = min(max(0.5, duration_s), PROFILE_MAX_S)
        rows = self.services.active_inference_workers(inference_job_id)
        if not rows:
            raise ValueError(
                f"inference job {inference_job_id} has no active "
                f"workers to profile")
        target = rows[0]["service_id"]
        base = self.services.log_dir or os.path.join(
            tempfile.gettempdir(), "rafiki_tpu_profiles")
        out_dir = os.path.join(
            base, "profiles", inference_job_id[:8],
            f"{int(time.time())}-{uuid.uuid4().hex[:6]}")
        Cache(self.services.serving_bus()).send_profile(
            target, out_dir, duration_s)
        _log.info("profile session queued on worker %s of job %s "
                  "(%.1fs into %s)", target[:8], inference_job_id[:8],
                  duration_s, out_dir)
        return {"inference_job_id": inference_job_id,
                "service_id": target,
                "duration_s": duration_s,
                "profile_dir": out_dir}

    def get_trace(self, trace_id: str,
                  claims: Optional[Dict[str, Any]] = None,
                  ) -> Dict[str, Any]:
        """One trace's spans from the services' span log, as an ordered
        timeline. Any authenticated user may read it: a trace id is an
        unguessable handle given to the caller who sent the request."""
        log_dir = self.services.log_dir
        if not log_dir:
            return {"trace_id": trace_id, "n_spans": 0, "spans": []}
        return obs_trace.collect_trace(log_dir, trace_id)

    def get_trial_phases(self) -> Dict[str, Any]:
        """The trial phases' cumulative breakdown and the cache counters
        (``GET /trial_phases``). ``resident`` says whether this process
        has run trials (their series live in its registry)."""
        from ..observe import phases as obs_phases

        totals = obs_phases.phase_totals()
        resident = any(v["count"] for v in totals.values())
        phases = {
            p: {"count": int(v["count"]),
                "total_s": round(v["sum"], 3),
                "mean_ms": round(v["sum"] / v["count"] * 1e3, 1)
                if v["count"] else 0.0}
            for p, v in totals.items()}
        caches = {c: obs_phases.cache_counts(c)
                  for c in ("dataset", "stage")}
        return {"enabled": obs_metrics.metrics_enabled(),
                "resident": resident, "phases": phases,
                "caches": caches}

    # --- The control loop ---

    def get_autoscale(self) -> Dict[str, Any]:
        """The autoscaler's decision ring and per-bin targets (the
        ``GET /autoscale`` body), or ``{"enabled": false}`` when off."""
        scaler = getattr(self.services, "autoscaler", None)
        if scaler is None:
            return {"enabled": False}
        return scaler.snapshot()

    def get_slo(self) -> Dict[str, Any]:
        """The SLO engine's objectives and instances (``GET /slo``), or
        ``{"enabled": false}`` when no rule is armed."""
        engine = getattr(self.services, "slo_engine", None)
        if engine is None:
            return {"enabled": False}
        return engine.snapshot()

    def get_alerts(self) -> Dict[str, Any]:
        """The SLO engine's alert transitions, newest first
        (``GET /alerts``), or ``{"enabled": false}``."""
        engine = getattr(self.services, "slo_engine", None)
        if engine is None:
            return {"enabled": False}
        return engine.alerts_snapshot()

    def get_capacity(self) -> Dict[str, Any]:
        """The recorded-workload inventory and a canned-ramp gate of the
        policy this node would apply (``GET /capacity``); always
        enabled, since the gate needs only the simulator."""
        from . import capacity as capacity_mod

        return capacity_mod.admin_snapshot(self.services)

    # --- Node status ---

    def get_nodes(self) -> Dict[str, Any]:
        """The node registry's snapshot (the ``GET /nodes`` body), or
        ``{"enabled": false}`` off the cluster fabric."""
        registry = getattr(self.services, "node_registry", None)
        if registry is None:
            return {"enabled": False}
        return registry.snapshot()

    def get_status(self) -> Dict[str, Any]:
        """Chip allocation, running services by type, a per-node view
        (service counts and heartbeat age), ``mfu``: each running
        trial's last MFU reading (the train loops'
        ``rafiki_tpu_train_mfu_ratio`` gauge, by its ``trial`` label),
        and on the cluster fabric ``cluster``, the node registry's
        health."""
        alloc = self.services.allocator
        by_type: Dict[str, int] = {}
        nodes: Dict[str, Dict[str, Any]] = {}
        now = time.time()
        this_node = self.services.node_id
        for s in self.meta.get_services(status="RUNNING"):
            by_type[s["service_type"]] = by_type.get(s["service_type"],
                                                     0) + 1
            nid = this_node if self.services.is_local(s) \
                else (s.get("node_id") or "(unowned)")
            node = nodes.setdefault(nid, {"services": 0,
                                          "heartbeat_age_s": None})
            node["services"] += 1
            hb = self.services.last_heartbeat(s)
            if hb:
                age = round(max(0.0, now - hb), 1)
                if node["heartbeat_age_s"] is None \
                        or age < node["heartbeat_age_s"]:
                    node["heartbeat_age_s"] = age
        nodes.setdefault(this_node, {"services": 0, "heartbeat_age_s": 0.0})
        mfu: Dict[str, float] = {}
        gauge = obs_metrics.registry().find("rafiki_tpu_train_mfu_ratio")
        if gauge is not None:
            for labels, value in gauge.samples():
                mfu[labels.get("trial", "(unlabeled)")] = round(value, 4)
        out = {"n_chips": alloc.n_chips,
               "free_chips": alloc.free_chips,
               "chip_allocation": round(alloc.utilization(), 4),
               "services_running": by_type,
               "node_id": this_node,
               "nodes": nodes,
               "mfu": mfu}
        # The node registry also counts live nodes that run no service
        # yet, which the meta rows above cannot show.
        registry = getattr(self.services, "node_registry", None)
        if registry is not None:
            try:
                out["cluster"] = registry.health()
            except (ConnectionError, OSError, RuntimeError):
                out["cluster"] = {"fabric": True,
                                  "error": "registry unreachable"}
        return out


def _public_model(m: Dict[str, Any]) -> Dict[str, Any]:
    return {"id": m["id"], "name": m["name"], "task": m["task"],
            "model_class": m["model_class"],
            "access_right": m["access_right"]}


def _public_trial(t: Dict[str, Any]) -> Dict[str, Any]:
    return {"id": t["id"], "no": t["no"], "score": t["score"],
            "knobs": t["knobs"], "status": t["status"],
            "params_id": t["params_id"]}
