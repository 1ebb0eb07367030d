"""Admin: users, models, train jobs, inference jobs.

The port's copy of the ``Admin`` methods of ``rafiki_tpu/admin/admin.py``
that the REST service, ``Client`` and the quickstart use. The REST
frontend (``admin.app``) is a thin shell over this class; everything
here is also usable in process.

Access: ``claims`` are a bearer token's claims; ``None`` means a trusted
in-process caller. A resource is its owner's, or any admin's
(``check_access``).

Not ported yet (ROADMAP, queue 1): promotion, on-demand profiling,
serving stats, traces, the autoscaler, nodes, SLOs and alerts,
capacity, trial phases, dataset uploads, service logs, attaching
workers from another node, and the train-MFU gauge that ``get_status``
reads (its ``mfu`` is empty).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from ..constants import (BudgetOption, InferenceJobStatus, ModelAccessRight,
                         TrainJobStatus, TrialStatus, UserType)
from ..model.knobs import knob_config_to_json
from ..store import MetaStore, ParamStore
from ..utils import auth
from ..utils.model_loader import load_model_class
from .services_manager import ServicesManager, normalize_budget

_log = logging.getLogger(__name__)


class Admin:
    def __init__(self, meta: MetaStore, params: ParamStore,
                 services: ServicesManager, jwt_secret: str = "rafiki-tpu",
                 superadmin_email: str = "superadmin@rafiki",
                 superadmin_password: str = "rafiki"):
        self.meta = meta
        self.params = params
        self.services = services
        self.jwt_secret = jwt_secret
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

    # --- Services ---

    def get_services(self, claims: Optional[Dict[str, Any]] = None,
                     ) -> List[Dict[str, Any]]:
        """Service rows, newest first. Admins see every service; other
        users only those working for their own jobs."""
        rows = self.meta.get_services()
        if claims is not None and claims.get("user_type") not in (
                UserType.SUPERADMIN, UserType.ADMIN):
            owned = self.meta.get_owned_service_ids(claims.get("user_id"))
            rows = [r for r in rows if r["id"] in owned]
        rows.sort(key=lambda r: r["created_at"], reverse=True)
        return [{k: r.get(k) for k in
                 ("id", "service_type", "status", "chips", "node_id",
                  "created_at", "stopped_at")} for r in rows]

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
        self.services.stop_train_services(train_job_id)
        self.meta.update_train_job(train_job_id,
                                   status=TrainJobStatus.STOPPED,
                                   stopped_at=time.time())

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

    def get_inference_jobs(self, user_id: str) -> List[Dict[str, Any]]:
        return [dict(j) for j in self.meta.get_inference_jobs(user_id)]

    def stop_inference_job(self, inference_job_id: str,
                           claims: Optional[Dict[str, Any]] = None) -> None:
        self._owned_inference_job(inference_job_id, claims)
        self.services.stop_inference_services(inference_job_id)
        self.meta.update_inference_job(inference_job_id,
                                       status=InferenceJobStatus.STOPPED,
                                       stopped_at=time.time())

    # --- Node status ---

    def get_status(self) -> Dict[str, Any]:
        """Chip allocation, running services by type and a per-node view
        (service counts and heartbeat age)."""
        alloc = self.services.allocator
        by_type: Dict[str, int] = {}
        nodes: Dict[str, Dict[str, Any]] = {}
        now = time.time()
        this_node = self.services.node_id
        for s in self.meta.get_services(status="RUNNING"):
            by_type[s["service_type"]] = by_type.get(s["service_type"],
                                                     0) + 1
            nid = this_node if self.services.is_local(s) \
                else s["node_id"]
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
        return {"n_chips": alloc.n_chips,
                "free_chips": alloc.free_chips,
                "chip_allocation": round(alloc.utilization(), 4),
                "services_running": by_type,
                "node_id": this_node,
                "nodes": nodes,
                "mfu": {}}


def _public_model(m: Dict[str, Any]) -> Dict[str, Any]:
    return {"id": m["id"], "name": m["name"], "task": m["task"],
            "model_class": m["model_class"],
            "access_right": m["access_right"]}


def _public_trial(t: Dict[str, Any]) -> Dict[str, Any]:
    return {"id": t["id"], "no": t["no"], "score": t["score"],
            "knobs": t["knobs"], "status": t["status"],
            "params_id": t["params_id"]}
