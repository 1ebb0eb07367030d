"""Admin REST API: the HTTP surface over ``Admin``.

The port's copy of the routes of ``rafiki_tpu/admin/app.py`` that
``Client`` and the quickstart use:

- ``POST /tokens``                     login -> ``{user_id, user_type, token}``
- ``POST /users``, ``GET /users``      (admin) create, list users
- ``POST /users/<user_id>/ban``        (admin) ban a user
- ``POST /models``, ``GET /models``    register (class path or
                                       ``model_source``), list models
- ``POST /train_jobs``, ``GET /train_jobs``
- ``GET  /train_jobs/<job_id>``        job detail and per-model progress
- ``POST /train_jobs/<job_id>/stop``
- ``GET  /train_jobs/<job_id>/trials`` ``?type=best&max_count=k`` or all
- ``GET  /trials/<trial_id>/logs``
- ``POST /inference_jobs``, ``GET /inference_jobs``
- ``GET  /inference_jobs/<job_id>``    with ``predictor_host``
- ``GET  /inference_jobs/<job_id>/stats`` the predictor's ``/stats``
- ``POST /inference_jobs/<job_id>/stop``
- ``POST /inference_jobs/<job_id>/promote`` ``{"trial_id", optional
                                       "replace_trial_id"}``: a trained
                                       trial into the running job
                                       (``Admin.promote_trial``)
- ``POST /inference_jobs/<job_id>/profile`` ``{"duration_s"}`` (5 by
                                       default, clamped to [0.5, 60]):
                                       a device profile of one live
                                       worker
                                       (``Admin.profile_inference_job``)
- ``GET  /trace/<trace_id>``           one trace's spans, in order
- ``GET  /services``                   service rows
- ``GET  /status``                     chips, running services and each
                                       running trial's MFU
- ``GET  /trial_phases``               the trial phases and the cache
                                       counters
- ``GET  /metrics``                    the process registry
                                       (``JsonHttpServer``)

Auth: ``Authorization: Bearer <jwt>`` on everything but ``POST
/tokens`` and ``GET /metrics``. Every other route of the reference
answers 404 until it is ported (ROADMAP, queue 1): the dashboard,
autoscale, nodes, SLO, alerts, capacity, datasets and service logs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..constants import UserType
from ..utils.service import HttpError, JsonHttpServer
from .admin import Admin


class AdminApp:
    def __init__(self, admin: Admin, host: str = "127.0.0.1", port: int = 0):
        self.admin = admin
        self._http = JsonHttpServer([
            ("POST", "/tokens", self._login),
            ("POST", "/users", self._create_user),
            ("GET", "/users", self._list_users),
            ("POST", "/users/<user_id>/ban", self._ban_user),
            ("POST", "/models", self._create_model),
            ("GET", "/models", self._list_models),
            ("POST", "/train_jobs", self._create_train_job),
            ("GET", "/train_jobs", self._list_train_jobs),
            ("GET", "/train_jobs/<job_id>", self._get_train_job),
            ("POST", "/train_jobs/<job_id>/stop", self._stop_train_job),
            ("GET", "/train_jobs/<job_id>/trials", self._get_trials),
            ("GET", "/trials/<trial_id>/logs", self._get_trial_logs),
            ("POST", "/inference_jobs", self._create_inference_job),
            ("GET", "/inference_jobs", self._list_inference_jobs),
            ("GET", "/inference_jobs/<job_id>", self._get_inference_job),
            ("GET", "/inference_jobs/<job_id>/stats",
             self._inference_job_stats),
            ("POST", "/inference_jobs/<job_id>/stop",
             self._stop_inference_job),
            ("POST", "/inference_jobs/<job_id>/promote",
             self._promote_trial),
            ("POST", "/inference_jobs/<job_id>/profile",
             self._profile_inference_job),
            ("GET", "/trace/<trace_id>", self._get_trace),
            ("GET", "/services", self._list_services),
            ("GET", "/status", self._status),
            ("GET", "/trial_phases", self._trial_phases),
        ], host=host, port=port, name="admin")
        self.host = self._http.host
        self.port = self._http.port

    def start(self) -> "AdminApp":
        self._http.start()
        return self

    def stop(self) -> None:
        self._http.stop()

    # --- Auth helpers ---

    def _auth(self, ctx, *allowed: str) -> Dict[str, Any]:
        token = ctx.bearer_token
        if token is None:
            raise HttpError(401, "missing bearer token")
        claims = self.admin.authorize(token)
        if allowed and claims["user_type"] not in allowed:
            raise HttpError(403, f"requires one of {sorted(allowed)}")
        return claims

    @staticmethod
    def _need(body: Optional[Dict[str, Any]], *keys: str) -> Dict[str, Any]:
        if body is None:
            raise HttpError(400, "missing JSON body")
        missing = [k for k in keys if k not in body]
        if missing:
            raise HttpError(400, f"missing fields: {missing}")
        return body

    # --- Routes ---

    def _login(self, params, body, ctx):
        body = self._need(body, "email", "password")
        return 200, self.admin.authenticate(body["email"], body["password"])

    def _create_user(self, params, body, ctx):
        self._auth(ctx, UserType.SUPERADMIN, UserType.ADMIN)
        body = self._need(body, "email", "password", "user_type")
        return 201, self.admin.create_user(body["email"], body["password"],
                                           body["user_type"])

    def _list_users(self, params, body, ctx):
        self._auth(ctx, UserType.SUPERADMIN, UserType.ADMIN)
        return 200, self.admin.get_users()

    def _ban_user(self, params, body, ctx):
        claims = self._auth(ctx, UserType.SUPERADMIN, UserType.ADMIN)
        return 200, self.admin.ban_user(params["user_id"], claims=claims)

    def _create_model(self, params, body, ctx):
        claims = self._auth(ctx, UserType.SUPERADMIN, UserType.ADMIN,
                            UserType.MODEL_DEVELOPER)
        body = self._need(body, "name", "task", "model_class")
        return 201, self.admin.create_model(
            claims["user_id"], body["name"], body["task"],
            body["model_class"], model_source=body.get("model_source"),
            dependencies=body.get("dependencies"),
            access_right=body.get("access_right", "PRIVATE"))

    def _list_models(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_models(claims["user_id"],
                                          task=ctx.query_one("task"))

    def _create_train_job(self, params, body, ctx):
        claims = self._auth(ctx)
        body = self._need(body, "app", "task", "model_ids",
                          "train_dataset_path", "val_dataset_path")
        return 201, self.admin.create_train_job(
            claims["user_id"], body["app"], body["task"], body["model_ids"],
            body.get("budget", {}), body["train_dataset_path"],
            body["val_dataset_path"],
            advisor_type=body.get("advisor_type"))

    def _list_train_jobs(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_train_jobs(claims["user_id"])

    def _get_train_job(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_train_job(params["job_id"], claims=claims)

    def _stop_train_job(self, params, body, ctx):
        claims = self._auth(ctx)
        self.admin.stop_train_job(params["job_id"], claims=claims)
        return 200, {"stopped": params["job_id"]}

    def _get_trials(self, params, body, ctx):
        claims = self._auth(ctx)
        if ctx.query_one("type") == "best":
            max_count = int(ctx.query_one("max_count", "2"))
            return 200, self.admin.get_best_trials(params["job_id"],
                                                   max_count, claims=claims)
        return 200, self.admin.get_trials(params["job_id"], claims=claims)

    def _get_trial_logs(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_trial_logs(params["trial_id"],
                                              claims=claims)

    def _create_inference_job(self, params, body, ctx):
        claims = self._auth(ctx)
        body = self._need(body, "train_job_id")
        return 201, self.admin.create_inference_job(
            claims["user_id"], body["train_job_id"],
            max_models=int(body.get("max_models", 2)), claims=claims)

    def _list_inference_jobs(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_inference_jobs(claims["user_id"])

    def _get_inference_job(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_inference_job(params["job_id"],
                                                 claims=claims)

    def _inference_job_stats(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_inference_job_stats(params["job_id"],
                                                       claims=claims)

    def _get_trace(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_trace(params["trace_id"])

    def _stop_inference_job(self, params, body, ctx):
        claims = self._auth(ctx)
        self.admin.stop_inference_job(params["job_id"], claims=claims)
        return 200, {"stopped": params["job_id"]}

    def _promote_trial(self, params, body, ctx):
        claims = self._auth(ctx)
        body = self._need(body, "trial_id")
        return 200, self.admin.promote_trial(
            params["job_id"], body["trial_id"],
            replace_trial_id=body.get("replace_trial_id"), claims=claims)

    def _profile_inference_job(self, params, body, ctx):
        claims = self._auth(ctx)
        duration = (body or {}).get("duration_s", 5.0)
        return 200, self.admin.profile_inference_job(
            params["job_id"], duration_s=duration, claims=claims)

    def _list_services(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_services(claims=claims)

    def _status(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_status()

    def _trial_phases(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_trial_phases()
