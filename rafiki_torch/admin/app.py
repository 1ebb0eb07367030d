"""Admin REST API: the HTTP surface over ``Admin``.

The port's copy of the routes of ``rafiki_tpu/admin/app.py``, all of
them:

- ``GET  /``                           the dashboard (``web/``), no auth
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
- ``POST /datasets``                   upload a dataset: the file is the
                                       raw body (a type that is not
                                       JSON), ``?name=&task=&filename=``
- ``GET  /datasets``                   the caller's datasets (``?task=``)
- ``GET  /services``                   service rows
- ``GET  /services/<service_id>/logs`` the tail of one service's log
                                       (``?max_bytes=``, 65536 by
                                       default)
- ``GET  /status``                     chips, running services, each
                                       running trial's MFU and, on the
                                       cluster fabric, ``cluster``
- ``GET  /nodes``                      the cluster node registry
                                       (``{"enabled": false}`` off the
                                       fabric)
- ``GET  /trial_phases``               the trial phases and the cache
                                       counters
- ``GET  /autoscale``                  the autoscaler's decisions and
                                       per-bin targets
- ``GET  /slo``, ``GET /alerts``       the SLO engine's objectives and
                                       its alert transitions (each
                                       ``{"enabled": false}`` when its
                                       part is off)
- ``GET  /capacity``                   the recorded workload and the
                                       canned-ramp gate of this node's
                                       policy (always enabled)
- ``GET  /metrics``                    the process registry
                                       (``JsonHttpServer``)

Auth: ``Authorization: Bearer <jwt>`` on everything but ``GET /``,
``POST /tokens`` and ``GET /metrics``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..constants import UserType
from ..utils.service import HttpError, JsonHttpServer, RawResponse
from .admin import Admin

_WRITE_TYPES = {UserType.SUPERADMIN, UserType.ADMIN,
                UserType.MODEL_DEVELOPER, UserType.APP_DEVELOPER}


class AdminApp:
    def __init__(self, admin: Admin, host: str = "127.0.0.1", port: int = 0):
        self.admin = admin
        self._http = JsonHttpServer([
            # rta: disable=RTA702 the dashboard page is fetched by browsers, not by in-tree code
            ("GET", "/", self._dashboard),
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
            # rta: disable=RTA702 operator-only control surface (curl/runbooks); no SDK wrapper yet by design
            ("POST", "/inference_jobs/<job_id>/promote",
             self._promote_trial),
            # rta: disable=RTA702 operator-only profiling trigger (docs/profiling.md runbook), driven by curl
            ("POST", "/inference_jobs/<job_id>/profile",
             self._profile_inference_job),
            ("GET", "/trace/<trace_id>", self._get_trace),
            ("POST", "/datasets", self._create_dataset),
            ("GET", "/datasets", self._list_datasets),
            ("GET", "/services", self._list_services),
            ("GET", "/services/<service_id>/logs", self._service_logs),
            ("GET", "/status", self._status),
            # rta: disable=RTA702 operator surface for the cluster fabric (flag-gated); browsers/curl only
            ("GET", "/nodes", self._nodes),
            ("GET", "/trial_phases", self._trial_phases),
            ("GET", "/autoscale", self._autoscale),
            ("GET", "/slo", self._slo),
            ("GET", "/alerts", self._alerts),
            ("GET", "/capacity", self._capacity),
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

    def _dashboard(self, params, body, ctx):
        from ..web import dashboard_html

        return 200, RawResponse("text/html; charset=utf-8",
                                dashboard_html())

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

    def _create_dataset(self, params, body, ctx):
        claims = self._auth(ctx, *_WRITE_TYPES)
        # The file is the raw body (a browser posts the File, the
        # client streams it); its name and task ride the query string.
        name = ctx.query_one("name")
        task = ctx.query_one("task")
        if not name or not task:
            raise HttpError(400, "need ?name= and ?task= query params")
        if ctx.raw_body is None:
            raise HttpError(
                400, "dataset bytes must be the request body with a "
                     "non-JSON Content-Type (application/octet-stream)")
        return 201, self.admin.create_dataset(
            claims["user_id"], name, task, ctx.raw_body,
            filename=ctx.query_one("filename", ""))

    def _list_datasets(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_datasets(claims["user_id"],
                                            task=ctx.query_one("task"))

    def _list_services(self, params, body, ctx):
        claims = self._auth(ctx)
        return 200, self.admin.get_services(claims=claims)

    def _service_logs(self, params, body, ctx):
        claims = self._auth(ctx)
        max_bytes = int(ctx.query_one("max_bytes", "65536"))
        return 200, self.admin.get_service_logs(params["service_id"],
                                                max_bytes=max_bytes,
                                                claims=claims)

    def _status(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_status()

    def _nodes(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_nodes()

    def _trial_phases(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_trial_phases()

    def _autoscale(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_autoscale()

    def _slo(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_slo()

    def _alerts(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_alerts()

    def _capacity(self, params, body, ctx):
        self._auth(ctx)
        return 200, self.admin.get_capacity()
