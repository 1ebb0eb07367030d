"""Client: the admin and predictor REST APIs from Python.

The port's copy of ``Client`` from ``rafiki_tpu/client/client.py``
(:42-259), on the standard library's ``urllib.request``: the reference
uses ``requests``, which the card's machine does not have. The method
surface is the reference's (``login``, ``create_dataset``,
``create_model``, ``create_train_job``, ``create_inference_job``,
``get_service_logs``, ``predict``, ...). ``create_dataset`` streams the
file as the request's raw body. ``predict`` frames numpy queries with
the port's ``encode_payload``.

Retries: a GET is retried after a transport failure (a POST that may
have run is never sent twice); a 429 is retried for any method, after
its ``Retry-After`` (capped), since the server refused it before doing
any work.
"""

from __future__ import annotations

import json
import os
import socket
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional
from urllib.parse import quote

import numpy as np

from ..cache import encode_payload


class ClientError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"[{status}] {message}")
        self.status = status


_RETRIES = 3
_RETRY_BASE_S = 0.2
_RETRY_MAX_SLEEP_S = 2.0
_RETRY_AFTER_CAP_S = 10.0


class Client:
    def __init__(self, admin_host: str = "127.0.0.1", admin_port: int = 3000,
                 timeout: float = 60.0, retries: int = _RETRIES):
        self._base = f"http://{admin_host}:{admin_port}"
        self._timeout = timeout
        self._token: Optional[str] = None
        self._retries = max(0, retries)

    # --- Plumbing ---

    def _send(self, method: str, url: str, body: Optional[Dict[str, Any]],
              headers: Dict[str, str], data: Any = None):
        """One request: ``(status, decoded body, response headers)``; an
        HTTP error status is an answer, not an exception. ``data`` (a
        file, with its Content-Length in ``headers``) is sent as it is
        in place of a JSON ``body``."""
        if body:
            data = json.dumps(body).encode()
            headers = dict(headers, **{"Content-Type": "application/json"})
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                status, raw, hdrs = resp.status, resp.read(), resp.headers
        except urllib.error.HTTPError as e:
            status, raw, hdrs = e.code, e.read(), e.headers
        try:
            payload = json.loads(raw) if raw else {}
        except ValueError:
            payload = {"error": raw.decode(errors="replace")}
        return status, payload, hdrs

    def _call(self, method: str, path: str, base: Optional[str] = None,
              **body: Any) -> Any:
        headers = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        url = (base or self._base) + path
        attempt = 0
        while True:
            try:
                status, data, hdrs = self._send(method, url, body or None,
                                                headers)
            except (urllib.error.URLError, ConnectionError,
                    socket.timeout):
                # Transport failure: only an idempotent GET retries.
                if method.upper() != "GET" or attempt >= self._retries:
                    raise
                attempt += 1
                time.sleep(min(_RETRY_BASE_S * (2 ** (attempt - 1)),
                               _RETRY_MAX_SLEEP_S))
                continue
            if status == 429 and attempt < self._retries:
                attempt += 1
                try:
                    delay = float(hdrs.get("Retry-After", ""))
                except (TypeError, ValueError):
                    delay = _RETRY_BASE_S * (2 ** (attempt - 1))
                time.sleep(min(max(delay, 0.0), _RETRY_AFTER_CAP_S))
                continue
            if status >= 400:
                raise ClientError(status, data.get("error", "unknown error")
                                  if isinstance(data, dict)
                                  else "unknown error")
            return data

    # --- Auth ---

    def login(self, email: str, password: str) -> Dict[str, Any]:
        out = self._call("POST", "/tokens", email=email, password=password)
        self._token = out["token"]
        return out

    def create_user(self, email: str, password: str,
                    user_type: str) -> Dict[str, Any]:
        return self._call("POST", "/users", email=email, password=password,
                          user_type=user_type)

    def get_users(self) -> List[Dict[str, Any]]:
        """Admin-only: users with their type and ban state."""
        return self._call("GET", "/users")

    def ban_user(self, user_id: str) -> Dict[str, Any]:
        """Admin-only: a banned user can no longer authenticate."""
        return self._call("POST", f"/users/{user_id}/ban")

    # --- Models ---

    def create_model(self, name: str, task: str, model_class: str,
                     model_source: Optional[str] = None,
                     model_file_path: Optional[str] = None,
                     dependencies: Optional[Dict[str, str]] = None,
                     access_right: str = "PRIVATE") -> Dict[str, Any]:
        """Register a model: ``model_class`` is ``"module:Class"`` for a
        bundled model, or a bare class name with ``model_source`` (or
        ``model_file_path``) carrying the Python source."""
        if model_file_path is not None:
            with open(model_file_path) as f:
                model_source = f.read()
        return self._call("POST", "/models", name=name, task=task,
                          model_class=model_class, model_source=model_source,
                          dependencies=dependencies,
                          access_right=access_right)

    def get_models(self, task: Optional[str] = None) -> List[Dict[str, Any]]:
        return self._call("GET", "/models" + (f"?task={task}" if task
                                              else ""))

    # --- Datasets ---

    def create_dataset(self, name: str, task: str,
                       file_path: str) -> Dict[str, Any]:
        """Upload a dataset file; the row's ``path`` is what
        ``create_train_job`` takes as a dataset path. Not retried: an
        upload that may have landed is not sent twice."""
        headers = {"Content-Type": "application/octet-stream",
                   "Content-Length": str(os.path.getsize(file_path))}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        url = (f"{self._base}/datasets?name={quote(name)}"
               f"&task={quote(task)}"
               f"&filename={quote(os.path.basename(file_path))}")
        with open(file_path, "rb") as f:
            status, data, _ = self._send("POST", url, None, headers, data=f)
        if status >= 400:
            raise ClientError(status, data.get("error", "unknown error")
                              if isinstance(data, dict) else "unknown error")
        return data

    def get_datasets(self, task: Optional[str] = None,
                     ) -> List[Dict[str, Any]]:
        return self._call("GET", "/datasets" + (f"?task={task}" if task
                                                else ""))

    # --- Services ---

    def get_services(self) -> List[Dict[str, Any]]:
        """Service rows (type, status, chips, node)."""
        return self._call("GET", "/services")

    def get_service_logs(self, service_id: str,
                         max_bytes: int = 65536) -> Dict[str, Any]:
        """The tail of one service's log: ``{"service_id", "status",
        "log", "captured"}``."""
        return self._call(
            "GET", f"/services/{service_id}/logs?max_bytes={max_bytes}")

    def get_status(self) -> Dict[str, Any]:
        """Node status: chips in all and free, running services."""
        return self._call("GET", "/status")

    # --- Train jobs ---

    def create_train_job(self, app: str, task: str, model_ids: List[str],
                         budget: Dict[str, Any], train_dataset_path: str,
                         val_dataset_path: str,
                         advisor_type: Optional[str] = None,
                         ) -> Dict[str, Any]:
        return self._call("POST", "/train_jobs", app=app, task=task,
                          model_ids=model_ids, budget=budget,
                          train_dataset_path=train_dataset_path,
                          val_dataset_path=val_dataset_path,
                          advisor_type=advisor_type)

    def get_train_jobs(self) -> List[Dict[str, Any]]:
        return self._call("GET", "/train_jobs")

    def get_train_job(self, train_job_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/train_jobs/{train_job_id}")

    def stop_train_job(self, train_job_id: str) -> Dict[str, Any]:
        return self._call("POST", f"/train_jobs/{train_job_id}/stop")

    def get_best_trials_of_train_job(self, train_job_id: str,
                                     max_count: int = 2,
                                     ) -> List[Dict[str, Any]]:
        return self._call("GET", f"/train_jobs/{train_job_id}/trials"
                                 f"?type=best&max_count={max_count}")

    def get_trials_of_train_job(self, train_job_id: str,
                                ) -> List[Dict[str, Any]]:
        return self._call("GET", f"/train_jobs/{train_job_id}/trials")

    def get_trial_logs(self, trial_id: str) -> List[Dict[str, Any]]:
        return self._call("GET", f"/trials/{trial_id}/logs")

    def wait_until_train_job_done(self, train_job_id: str,
                                  timeout: float = 3600.0,
                                  poll: float = 2.0) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.get_train_job(train_job_id)
            if job["status"] in ("STOPPED", "ERRORED"):
                return job
            time.sleep(poll)
        raise TimeoutError(f"train job {train_job_id} still running "
                           f"after {timeout}s")

    # --- Inference jobs and prediction ---

    def create_inference_job(self, train_job_id: str,
                             max_models: int = 2) -> Dict[str, Any]:
        return self._call("POST", "/inference_jobs",
                          train_job_id=train_job_id, max_models=max_models)

    def get_inference_jobs(self) -> List[Dict[str, Any]]:
        return self._call("GET", "/inference_jobs")

    def get_inference_job(self, inference_job_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/inference_jobs/{inference_job_id}")

    def stop_inference_job(self, inference_job_id: str) -> Dict[str, Any]:
        return self._call("POST", f"/inference_jobs/{inference_job_id}/stop")

    def predict(self, predictor_host: str, query: Any = None,
                queries: Optional[List[Any]] = None) -> Any:
        """Query a running predictor (``predictor_host`` as
        ``get_inference_job`` gives it). Numpy queries are framed."""
        base = f"http://{predictor_host}"
        if queries is not None:
            return self._call("POST", "/predict", base=base,
                              queries=[encode_payload(q) for q in queries])
        return self._call("POST", "/predict", base=base,
                          query=encode_payload(np.asarray(query)
                                               if isinstance(query,
                                                             np.ndarray)
                                               else query))
