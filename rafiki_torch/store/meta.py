"""MetaStore: the AutoML loop's durable state on stdlib sqlite3.

The port's copy of ``rafiki_tpu/store/meta.py``: users, models,
uploaded datasets, train jobs, sub-train jobs, trials, trial logs,
inference jobs, services and the job-to-service mappings the admin and
its services manager read and write. The schema of those tables and the
row dicts are the reference's, so either package reads a database the
other wrote. The reference's warning about a database on a network
filesystem waits with its node registry.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

Row = Dict[str, Any]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id TEXT PRIMARY KEY,
    email TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL,
    user_type TEXT NOT NULL,
    banned_at REAL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS models (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL,
    name TEXT NOT NULL,
    task TEXT NOT NULL,
    model_source TEXT,
    model_class TEXT NOT NULL,
    knob_config TEXT NOT NULL,
    dependencies TEXT,
    access_right TEXT NOT NULL,
    created_at REAL NOT NULL,
    UNIQUE (user_id, name)
);
CREATE TABLE IF NOT EXISTS train_jobs (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL,
    app TEXT NOT NULL,
    app_version INTEGER NOT NULL,
    task TEXT NOT NULL,
    budget TEXT NOT NULL,
    train_dataset_path TEXT NOT NULL,
    val_dataset_path TEXT NOT NULL,
    status TEXT NOT NULL,
    created_at REAL NOT NULL,
    stopped_at REAL,
    UNIQUE (user_id, app, app_version)
);
CREATE TABLE IF NOT EXISTS sub_train_jobs (
    id TEXT PRIMARY KEY,
    train_job_id TEXT NOT NULL,
    model_id TEXT NOT NULL,
    status TEXT NOT NULL,
    advisor_type TEXT,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS trials (
    id TEXT PRIMARY KEY,
    no INTEGER NOT NULL,
    sub_train_job_id TEXT NOT NULL,
    model_id TEXT NOT NULL,
    worker_id TEXT,
    status TEXT NOT NULL,
    knobs TEXT,
    score REAL,
    params_id TEXT,
    proposal TEXT,
    error TEXT,
    started_at REAL,
    finished_at REAL
);
CREATE INDEX IF NOT EXISTS idx_trials_sub ON trials (sub_train_job_id);
CREATE TABLE IF NOT EXISTS trial_logs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id TEXT NOT NULL,
    ts REAL NOT NULL,
    record TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_trial_logs_trial ON trial_logs (trial_id);
CREATE TABLE IF NOT EXISTS inference_jobs (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL,
    train_job_id TEXT NOT NULL,
    status TEXT NOT NULL,
    predictor_host TEXT,
    created_at REAL NOT NULL,
    stopped_at REAL
);
CREATE TABLE IF NOT EXISTS services (
    id TEXT PRIMARY KEY,
    service_type TEXT NOT NULL,
    status TEXT NOT NULL,
    container_id TEXT,
    chips TEXT,
    host TEXT,
    port INTEGER,
    node_id TEXT,
    heartbeat_at REAL,
    created_at REAL NOT NULL,
    stopped_at REAL
);
CREATE TABLE IF NOT EXISTS datasets (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL,
    name TEXT NOT NULL,
    task TEXT NOT NULL,
    path TEXT NOT NULL,
    size_bytes INTEGER NOT NULL,
    created_at REAL NOT NULL,
    UNIQUE (user_id, name)
);
CREATE TABLE IF NOT EXISTS train_job_workers (
    service_id TEXT PRIMARY KEY,
    sub_train_job_id TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS inference_job_workers (
    service_id TEXT PRIMARY KEY,
    inference_job_id TEXT NOT NULL,
    trial_id TEXT NOT NULL
);
"""

_JSON_COLS = {"budget", "knobs", "proposal", "knob_config", "chips",
              "dependencies", "record"}

#: Service statuses that count as alive.
_ACTIVE = ("STARTED", "DEPLOYING", "RUNNING")


def _now() -> float:
    return time.time()


def _new_id() -> str:
    return uuid.uuid4().hex


class MetaStore:
    """Thread-safe sqlite3-backed metadata store.

    ``uri`` is a filesystem path, or ``":memory:"`` for tests. One
    connection guarded by an RLock; cross-process safety comes from
    sqlite itself (each process opens its own MetaStore on the shared
    file).
    """

    def __init__(self, uri: str = ":memory:"):
        self.uri = uri
        if uri != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(uri)) or ".",
                        exist_ok=True)
        self._conn = sqlite3.connect(uri, check_same_thread=False,
                                     timeout=30.0)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            if uri != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA busy_timeout=30000")
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # --- internal helpers ---

    def _insert(self, table: str, row: Row) -> Row:
        cols = list(row)
        vals = [json.dumps(row[c]) if c in _JSON_COLS and row[c] is not None
                else row[c] for c in cols]
        sql = (f"INSERT INTO {table} ({', '.join(cols)}) "
               f"VALUES ({', '.join('?' * len(cols))})")
        with self._lock:
            self._conn.execute(sql, vals)
            self._conn.commit()
        return row

    def _update(self, table: str, id_: str, **fields: Any) -> None:
        cols = list(fields)
        vals = [json.dumps(fields[c]) if c in _JSON_COLS and fields[c] is not None
                else fields[c] for c in cols]
        sql = (f"UPDATE {table} SET {', '.join(c + ' = ?' for c in cols)} "
               f"WHERE id = ?")
        with self._lock:
            self._conn.execute(sql, vals + [id_])
            self._conn.commit()

    def _select(self, sql: str, args: tuple = ()) -> List[Row]:
        with self._lock:
            rows = self._conn.execute(sql, args).fetchall()
        out = []
        for r in rows:
            d = dict(r)
            for c in _JSON_COLS:
                if c in d and isinstance(d[c], str):
                    d[c] = json.loads(d[c])
            out.append(d)
        return out

    def _one(self, sql: str, args: tuple = ()) -> Optional[Row]:
        rows = self._select(sql, args)
        return rows[0] if rows else None

    # --- Users ---

    def create_user(self, email: str, password_hash: str,
                    user_type: str) -> Row:
        return self._insert("users", {
            "id": _new_id(), "email": email, "password_hash": password_hash,
            "user_type": user_type, "banned_at": None, "created_at": _now()})

    def get_user_by_email(self, email: str) -> Optional[Row]:
        return self._one("SELECT * FROM users WHERE email = ?", (email,))

    def get_user(self, user_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM users WHERE id = ?", (user_id,))

    def get_users(self) -> List[Row]:
        return self._select("SELECT * FROM users ORDER BY created_at")

    def ban_user(self, user_id: str) -> None:
        self._update("users", user_id, banned_at=_now())

    # --- Models ---

    def create_model(self, user_id: str, name: str, task: str,
                     model_class: str, knob_config: Dict[str, Any],
                     model_source: Optional[str] = None,
                     dependencies: Optional[Dict[str, str]] = None,
                     access_right: str = "PRIVATE") -> Row:
        return self._insert("models", {
            "id": _new_id(), "user_id": user_id, "name": name, "task": task,
            "model_source": model_source, "model_class": model_class,
            "knob_config": knob_config, "dependencies": dependencies,
            "access_right": access_right, "created_at": _now()})

    def get_model(self, model_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM models WHERE id = ?", (model_id,))

    def get_model_by_name(self, user_id: str, name: str) -> Optional[Row]:
        return self._one(
            "SELECT * FROM models WHERE name = ? AND (user_id = ? "
            "OR access_right = 'PUBLIC') ORDER BY user_id = ? DESC",
            (name, user_id, user_id))

    def get_models(self, user_id: Optional[str] = None,
                   task: Optional[str] = None) -> List[Row]:
        sql = ("SELECT * FROM models WHERE (user_id = ? "
               "OR access_right = 'PUBLIC')")
        args: list = [user_id]
        if task is not None:
            sql += " AND task = ?"
            args.append(task)
        return self._select(sql + " ORDER BY created_at", tuple(args))

    # --- Datasets ---

    def create_dataset(self, user_id: str, name: str, task: str,
                       path: str, size_bytes: int) -> Row:
        """Raises ``sqlite3.IntegrityError`` when the user already has a
        dataset of that name."""
        return self._insert("datasets", {
            "id": _new_id(), "user_id": user_id, "name": name,
            "task": task, "path": path, "size_bytes": int(size_bytes),
            "created_at": _now()})

    def get_dataset(self, dataset_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM datasets WHERE id = ?",
                         (dataset_id,))

    def get_datasets(self, user_id: str,
                     task: Optional[str] = None) -> List[Row]:
        sql = "SELECT * FROM datasets WHERE user_id = ?"
        args: list = [user_id]
        if task is not None:
            sql += " AND task = ?"
            args.append(task)
        return self._select(sql + " ORDER BY created_at", tuple(args))

    # --- Train jobs ---

    def create_train_job(self, user_id: str, app: str, task: str,
                         budget: Dict[str, Any], train_dataset_path: str,
                         val_dataset_path: str, status: str) -> Row:
        prev = self._one(
            "SELECT MAX(app_version) AS v FROM train_jobs "
            "WHERE user_id = ? AND app = ?", (user_id, app))
        version = int(prev["v"] or 0) + 1 if prev else 1
        return self._insert("train_jobs", {
            "id": _new_id(), "user_id": user_id, "app": app,
            "app_version": version, "task": task, "budget": budget,
            "train_dataset_path": train_dataset_path,
            "val_dataset_path": val_dataset_path, "status": status,
            "created_at": _now(), "stopped_at": None})

    def get_train_job(self, train_job_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM train_jobs WHERE id = ?",
                         (train_job_id,))

    def get_train_job_by_app(self, user_id: str, app: str,
                             app_version: int = -1) -> Optional[Row]:
        """The user's train job of ``app``: its latest version when
        ``app_version`` is -1, else that version."""
        if app_version == -1:
            return self._one(
                "SELECT * FROM train_jobs WHERE user_id = ? AND app = ? "
                "ORDER BY app_version DESC", (user_id, app))
        return self._one(
            "SELECT * FROM train_jobs WHERE user_id = ? AND app = ? "
            "AND app_version = ?", (user_id, app, app_version))

    def get_train_jobs(self, user_id: Optional[str] = None,
                       status: Optional[str] = None) -> List[Row]:
        sql, args = "SELECT * FROM train_jobs WHERE 1=1", []
        if user_id is not None:
            sql += " AND user_id = ?"
            args.append(user_id)
        if status is not None:
            sql += " AND status = ?"
            args.append(status)
        return self._select(sql + " ORDER BY created_at", tuple(args))

    def update_train_job(self, train_job_id: str, **fields: Any) -> None:
        self._update("train_jobs", train_job_id, **fields)

    # --- Sub train jobs ---

    def create_sub_train_job(self, train_job_id: str, model_id: str,
                             status: str,
                             advisor_type: Optional[str] = None) -> Row:
        return self._insert("sub_train_jobs", {
            "id": _new_id(), "train_job_id": train_job_id,
            "model_id": model_id, "status": status,
            "advisor_type": advisor_type, "created_at": _now()})

    def get_sub_train_job(self, sub_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM sub_train_jobs WHERE id = ?",
                         (sub_id,))

    def get_sub_train_jobs(self, train_job_id: str) -> List[Row]:
        return self._select(
            "SELECT * FROM sub_train_jobs WHERE train_job_id = ? "
            "ORDER BY created_at", (train_job_id,))

    def update_sub_train_job(self, sub_id: str, **fields: Any) -> None:
        self._update("sub_train_jobs", sub_id, **fields)

    # --- Trials ---

    def create_trial(self, sub_train_job_id: str, model_id: str, no: int,
                     status: str, worker_id: Optional[str] = None,
                     knobs: Optional[Dict[str, Any]] = None,
                     proposal: Optional[Dict[str, Any]] = None) -> Row:
        return self._insert("trials", {
            "id": _new_id(), "no": no, "sub_train_job_id": sub_train_job_id,
            "model_id": model_id, "worker_id": worker_id, "status": status,
            "knobs": knobs, "score": None, "params_id": None,
            "proposal": proposal, "error": None, "started_at": _now(),
            "finished_at": None})

    def get_trial(self, trial_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM trials WHERE id = ?", (trial_id,))

    def get_trials(self, sub_train_job_id: str,
                   status: Optional[str] = None) -> List[Row]:
        sql = "SELECT * FROM trials WHERE sub_train_job_id = ?"
        args: list = [sub_train_job_id]
        if status is not None:
            sql += " AND status = ?"
            args.append(status)
        return self._select(sql + " ORDER BY no", tuple(args))

    def get_trials_of_train_job(self, train_job_id: str,
                                status: Optional[str] = None) -> List[Row]:
        sql = ("SELECT t.* FROM trials t JOIN sub_train_jobs s "
               "ON t.sub_train_job_id = s.id WHERE s.train_job_id = ?")
        args: list = [train_job_id]
        if status is not None:
            sql += " AND t.status = ?"
            args.append(status)
        return self._select(sql + " ORDER BY t.no", tuple(args))

    def get_best_trials_of_train_job(self, train_job_id: str,
                                     max_count: int = 2) -> List[Row]:
        return self._select(
            "SELECT t.* FROM trials t JOIN sub_train_jobs s "
            "ON t.sub_train_job_id = s.id WHERE s.train_job_id = ? "
            "AND t.status = 'COMPLETED' AND t.score IS NOT NULL "
            "ORDER BY t.score DESC LIMIT ?", (train_job_id, max_count))

    def update_trial(self, trial_id: str, **fields: Any) -> None:
        self._update("trials", trial_id, **fields)

    def mark_trial_completed(self, trial_id: str, score: float,
                             params_id: Optional[str]) -> None:
        self.update_trial(trial_id, status="COMPLETED", score=score,
                          params_id=params_id, finished_at=_now())

    def mark_trial_errored(self, trial_id: str, error: str) -> None:
        self.update_trial(trial_id, status="ERRORED", error=error,
                          finished_at=_now())

    # --- Trial logs ---

    def add_trial_log(self, trial_id: str, record: Dict[str, Any],
                      ts: Optional[float] = None) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO trial_logs (trial_id, ts, record) "
                "VALUES (?, ?, ?)",
                (trial_id, ts if ts is not None else _now(),
                 json.dumps(record)))
            self._conn.commit()

    def get_trial_logs(self, trial_id: str) -> List[Row]:
        return self._select(
            "SELECT * FROM trial_logs WHERE trial_id = ? ORDER BY id",
            (trial_id,))

    # --- Inference jobs ---

    def create_inference_job(self, user_id: str, train_job_id: str,
                             status: str) -> Row:
        return self._insert("inference_jobs", {
            "id": _new_id(), "user_id": user_id,
            "train_job_id": train_job_id, "status": status,
            "predictor_host": None, "created_at": _now(),
            "stopped_at": None})

    def get_inference_job(self, job_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM inference_jobs WHERE id = ?",
                         (job_id,))

    def get_inference_job_by_train_job(self, train_job_id: str
                                       ) -> Optional[Row]:
        """The newest inference job of ``train_job_id``."""
        return self._one(
            "SELECT * FROM inference_jobs WHERE train_job_id = ? "
            "ORDER BY created_at DESC", (train_job_id,))

    def get_inference_jobs(self, user_id: Optional[str] = None,
                           status: Optional[str] = None) -> List[Row]:
        sql, args = "SELECT * FROM inference_jobs WHERE 1=1", []
        if user_id is not None:
            sql += " AND user_id = ?"
            args.append(user_id)
        if status is not None:
            sql += " AND status = ?"
            args.append(status)
        return self._select(sql + " ORDER BY created_at", tuple(args))

    def update_inference_job(self, job_id: str, **fields: Any) -> None:
        self._update("inference_jobs", job_id, **fields)

    # --- Services and the job-to-service mappings ---

    def create_service(self, service_type: str, status: str,
                       container_id: Optional[str] = None,
                       chips: Optional[List[int]] = None,
                       host: Optional[str] = None,
                       port: Optional[int] = None,
                       node_id: Optional[str] = None) -> Row:
        return self._insert("services", {
            "id": _new_id(), "service_type": service_type, "status": status,
            "container_id": container_id, "chips": chips, "host": host,
            "port": port, "node_id": node_id, "heartbeat_at": _now(),
            "created_at": _now(), "stopped_at": None})

    def get_service(self, service_id: str) -> Optional[Row]:
        return self._one("SELECT * FROM services WHERE id = ?",
                         (service_id,))

    def get_services(self, status: Optional[str] = None,
                     node_id: Optional[str] = None) -> List[Row]:
        """``node_id`` scopes to one node's services."""
        clauses, args = [], []
        if status is not None:
            clauses.append("status = ?")
            args.append(status)
        if node_id is not None:
            clauses.append("node_id = ?")
            args.append(node_id)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        return self._select(
            f"SELECT * FROM services{where} ORDER BY created_at",
            tuple(args))

    def update_service(self, service_id: str, **fields: Any) -> None:
        self._update("services", service_id, **fields)

    def touch_node_services(self, node_id: str) -> None:
        """Refresh the liveness lease (``heartbeat_at``) of a node's
        active services."""
        with self._lock:
            self._conn.execute(
                f"UPDATE services SET heartbeat_at = ? WHERE node_id = ? "
                f"AND status IN ({', '.join('?' * len(_ACTIVE))})",
                (_now(), node_id, *_ACTIVE))
            self._conn.commit()

    def add_train_job_worker(self, service_id: str,
                             sub_train_job_id: str) -> None:
        self._insert("train_job_workers", {
            "service_id": service_id, "sub_train_job_id": sub_train_job_id})

    def get_train_job_workers(self, sub_train_job_id: str) -> List[Row]:
        return self._select(
            "SELECT * FROM train_job_workers WHERE sub_train_job_id = ?",
            (sub_train_job_id,))

    def get_train_job_worker(self, service_id: str) -> Optional[Row]:
        return self._one(
            "SELECT * FROM train_job_workers WHERE service_id = ?",
            (service_id,))

    def add_inference_job_worker(self, service_id: str,
                                 inference_job_id: str,
                                 trial_id: str) -> None:
        self._insert("inference_job_workers", {
            "service_id": service_id, "inference_job_id": inference_job_id,
            "trial_id": trial_id})

    def update_inference_job_worker(self, service_id: str,
                                    trial_id: str) -> None:
        """Point one worker's mapping row at a new trial bin: a restack
        swaps a stacked worker's member in place, and the promote
        checks read the served bins from these rows."""
        with self._lock:
            self._conn.execute(
                "UPDATE inference_job_workers SET trial_id = ? "
                "WHERE service_id = ?", (trial_id, service_id))
            self._conn.commit()

    def get_inference_job_workers(self, inference_job_id: str) -> List[Row]:
        return self._select(
            "SELECT * FROM inference_job_workers WHERE inference_job_id = ?",
            (inference_job_id,))

    def get_inference_job_worker(self, service_id: str) -> Optional[Row]:
        return self._one(
            "SELECT * FROM inference_job_workers WHERE service_id = ?",
            (service_id,))

    def get_service_owner(self, service_id: str) -> Optional[str]:
        """The user whose job a service works for, or None for a
        service no job maps (the service-log route's owner check)."""
        row = self._one(
            "SELECT tj.user_id AS user_id FROM train_job_workers w "
            "JOIN sub_train_jobs s ON s.id = w.sub_train_job_id "
            "JOIN train_jobs tj ON tj.id = s.train_job_id "
            "WHERE w.service_id = ?", (service_id,))
        if row is None:
            row = self._one(
                "SELECT ij.user_id AS user_id FROM inference_job_workers w "
                "JOIN inference_jobs ij ON ij.id = w.inference_job_id "
                "WHERE w.service_id = ?", (service_id,))
        return row["user_id"] if row else None

    def get_owned_service_ids(self, user_id: str) -> set:
        """Every service id working for a job owned by ``user_id``."""
        rows = self._select(
            "SELECT w.service_id AS sid FROM train_job_workers w "
            "JOIN sub_train_jobs s ON s.id = w.sub_train_job_id "
            "JOIN train_jobs tj ON tj.id = s.train_job_id "
            "WHERE tj.user_id = ? "
            "UNION "
            "SELECT w.service_id FROM inference_job_workers w "
            "JOIN inference_jobs ij ON ij.id = w.inference_job_id "
            "WHERE ij.user_id = ?", (user_id, user_id))
        return {r["sid"] for r in rows}
