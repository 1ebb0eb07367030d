"""ParamStore: trial parameters in safetensors files with a sqlite
index.

The port's copy of ``rafiki_tpu/store/params.py`` (:67-314) with the
same API: ``save``, ``load``, ``retrieve`` under the four ``ParamsType``
sharing policies (LOCAL/GLOBAL × RECENT/BEST), ``delete``, ``flush`` and
``exists``. One params dict is one
``.safetensors`` file, written by :mod:`.tensorfile` (the card's machine
has no ``safetensors`` package); the file format and the index schema
are the reference's, so a file written by either package loads in the
other. The index row is inserted after the file is on disk (file, then
row), so a reader that sees the row finds the file.

Saves are synchronous. The reference defers a save to a write-behind
thread only when a leaf is still a device array (``_has_device_leaves``,
:149); ``TorchModel.dump_parameters`` returns host numpy, so the
reference would write it synchronously too, and the writer thread is
not needed.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
import uuid
from typing import Optional

import numpy as np

from ..constants import ParamsType
from ..model.base import Params
from .tensorfile import load_file, save_file


class ParamStore:
    def __init__(self, params_dir: str):
        self.params_dir = params_dir
        os.makedirs(params_dir, exist_ok=True)
        self._db = sqlite3.connect(os.path.join(params_dir, "index.db"),
                                   check_same_thread=False, timeout=30.0)
        self._lock = threading.RLock()
        with self._lock:
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA busy_timeout=30000")
            self._db.execute("""
                CREATE TABLE IF NOT EXISTS params (
                    id TEXT PRIMARY KEY,
                    session_id TEXT NOT NULL,
                    worker_id TEXT NOT NULL,
                    score REAL NOT NULL,
                    created_at REAL NOT NULL
                )""")
            self._db.execute(
                "CREATE INDEX IF NOT EXISTS idx_params_session "
                "ON params (session_id)")
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()

    def _path(self, params_id: str) -> str:
        return os.path.join(self.params_dir, f"{params_id}.safetensors")

    # --- Save / load by id ---

    def save(self, params: Params, *, session_id: str = "",
             worker_id: str = "", score: float = 0.0) -> str:
        """Persist one trial's parameters (host arrays); returns the
        params_id."""
        params_id = uuid.uuid4().hex
        save_file({k: np.asarray(v) for k, v in params.items()},
                  self._path(params_id))
        with self._lock:
            self._db.execute(
                "INSERT INTO params (id, session_id, worker_id, score, "
                "created_at) VALUES (?, ?, ?, ?, ?)",
                (params_id, session_id, worker_id, float(score),
                 time.time()))
            self._db.commit()
        return params_id

    def flush(self, timeout: float = 120.0) -> None:
        """Every save is already on disk when ``save`` returns."""

    def load(self, params_id: str) -> Params:
        return load_file(self._path(params_id))

    def exists(self, params_id: str) -> bool:
        return os.path.exists(self._path(params_id))

    def delete(self, params_id: str) -> None:
        with self._lock:
            self._db.execute("DELETE FROM params WHERE id = ?", (params_id,))
            self._db.commit()
        try:
            os.remove(self._path(params_id))
        except FileNotFoundError:
            pass

    # --- Sharing policies (ParamsType) ---

    def retrieve(self, params_type: str, *, session_id: str,
                 worker_id: str = "") -> Optional[Params]:
        """Fetch shared params per the proposal's sharing policy: the
        most recent, or the best scored (ties to the most recent), of
        the session's saves, or of this worker's (LOCAL). None when the
        policy is NONE or nothing is saved: the trial then starts
        cold."""
        if params_type == ParamsType.NONE:
            return None
        local = params_type in (ParamsType.LOCAL_RECENT, ParamsType.LOCAL_BEST)
        best = params_type in (ParamsType.LOCAL_BEST, ParamsType.GLOBAL_BEST)
        sql = "SELECT id FROM params WHERE session_id = ?"
        args = [session_id]
        if local:
            sql += " AND worker_id = ?"
            args.append(worker_id)
        sql += " ORDER BY " + ("score DESC, created_at DESC"
                               if best else "created_at DESC")
        sql += " LIMIT 1"
        with self._lock:
            row = self._db.execute(sql, tuple(args)).fetchone()
        if row is None:
            return None
        try:
            return self.load(row[0])
        except FileNotFoundError:
            # Indexed but removed: absence, not an error.
            return None
