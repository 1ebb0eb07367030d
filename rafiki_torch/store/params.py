"""ParamStore: trial parameters in safetensors files with a sqlite
index.

The port's copy of ``rafiki_tpu/store/params.py`` (:67-314) with the
same API: ``save``, ``load``, ``get_in_memory``, ``retrieve`` under the
four ``ParamsType`` sharing policies (LOCAL/GLOBAL × RECENT/BEST),
``session_params_ids``, ``delete``, ``flush``, ``exists`` and ``close``.
One params dict is one ``.safetensors`` file, written by
:mod:`.tensorfile` (the card's machine has no ``safetensors``
package); the file format and the index schema are the reference's, so
a file written by either package loads in the other.

**Write-behind** (ref :15-47, :114-204). ``save`` takes trees whose
leaves are still tensors, on the card or on the CPU (the counterpart of
the reference's ``jax.Array``, which a CPU array is too), and the
image zoo's ``TorchModel.dump_parameters`` gives such trees, as
``JaxModel.dump_parameters`` gives device arrays: every image-zoo trial
takes this path in both packages. The tree goes into ``_pending`` and a
daemon writer thread, started on the first such save, pulls it to the
host (``parallel.transfer.device_get_tree``: one readback a (device,
dtype) group), writes the file and then inserts the index row, so a
reader on a shared volume that sees the row finds the file. In the
process, ``retrieve``, ``exists`` and ``session_params_ids`` see a
pending save at once, and ``retrieve`` hands its in-memory tree to the
next trial, which copies it into its own net (``bridge.overlay_params``
never shares storage). ``load`` waits for the flush and reads the file.
A ``delete`` racing the writer leaves neither file nor row: the writer
re-checks ``_pending`` under the lock after the flush and removes its
own file when the save went meanwhile. ``close`` drains.
``RAFIKI_TPU_PARAMS_WRITE_BEHIND=0`` (``NodeConfig.params_write_behind``)
makes saves synchronous; the files are byte for byte the same.

The card: the caller's tree must be a snapshot (the dump copies on the
device, so a later in-place step cannot reach it). ``save`` records an
event on the caller's current stream of each card the tree lies on,
which must order after the dump's copies (the runner dumps and saves on
each card's default stream, inline or on its persist thread); the
writer's pull runs on a stream of its own that waits for those events,
never for the legacy default stream, and it never calls
``torch.cuda.synchronize``. The pull holds ``torchenv``'s capture lock,
so it cannot fall into, or break, another thread's CUDA-graph capture.
A pending save holds one copy of the trial's parameters on the device
until it is flushed.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import sqlite3
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import ParamsType
from ..model.base import Params
from .tensorfile import load_file, save_file

_log = logging.getLogger(__name__)

WRITE_BEHIND_ENV = "RAFIKI_TPU_PARAMS_WRITE_BEHIND"


class ParamStore:
    def __init__(self, params_dir: str):
        self.params_dir = params_dir
        os.makedirs(params_dir, exist_ok=True)
        # Write-behind state: params_id -> (tree, flushed event, index
        # row). The writer thread starts on the first deferred save and
        # inserts the index row after the file lands. ``_ready`` holds
        # the events a pending save's pull waits for (under the pending
        # lock); the writer drops them after the flush.
        self._pending: Dict[str, Tuple[Params, threading.Event,
                                       tuple]] = {}
        self._ready: Dict[str, list] = {}
        self._pending_lock = threading.Lock()
        self._write_queue: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
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
        with self._pending_lock:  # _writer is published under it
            writer = self._writer
        if writer is not None and writer.is_alive():
            self.flush()
            self._write_queue.put(None)  # the writer loop's sentinel
            writer.join(timeout=10.0)
        with self._lock:
            self._db.close()

    def _path(self, params_id: str) -> str:
        return os.path.join(self.params_dir, f"{params_id}.safetensors")

    # --- Save / load by id ---

    def save(self, params: Params, *, session_id: str = "",
             worker_id: str = "", score: float = 0.0) -> str:
        """Persist one trial's parameters; returns the params_id.

        A tree with tensor leaves is flushed by the writer thread
        (module docstring) and this call returns without a
        device-to-host copy; a tree of host arrays, or any tree with
        the switch off, is written before it returns."""
        params_id = uuid.uuid4().hex
        row = (params_id, session_id, worker_id, float(score), time.time())
        async_ok = os.environ.get(WRITE_BEHIND_ENV, "1") != "0"
        if async_ok and self._has_device_leaves(params):
            event = threading.Event()
            ready = self._record_ready(params)
            with self._pending_lock:
                self._pending[params_id] = (dict(params), event, row)
                self._ready[params_id] = ready
                if self._writer is None or not self._writer.is_alive():
                    self._writer = threading.Thread(
                        target=self._writer_loop, name="params-writer",
                        daemon=True)
                    self._writer.start()
            self._write_queue.put(params_id)
        else:
            self._flush_to_disk(params_id, params)
            self._insert_row(row)
        return params_id

    def _insert_row(self, row: tuple) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO params (id, session_id, worker_id, score, "
                "created_at) VALUES (?, ?, ?, ?, ?)", row)
            self._db.commit()

    @staticmethod
    def _has_device_leaves(params: Params) -> bool:
        return any(isinstance(v, torch.Tensor) for v in params.values())

    @staticmethod
    def _record_ready(params: Params
                      ) -> List[Tuple[torch.device, torch.cuda.Event]]:
        """An event on the caller's current stream of each card the
        tree's tensors lie on: the writer's pull waits for these, so it
        reads what the caller's queued copies wrote."""
        cards = {v.device for v in params.values()
                 if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
        ready = []
        for dev in cards:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ready.append((dev, ev))
        return ready

    def _flush_to_disk(self, params_id: str, params: Params) -> None:
        from ..parallel.transfer import device_get_tree
        from ..torchenv import capture_exclusive

        with self._pending_lock:
            ready = self._ready.get(params_id, ())
        tree = dict(params)
        if ready:
            # The pull on a stream of its own a card, each waiting for
            # the caller's event there, under the capture lock.
            with capture_exclusive(), contextlib.ExitStack() as stack:
                for dev, ev in ready:
                    stream = torch.cuda.Stream(dev)
                    stream.wait_event(ev)
                    stack.enter_context(torch.cuda.stream(stream))
                host = device_get_tree(tree)
        else:
            host = device_get_tree(tree)
        flat = {k: np.ascontiguousarray(np.asarray(v))
                for k, v in host.items()}
        save_file(flat, self._path(params_id))

    def _writer_loop(self) -> None:
        while True:
            params_id = self._write_queue.get()
            if params_id is None:  # close()'s sentinel
                return
            with self._pending_lock:
                entry = self._pending.get(params_id)
            if entry is None:  # deleted before its flush
                with self._pending_lock:
                    self._ready.pop(params_id, None)
                continue
            tree, event, row = entry
            flushed = False
            try:
                self._flush_to_disk(params_id, tree)
                flushed = True
            except Exception:  # disk full and the like
                _log.exception("write-behind flush failed for %s",
                               params_id)
            # File, then row, atomically against delete(): under the
            # pending lock, a delete either ran before (no entry: the
            # file just written is ours to remove) or runs after (it
            # finds the row and the file, and removes both).
            deleted_mid_flight = False
            with self._pending_lock:
                if params_id in self._pending:
                    if flushed:
                        self._insert_row(row)
                else:
                    deleted_mid_flight = True
            if deleted_mid_flight and flushed:
                try:
                    os.remove(self._path(params_id))
                except FileNotFoundError:
                    pass
            event.set()
            with self._pending_lock:
                self._pending.pop(params_id, None)
                self._ready.pop(params_id, None)

    def flush(self, timeout: float = 120.0) -> None:
        """Block until every pending write-behind save is on disk."""
        with self._pending_lock:
            events = [entry[1] for entry in self._pending.values()]
        for e in events:
            e.wait(timeout)

    def load(self, params_id: str) -> Params:
        """The durable read: waits out a pending flush, then reads the
        file (host numpy: serving workers and readers in other processes
        rely on it)."""
        with self._pending_lock:
            entry = self._pending.get(params_id)
        if entry is not None:
            entry[1].wait(timeout=120.0)
        return load_file(self._path(params_id))

    def get_in_memory(self, params_id: str) -> Optional[Params]:
        """The in-memory tree of a save not yet flushed (it may hold
        tensors on the card), or None once flushed or unknown."""
        with self._pending_lock:
            entry = self._pending.get(params_id)
        return dict(entry[0]) if entry is not None else None

    def exists(self, params_id: str) -> bool:
        with self._pending_lock:
            if params_id in self._pending:
                return True
        return os.path.exists(self._path(params_id))

    def delete(self, params_id: str) -> None:
        with self._pending_lock:
            self._pending.pop(params_id, None)
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
        the session's saves, or of this worker's (LOCAL), pending saves
        ranked with the indexed ones. A pending winner comes from
        memory; an indexed one from its file. None when the policy is
        NONE or nothing is saved: the trial then starts cold."""
        if params_type == ParamsType.NONE:
            return None
        local = params_type in (ParamsType.LOCAL_RECENT, ParamsType.LOCAL_BEST)
        best = params_type in (ParamsType.LOCAL_BEST, ParamsType.GLOBAL_BEST)
        sql = ("SELECT id, score, created_at FROM params "
               "WHERE session_id = ?")
        args = [session_id]
        if local:
            sql += " AND worker_id = ?"
            args.append(worker_id)
        sql += " ORDER BY " + ("score DESC, created_at DESC"
                               if best else "created_at DESC")
        sql += " LIMIT 1"
        with self._lock:
            row = self._db.execute(sql, tuple(args)).fetchone()
        # Pending saves have no row yet: the policy compares the index's
        # winner with the matching pending saves.
        candidates = [tuple(row)] if row is not None else []
        with self._pending_lock:
            for pid, (_, _, prow) in self._pending.items():
                if prow[1] == session_id and \
                        (not local or prow[2] == worker_id):
                    candidates.append((pid, prow[3], prow[4]))
        if not candidates:
            return None
        rank = (lambda c: (c[1], c[2])) if best else (lambda c: c[2])
        winner = max(candidates, key=rank)[0]
        mem = self.get_in_memory(winner)
        if mem is not None:
            return mem
        try:
            return self.load(winner)
        except FileNotFoundError:
            # Indexed but removed: absence, not an error.
            return None

    def session_params_ids(self, session_id: str) -> list:
        """The session's params ids in the order they were saved,
        pending saves included."""
        with self._lock:
            rows = self._db.execute(
                "SELECT id, created_at FROM params WHERE session_id = ? "
                "ORDER BY created_at", (session_id,)).fetchall()
        entries = [(r[1], r[0]) for r in rows]
        indexed = {pid for _, pid in entries}
        with self._pending_lock:
            entries.extend(
                (prow[4], pid) for pid, (_, _, prow)
                in self._pending.items()
                if prow[1] == session_id and pid not in indexed)
        return [pid for _, pid in sorted(entries)]
