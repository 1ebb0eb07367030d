"""Per-service log files.

The port's copy of what ``container/services.py`` ``main`` and the
workers need of ``rafiki_tpu/utils/service_logs.py``: a service's log
is ``<log_dir>/<service_id>.log``. A service that is a thread binds
itself to its file (``bind_service_log``) and a handler on the
package's logger routes each record of that thread there; a service
that is a process of its own takes every thread's records with a plain
file handler on the root logger (``attach_process_log``). The admin's
``GET /services/<id>/logs`` route reads a file's tail (``tail_log``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

_local = threading.local()
_install_lock = threading.Lock()
_installed = False

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


class _ServiceLogHandler(logging.Handler):
    """Writes a record to the file its emitting thread is bound to."""

    def emit(self, record: logging.LogRecord) -> None:
        f = getattr(_local, "file", None)
        if f is None:
            return
        try:
            f.write(self.format(record) + "\n")
            f.flush()
        except Exception:
            self.handleError(record)


def _install() -> None:
    """Attach the routing handler once a process, on the package's
    logger. The package's level goes to INFO only when it is unset (the
    handler would take nothing at the default WARNING); the records
    still propagate to the process's own handlers."""
    global _installed
    with _install_lock:
        if _installed:
            return
        pkg = logging.getLogger("rafiki_torch")
        if pkg.level == logging.NOTSET:
            pkg.setLevel(logging.INFO)
        handler = _ServiceLogHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        pkg.addHandler(handler)
        _installed = True


def service_log_path(log_dir: str, service_id: str) -> str:
    return os.path.join(log_dir, f"{service_id}.log")


def bind_service_log(log_path: Optional[str]) -> None:
    """Send the calling thread's records to ``log_path``, appended (a
    restarted service goes on with its history). ``None`` does nothing,
    so a worker calls it whether or not it was given a file."""
    if not log_path:
        return
    _install()
    prior = getattr(_local, "file", None)
    if prior is not None:
        try:
            prior.close()
        except OSError:
            pass
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    _local.file = open(log_path, "a", encoding="utf-8")


def attach_process_log(log_path: Optional[str]) -> None:
    """A service process's variant: the whole process is the service,
    so a file handler on the root logger takes every thread's records."""
    if not log_path:
        return
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    handler = logging.FileHandler(log_path)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger()
    if root.level == logging.NOTSET or root.level > logging.INFO:
        root.setLevel(logging.INFO)
    root.addHandler(handler)


def tail_log(log_path: str, max_bytes: int = 65536) -> Optional[str]:
    """The last ``max_bytes`` of a service's log, from the first whole
    line in them; None when the service never wrote one (or runs on a
    node whose files this one cannot see)."""
    try:
        size = os.path.getsize(log_path)
        with open(log_path, "r", encoding="utf-8", errors="replace") as f:
            if size > max_bytes:
                f.seek(size - max_bytes)
                f.readline()  # the partial first line
            return f.read()
    except OSError:
        return None
