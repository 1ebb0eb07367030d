"""Workload recorder: one JSONL record a request at the predictor edge.

The port's copy of ``rafiki_tpu/observe/workload.py``: the same
records, which the reference's trace-replay capacity engine reads. Each
record holds what the edge knows:

- ``off_s``, the arrival offset from the recorder's first committed
  request, and ``t``, the wall clock, so segments of several processes
  merge;
- ``tenant``, the hashed tenant key (``attribution.tenant_key``, never
  the raw header) or null;
- ``job`` and ``bins``, the inference job and the serving-bin vector
  of the predictor's last plan;
- ``n`` and ``size``, the query count and its power-of-two class;
- ``status`` (200 or 429), ``queue_ms`` (the admission wait, when the
  micro-batcher dispatched the request), ``compute_ms`` (the rest of
  ``dur_ms``), and the backpressure ``reason`` of a 429.

``RAFIKI_TPU_WORKLOAD_RECORD`` (``NodeConfig.workload_record``, off by
default) is read once, at first use: off, each hook is one None check
and no ``rafiki_tpu_workload_*`` series exists. ``LocalPlatform`` points
the sink at ``<workdir>/logs/workload.jsonl``, next to the span log; it
rolls to ``.1`` at ``RAFIKI_TPU_WORKLOAD_MAX_MB``, keeping
``RAFIKI_TPU_WORKLOAD_RETAIN_SEGMENTS`` generations.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

_log = logging.getLogger(__name__)

WORKLOAD_ENV = "RAFIKI_TPU_WORKLOAD_RECORD"
WORKLOAD_MAX_MB_ENV = "RAFIKI_TPU_WORKLOAD_MAX_MB"
WORKLOAD_RETAIN_SEGMENTS_ENV = "RAFIKI_TPU_WORKLOAD_RETAIN_SEGMENTS"

WORKLOAD_FILE = "workload.jsonl"

_lock = threading.Lock()
# None = unresolved; (None,) = resolved off; (_Recorder,) = resolved on.
_state: Optional[tuple] = None
# Sink directory, set by configure() alongside trace.configure — the
# recorder is dormant (records dropped) until both the env gate and a
# log dir are present.
_log_dir: Optional[str] = None


def enabled(raw: Optional[str] = None) -> bool:
    """Truthiness of the workload-record env gate (same spellings as
    the attribution ledger's)."""
    if raw is None:
        raw = os.environ.get(WORKLOAD_ENV, "")
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


def configure(log_dir: Optional[str]) -> None:
    """Point the recorder's sink at ``<log_dir>/workload.jsonl``
    (called next to ``trace.configure`` — resident platform startup and
    the subprocess service entrypoint). ``None``/"" parks the sink."""
    global _log_dir
    with _lock:
        rec = _state[0] if _state is not None else None
        _log_dir = log_dir or None
        if rec is not None:
            rec.repoint(_log_dir)


def configured() -> bool:
    # rta: disable=RTA101 lock-free liveness probe; a reference read is GIL-atomic
    return _log_dir is not None


def _max_bytes() -> int:
    try:
        return int(float(os.environ.get(WORKLOAD_MAX_MB_ENV, "64")
                         or 64) * 1024 * 1024)
    except ValueError:
        return 64 * 1024 * 1024


def retain_segments() -> int:
    try:
        return max(1, int(os.environ.get(WORKLOAD_RETAIN_SEGMENTS_ENV,
                                         "4") or 4))
    except ValueError:
        return 4


class _Recorder:
    """The resolved-on state: sink handle + the request counter family.
    All methods are best-effort — recording must never fail a serve."""

    def __init__(self, log_dir: Optional[str]):
        self._sink_lock = threading.Lock()
        self._path = (os.path.join(log_dir, WORKLOAD_FILE)
                      if log_dir else None)
        self._file = None
        # Offset epoch: the wall clock of the first committed request.
        # Replay treats off_s as the arrival timeline, so one process's
        # segment is self-consistent even across sink rolls.
        self._t0: Optional[float] = None
        self._m_requests = None
        from . import metrics as _metrics

        if _metrics.metrics_enabled():
            self._m_requests = _metrics.registry().counter(
                "rafiki_tpu_workload_requests_total",
                "Requests captured by the workload recorder "
                "(status=ok|backpressure|error)")

    def repoint(self, log_dir: Optional[str]) -> None:
        with self._sink_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
            self._path = (os.path.join(log_dir, WORKLOAD_FILE)
                          if log_dir else None)

    def commit(self, req: Dict[str, Any], status: int, dur_s: float,
               reason: str = "", bins: Optional[Iterable] = None,
               ) -> None:
        wall = time.time()
        if self._t0 is None:
            self._t0 = wall
        n = int(req.get("n", 1) or 1)
        queue_ms = float(req.get("queue_ms", 0.0) or 0.0)
        dur_ms = dur_s * 1e3
        record = {
            "off_s": round(max(0.0, wall - self._t0), 6),
            "t": round(wall, 3),
            "job": req.get("job", ""),
            "tenant": req.get("tenant"),
            "n": n,
            "size": size_class(n),
            "queue_ms": round(queue_ms, 3),
            "compute_ms": round(max(0.0, dur_ms - queue_ms), 3),
            "dur_ms": round(dur_ms, 3),
            "status": int(status),
        }
        if reason:
            record["reason"] = str(reason)[:40]
        if bins:
            record["bins"] = sorted(str(b)[:12] for b in bins)
        self._write(json.dumps(record, separators=(",", ":")) + "\n")
        if self._m_requests is not None:
            label = ("ok" if status == 200 else
                     "backpressure" if status == 429 else "error")
            self._m_requests.inc(status=label)

    def _write(self, line: str) -> None:
        with self._sink_lock:
            if self._path is None:
                return
            try:
                if self._file is None or self._file.closed:
                    os.makedirs(os.path.dirname(self._path) or ".",
                                exist_ok=True)
                    # rta: disable=RTA102 the sink lock guards the handle itself; the lazy open is the bind it serializes (trace._write_lines idiom)
                    self._file = open(self._path, "a", encoding="utf-8")
                self._file.write(line)
                self._file.flush()
                # Append mode: tell() is the file size (the span
                # store's size-cap pattern, trace._write_lines).
                if self._file.tell() > _max_bytes():
                    self._file.close()
                    self._file = None
                    _roll_segments(self._path)
            except OSError:  # sink dir vanished (teardown); drop
                self._file = None

    def close(self) -> None:
        with self._sink_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
        if self._m_requests is not None:
            self._m_requests.remove()


def _roll_segments(path: str) -> None:
    """Shift the generation chain (``.k`` → ``.k+1``; the one that
    would pass the count bound is deleted) and freeze the active file
    as ``.1`` — the span store's roll, minus the sidecar index."""
    n = retain_segments()
    try:
        os.remove(f"{path}.{n}")
    except OSError:
        pass
    for k in range(n - 1, 0, -1):
        src = f"{path}.{k}"
        if os.path.exists(src):
            try:
                os.replace(src, f"{path}.{k + 1}")
            except OSError:
                pass
    try:
        os.replace(path, f"{path}.1")
    except OSError:
        pass


def _recorder() -> Optional[_Recorder]:
    """Resolve the env gate ONCE (attribution's ``_families`` shape):
    the off path after resolution is a tuple-load and a None check."""
    global _state
    # rta: disable=RTA101 double-checked init: the bare read is the fast path; the write re-checks under _lock
    s = _state
    if s is None:
        with _lock:
            if _state is None:
                _state = ((_Recorder(_log_dir),) if enabled()
                          else (None,))
            s = _state
    return s[0]


def active() -> bool:
    """One cheap check for hook sites (and their construction-time
    snapshots): is the recorder on?"""
    return _recorder() is not None


def size_class(n: int) -> int:
    """Power-of-two size class of a query count (1, 2, 4, 8, ...) —
    the coarse request-size vocabulary replay bins arrivals by."""
    return 1 << max(0, math.ceil(math.log2(max(1, int(n)))))


def open_request(job: str, tenant: Optional[str],
                 n: int) -> Optional[Dict[str, Any]]:
    """Start one request's record at the edge, or None when the
    recorder is off. The returned dict rides down the dispatch path so
    the micro-batcher can annotate the admission wait (``queue_ms``)
    before :func:`commit` seals the line."""
    rec = _recorder()
    if rec is None:
        return None
    return {"job": str(job)[:12], "tenant": tenant, "n": int(n)}


def note_queue_wait(req: Optional[Dict[str, Any]],
                    wait_s: float) -> None:
    """Micro-batcher annotation: this request's admission wait. A plain
    dict store — the batcher thread writes strictly before the edge
    thread's commit (results only return after dispatch)."""
    if req is not None:
        req["queue_ms"] = round(max(0.0, wait_s) * 1e3, 3)


def commit(req: Optional[Dict[str, Any]], status: int, dur_s: float,
           reason: str = "", bins: Optional[Iterable] = None) -> None:
    """Seal and write one request's record (no-op for ``req=None``,
    the off path)."""
    if req is None:
        return
    rec = _recorder()
    if rec is not None:
        rec.commit(req, status, dur_s, reason=reason, bins=bins)


# --- Readers (replay / capacity CLI) ----------------------------------

def workload_path(log_dir: str) -> str:
    return os.path.join(log_dir, WORKLOAD_FILE)


def segment_paths(log_dir: str) -> List[str]:
    """Store segments oldest-first (rolled ``.N`` .. ``.1``, then the
    active file) — the span store's reader order."""
    path = workload_path(log_dir)
    out = [f"{path}.{k}"
           for k in range(retain_segments(), 0, -1)
           if os.path.exists(f"{path}.{k}")]
    if os.path.exists(path):
        out.append(path)
    return out


def read_segment(path: str) -> List[Dict[str, Any]]:
    """One segment's records, in file order; torn/corrupt lines are
    skipped, never fatal."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "rb") as f:
            for raw in f:
                if not raw.endswith(b"\n"):
                    break  # torn tail write
                try:
                    rec = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "off_s" in rec:
                    out.append(rec)
    except OSError:
        return out
    return out


def load(source: str) -> List[Dict[str, Any]]:
    """A recorded workload trace as one arrival-ordered list.
    ``source`` is either a single trace file or a log dir holding the
    segmented store. Offsets are re-based onto one timeline via the
    absolute ``t`` stamps (segments from different processes / rolls
    each carry their own ``off_s`` epoch)."""
    paths = ([source] if os.path.isfile(source)
             else segment_paths(source))
    records: List[Dict[str, Any]] = []
    for p in paths:
        records.extend(read_segment(p))
    if not records:
        return []
    t0 = min(r.get("t", 0.0) for r in records)
    for r in records:
        r["off_s"] = round(max(0.0, r.get("t", t0) - t0), 6)
    records.sort(key=lambda r: (r["off_s"], r.get("tenant") or ""))
    return records


def reset_for_tests() -> None:
    """Drop the resolved gate (and its series/handle) so a test can
    flip the env and re-resolve — the attribution seam."""
    global _state, _log_dir
    with _lock:
        rec = _state[0] if _state is not None else None
        _state = None
        _log_dir = None
    if rec is not None:
        rec.close()
