"""End-to-end request tracing: trace ids across the HTTP edge, the bus
and the worker.

The port's copy of the part of ``rafiki_tpu/observe/trace.py`` that the
``/predict`` path uses (:108-540, :1076-1248). A trace id is minted (or
taken from an ``X-Trace-Id`` request header) at an HTTP edge, bound to
the handler's thread, captured by the micro-batcher at admission,
carried in the bus frame's ``"_trace"`` envelope at scatter, and
recovered by the inference worker on the far side of the bus.

Spans are flat JSON lines appended to ``<log_dir>/spans.jsonl``
(``configure``). At ``RAFIKI_TPU_TRACE_MAX_MB`` the file rolls to
``spans.jsonl.1`` and older generations shift to ``.2`` .. ``.N``,
bounded by ``RAFIKI_TPU_TRACE_RETAIN_SEGMENTS`` (generations) and
``RAFIKI_TPU_TRACE_RETAIN_MB`` (rolled bytes). ``collect_trace``
stitches one trace from every segment into a timeline, reading each
segment line by line. ``RAFIKI_TPU_TRACE_SAMPLE`` (0..1, default 1)
samples freshly minted traces; a request that arrives with a trace id
is always traced.

Not ported yet: tail sampling and its verdict files, the segments'
sidecar indexes, the scan cache of the active segment, and compaction.
"""

from __future__ import annotations

import json
import os
import random
import re
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional

TRACE_SAMPLE_ENV = "RAFIKI_TPU_TRACE_SAMPLE"
TRACE_MAX_MB_ENV = "RAFIKI_TPU_TRACE_MAX_MB"
TRACE_RETAIN_SEGMENTS_ENV = "RAFIKI_TPU_TRACE_RETAIN_SEGMENTS"
TRACE_RETAIN_MB_ENV = "RAFIKI_TPU_TRACE_RETAIN_MB"
TRACE_HEADER = "X-Trace-Id"

#: Envelope key inside bus frames. A frame without it carries no trace;
#: frame readers key on "queries"/"batch" and ignore it.
ENVELOPE_KEY = "_trace"

#: A super-batch coalesces many requests; the envelope carries at most
#: this many of their contexts (the worker records one span a trace).
MAX_ENVELOPE_TRACES = 32

SPAN_FILE = "spans.jsonl"

_HEADER_RE = re.compile(r"^([0-9a-fA-F]{32})-([0-9a-fA-F]{16})$")


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One request's place in its trace: the trace id and the current
    span id (children parent onto it)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id or new_span_id()
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, parent_id=self.span_id)

    def header_value(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    def __repr__(self):  # pragma: no cover - debug aid
        return f"TraceContext({self.trace_id[:8]}…/{self.span_id})"


# --- Thread-local current context ------------------------------------

_local = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_local, "ctx", None)


class use:
    """``with trace.use(ctx): ...`` binds the thread's current context
    and restores the one before; ``ctx=None`` clears it meanwhile."""

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self):
        self._prior = current()
        _local.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _local.ctx = self._prior
        return False


def sample_rate() -> float:
    raw = os.environ.get(TRACE_SAMPLE_ENV, "").strip()
    if not raw:
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 1.0


def start_trace(header: Optional[str] = None) -> Optional[TraceContext]:
    """The context of one incoming edge request. An ``X-Trace-Id``
    header is always honoured: ``<32 hex>-<16 hex>`` splits into the
    trace and its parent span; any other non-empty value (a dashed
    UUID, an opaque upstream id) is the trace id whole. Otherwise a
    fresh trace is minted at the sample rate (None = sampled out)."""
    if header and header.strip():
        value = header.strip()
        match = _HEADER_RE.match(value)
        if match:
            return TraceContext(match.group(1), parent_id=match.group(2))
        return TraceContext(value)
    rate = sample_rate()
    if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
        return None
    return TraceContext(new_trace_id())


# --- Envelope carry (bus frames) --------------------------------------

def inject(ctxs: Iterable[Optional[TraceContext]]) -> Optional[Dict]:
    """The envelope of a bus frame carrying these requests' traces, or
    None when none is traced (the frame then carries no envelope)."""
    ids = []
    for c in ctxs:
        if c is None:
            continue
        if len(ids) >= MAX_ENVELOPE_TRACES:
            break
        ids.append([c.trace_id, c.span_id])
    if not ids:
        return None
    return {"ids": ids}


def extract(frame: Any) -> List[TraceContext]:
    """Pop the envelope off a bus frame dict. A frame without one, or
    with a malformed one, gives ``[]``: tracing never fails a query.
    The contexts continue the sender's spans (same span id), so a
    consumer's ``record_event(child=True)`` parents onto them."""
    if not isinstance(frame, dict):
        return []
    env = frame.pop(ENVELOPE_KEY, None)
    if not isinstance(env, dict):
        return []
    out = []
    try:
        for tid, sid in env.get("ids", []):
            out.append(TraceContext(str(tid), span_id=str(sid)))
    except (TypeError, ValueError):
        return []
    return out


def extract_frames(frames: Iterable[Any]) -> List[TraceContext]:
    """Extract across a popped burst, one context a trace id (a burst
    may drain several frames of one super-batch)."""
    seen = set()
    out: List[TraceContext] = []
    for frame in frames:
        for ctx in extract(frame):
            if ctx.trace_id not in seen:
                seen.add(ctx.trace_id)
                out.append(ctx)
    return out


# --- Span sink (a rolling JSONL file in the log directory) -------------

_sink_lock = threading.Lock()
_sink_path: Optional[str] = None
_sink_file = None


def span_log_path(log_dir: str) -> str:
    return os.path.join(log_dir, SPAN_FILE)


def configure(log_dir: Optional[str]) -> None:
    """Point this process's span sink at ``<log_dir>/spans.jsonl``
    (appended to; made at the first span). ``None`` or "" turns the
    recording off."""
    global _sink_path, _sink_file
    with _sink_lock:
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
            _sink_file = None
        _sink_path = span_log_path(log_dir) if log_dir else None


def release(log_dir: str) -> None:
    """Turn the sink off if it points into ``log_dir`` (its owner is
    shutting down and the directory may go)."""
    global _sink_file, _sink_path
    with _sink_lock:
        if _sink_path != span_log_path(log_dir):
            return
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
            _sink_file = None
        _sink_path = None


def _max_span_bytes() -> int:
    try:
        return int(float(os.environ.get(TRACE_MAX_MB_ENV, "64"))
                   * 1024 * 1024)
    except ValueError:
        return 64 * 1024 * 1024


def retain_segments() -> int:
    """Rolled generations kept (``.1`` .. ``.N``), 4 by default."""
    try:
        return max(1, int(os.environ.get(TRACE_RETAIN_SEGMENTS_ENV,
                                         "4") or 4))
    except ValueError:
        return 4


def _retain_total_bytes() -> int:
    try:
        return int(float(os.environ.get(TRACE_RETAIN_MB_ENV, "256")
                         or 256) * 1024 * 1024)
    except ValueError:
        return 256 * 1024 * 1024


def _write_lines(lines: List[str]) -> None:
    global _sink_file
    wrote = 0
    with _sink_lock:
        if _sink_path is None:
            return
        try:
            if _sink_file is None or _sink_file.closed:
                os.makedirs(os.path.dirname(_sink_path) or ".",
                            exist_ok=True)
                _sink_file = open(_sink_path, "a", encoding="utf-8")
            _sink_file.write("".join(lines))
            _sink_file.flush()
            wrote = len(lines)
            # Past the size cap the active file rolls into the chain of
            # generations, so a busy node cannot fill the disk.
            if _sink_file.tell() > _max_span_bytes():
                _sink_file.close()
                _sink_file = None
                _roll_segments(_sink_path)
        except OSError:  # the directory vanished: drop the spans
            _sink_file = None
    if wrote:
        from . import metrics

        metrics.registry().counter(
            "rafiki_tpu_trace_spans_total",
            "Span events written to the span log").inc(wrote)


def _roll_segments(path: str) -> None:
    """Shift ``.k`` to ``.k+1`` (the oldest past the bounds deleted)
    and freeze the active file as ``.1``. Caller holds ``_sink_lock``."""
    n = retain_segments()
    try:
        os.remove(f"{path}.{n}")
    except OSError:
        pass
    for k in range(n - 1, 0, -1):
        if os.path.exists(f"{path}.{k}"):
            try:
                os.replace(f"{path}.{k}", f"{path}.{k + 1}")
            except OSError:
                pass
    try:
        os.replace(path, f"{path}.1")
    except OSError:
        return
    # The rolled bytes' budget: drop the oldest generations until the
    # chain fits; the newest always stays.
    budget = _retain_total_bytes()
    sizes = []
    for k in range(1, n + 1):
        try:
            sizes.append((k, os.path.getsize(f"{path}.{k}")))
        except OSError:
            continue
    total = sum(s for _, s in sizes)
    for k, size in sorted(sizes, reverse=True):
        if total <= budget or k == 1:
            break
        try:
            os.remove(f"{path}.{k}")
        except OSError:
            pass
        total -= size
    from . import metrics

    metrics.registry().counter(
        "rafiki_tpu_trace_store_total",
        "Trace span-store events (event=roll|index_build|index_read|"
        "tail_scan|compact)").inc(event="roll")


def record_event(name: str, service: str,
                 ctxs: Iterable[Optional[TraceContext]],
                 start_wall: float, dur_s: float,
                 attrs: Optional[Dict[str, Any]] = None,
                 child: bool = True) -> None:
    """Append one span a traced context. ``child=True`` records a new
    span parented on the context's span; ``child=False`` records the
    context's own span (the HTTP edge, which minted it)."""
    if _sink_path is None:
        return
    lines: List[str] = []
    for ctx in ctxs:
        if ctx is None:
            continue
        span_rec = {
            "trace_id": ctx.trace_id,
            "span_id": new_span_id() if child else ctx.span_id,
            "parent_id": ctx.span_id if child else ctx.parent_id,
            "name": name,
            "service": service,
            "start_s": round(start_wall, 6),
            "dur_ms": round(dur_s * 1e3, 3),
        }
        if attrs:
            span_rec["attrs"] = attrs
        lines.append(json.dumps(span_rec, separators=(",", ":")) + "\n")
    if lines:
        _write_lines(lines)


class span:
    """``with trace.span("worker.predict", service=sid, ctxs=...)``
    times the block and records the span(s) at its exit; nothing when
    no context is traced or no sink is configured."""

    def __init__(self, name: str, service: str = "",
                 ctxs: Optional[Iterable[Optional[TraceContext]]] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 child: bool = True):
        self.name = name
        self.service = service
        self.attrs = attrs
        self.child = child
        self._ctxs = list(ctxs) if ctxs is not None else None

    def __enter__(self):
        if self._ctxs is None:
            cur = current()
            self._ctxs = [cur] if cur is not None else []
        self._wall = time.time()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self._ctxs and _sink_path is not None:
            record_event(self.name, self.service, self._ctxs, self._wall,
                         time.monotonic() - self._t0, attrs=self.attrs,
                         child=self.child)
        return False


# --- Stitching (the admin's GET /trace/<id>) ---------------------------

def segment_paths(log_dir: str) -> List[str]:
    """The segments oldest first: rolled generations ``.N`` .. ``.1``,
    then the active file (those that exist)."""
    path = span_log_path(log_dir)
    out = [f"{path}.{k}"
           for k in range(retain_segments(), 0, -1)
           if os.path.exists(f"{path}.{k}")]
    if os.path.exists(path):
        out.append(path)
    return out


def _trace_id_of_line(line: str) -> Optional[str]:
    """The trace id of a span line without a full JSON parse (ids are
    hex, so the value holds no escapes)."""
    marker = '"trace_id":'
    i = line.find(marker)
    if i < 0:
        return None
    j = i + len(marker)
    while j < len(line) and line[j] in " \t":
        j += 1
    if j >= len(line) or line[j] != '"':
        return None
    k = line.find('"', j + 1)
    if k < 0:
        return None
    return line[j + 1:k]


def collect_trace(log_dir: str, trace_id: str,
                  max_spans: int = 1000) -> Dict[str, Any]:
    """Every span of one trace across the segments, as a timeline
    ordered by start, each with its ``offset_ms`` from the first. Each
    segment is read line by line (``segments`` says how many bytes);
    a torn or corrupt line is skipped."""
    spans: List[Dict[str, Any]] = []
    diags: List[Dict[str, Any]] = []
    for p in segment_paths(log_dir):
        if len(spans) >= max_spans:
            break
        found = 0
        n_bytes = 0
        try:
            with open(p, "rb") as f:
                for raw in f:
                    n_bytes += len(raw)
                    if not raw.endswith(b"\n"):
                        break  # a torn tail write
                    line = raw.decode("utf-8", errors="replace")
                    if _trace_id_of_line(line) != trace_id:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("trace_id") == trace_id:
                        spans.append(rec)
                        found += 1
                        if len(spans) >= max_spans:
                            break
        except OSError:
            continue
        diags.append({"segment": os.path.basename(p), "mode": "scan",
                      "n_spans": found, "bytes_read": n_bytes})
    spans.sort(key=lambda s: (s.get("start_s", 0.0), s.get("name", "")))
    t0 = spans[0].get("start_s", 0.0) if spans else 0.0
    for s in spans:
        s["offset_ms"] = round((s.get("start_s", t0) - t0) * 1e3, 3)
    return {"trace_id": trace_id, "n_spans": len(spans),
            "spans": spans, "segments": diags}
