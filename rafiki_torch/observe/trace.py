"""End-to-end request tracing: trace ids across the HTTP edge, the bus
and the worker.

The port's copy of ``rafiki_tpu/observe/trace.py``. A trace id is
minted (or taken from an ``X-Trace-Id`` request header) at an HTTP
edge, bound to the handler's thread, captured by the micro-batcher at
admission, carried in the bus frame's ``"_trace"`` envelope at scatter,
and recovered by the inference worker on the far side of the bus.

Spans are flat JSON lines appended to a segmented store under the log
directory (``configure``): the active segment is ``spans.jsonl``; at
``RAFIKI_TPU_TRACE_MAX_MB`` it rolls to ``spans.jsonl.1`` and older
generations shift to ``.2`` .. ``.N``, bounded by
``RAFIKI_TPU_TRACE_RETAIN_SEGMENTS`` (generations) and
``RAFIKI_TPU_TRACE_RETAIN_MB`` (rolled bytes). Each frozen segment gets
a sidecar index (``<segment>.idx``: trace id -> byte offsets, with the
segment's size so a stale index reads as missing), built once when the
segment rolls, so ``collect_trace`` (``GET /trace/<id>``) seeks and
reads the lines of one trace in a frozen segment; the active segment is
read through an in-process scan cache that reads only the bytes
appended since the last lookup and starts over when the file's inode
changes (another writer rolled it).

Sampling, two stages:

- **Head** (``RAFIKI_TPU_TRACE_SAMPLE``, 0..1, default 1) samples
  freshly minted traces; a request that arrives with a trace id is
  always traced.
- **Tail** (``RAFIKI_TPU_TRACE_TAIL_SAMPLE`` below 1 turns it on): the
  spans of a freshly minted trace are held in memory until the minting
  edge calls ``complete`` with the request's outcome. Errors and
  requests slower than ``RAFIKI_TPU_TRACE_TAIL_SLOW_MS`` (250 by
  default) are kept; the others are kept at the tail rate. Each verdict
  is one line of ``trace_verdicts.jsonl`` beside the spans, so a
  consumer that holds spans of a trace minted elsewhere (the envelope's
  ``tail`` marks) writes or drops them by it, and keeps them when no
  verdict comes within the hold (retain on doubt). When a segment rolls
  under tail sampling, one older frozen segment is compacted: the lines
  of dropped traces are removed and its index rebuilt.
  ``rafiki_tpu_trace_tail_total{verdict=}`` counts the verdicts.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Tuple

_log = logging.getLogger(__name__)

TRACE_SAMPLE_ENV = "RAFIKI_TPU_TRACE_SAMPLE"
TRACE_MAX_MB_ENV = "RAFIKI_TPU_TRACE_MAX_MB"
TRACE_RETAIN_SEGMENTS_ENV = "RAFIKI_TPU_TRACE_RETAIN_SEGMENTS"
TRACE_RETAIN_MB_ENV = "RAFIKI_TPU_TRACE_RETAIN_MB"
TRACE_TAIL_SAMPLE_ENV = "RAFIKI_TPU_TRACE_TAIL_SAMPLE"
TRACE_TAIL_SLOW_MS_ENV = "RAFIKI_TPU_TRACE_TAIL_SLOW_MS"
TRACE_HEADER = "X-Trace-Id"

#: Envelope key inside bus message frames. Absent on old frames (the
#: backward-compatible fallback: extract() returns no contexts) and
#: ignored by old consumers (frame readers key on "query"/"queries").
ENVELOPE_KEY = "_trace"

#: A super-batch coalesces many requests; the envelope carries at most
#: this many of their contexts (the worker records one span event per
#: carried trace).
MAX_ENVELOPE_TRACES = 32

SPAN_FILE = "spans.jsonl"
INDEX_SUFFIX = ".idx"
#: Tail-verdict sidecar (shared log dir, O_APPEND like the span file):
#: the minting edge appends one ``{"t": trace_id, "v": kept|dropped}``
#: line per completed tail trace, so OTHER processes (subprocess
#: workers) can honor the verdict instead of writing orphan spans.
VERDICT_FILE = "trace_verdicts.jsonl"

#: Remote tail hold: spans of a tail-pending trace minted in ANOTHER
#: process are buffered this long waiting for its verdict line; no
#: verdict by then = retained (retain-on-doubt, never silently drop).
_REMOTE_HOLD_S = 5.0
_REMOTE_MAX_TRACES = 512
#: Verdict map memory bound (FIFO): verdicts only matter for the hold
#: window, so old entries age out.
_VERDICT_REMEMBER = 8192
_VERDICT_MAX_BYTES = 4 * 1024 * 1024

#: Tail-sampling buffer bounds: a pending trace whose edge never
#: completes (crashed handler, client that holds the socket forever)
#: must not grow memory without bound — overflowing traces/spans are
#: flushed to the store (retain-on-doubt, never silently dropped).
_PENDING_MAX_TRACES = 512
_PENDING_MAX_SPANS = 200
#: Recently-dropped trace ids remembered so a straggler span arriving
#: after the tail verdict (a late worker reply) doesn't resurrect a
#: dropped trace as orphan lines.
_DROPPED_REMEMBER = 1024


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One request's position in its trace: the trace id plus the
    CURRENT span id (children parent onto it). ``tail=True`` marks a
    context whose retention verdict is deferred to edge completion
    (set only on the minting edge, under tail sampling)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "tail")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_id: Optional[str] = None, tail: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id or new_span_id()
        self.parent_id = parent_id
        self.tail = tail

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, parent_id=self.span_id,
                            tail=self.tail)

    def header_value(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    def __repr__(self):  # pragma: no cover - debug aid
        return f"TraceContext({self.trace_id[:8]}…/{self.span_id})"


# --- Thread-local current context ------------------------------------

_local = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_local, "ctx", None)


class use:
    """``with trace.use(ctx): ...`` — bind/restore the thread's current
    context. ``ctx=None`` clears for the duration."""

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


def tail_sample_rate() -> Optional[float]:
    """The tail-sampling keep rate for fast/ok traces, or None when
    tail sampling is off (unset / 1.0 / unparseable — fail toward the
    legacy keep-everything behavior)."""
    raw = os.environ.get(TRACE_TAIL_SAMPLE_ENV, "").strip()
    if not raw:
        return None
    try:
        rate = float(raw)
    except ValueError:
        return None
    if rate >= 1.0:
        return None
    return max(0.0, rate)


def tail_slow_ms() -> float:
    try:
        return max(0.0, float(os.environ.get(TRACE_TAIL_SLOW_MS_ENV,
                                             "250") or 250))
    except ValueError:
        return 250.0


_HEADER_RE = None


def start_trace(header: Optional[str] = None) -> Optional[TraceContext]:
    """Context for one incoming edge request. An ``X-Trace-Id`` header
    is always honored: our own ``<32hex>-<16hex>`` format splits into
    trace + parent span; ANY other non-empty value (a dashed UUID, an
    opaque upstream id) is taken whole as the trace id — splitting at
    a dash would silently truncate standard ``str(uuid4())`` ids.
    Honored traces are never tail-buffered (the caller already decided
    to retain). Otherwise a fresh trace is minted subject to the head
    sample rate (None = sampled out); under tail sampling the fresh
    trace is registered PENDING — its spans buffer until
    :func:`complete` delivers the outcome verdict."""
    global _HEADER_RE
    if header and header.strip():
        import re

        if _HEADER_RE is None:
            _HEADER_RE = re.compile(
                r"^([0-9a-fA-F]{32})-([0-9a-fA-F]{16})$")
        value = header.strip()
        match = _HEADER_RE.match(value)
        if match:
            return TraceContext(match.group(1),
                                parent_id=match.group(2))
        return TraceContext(value)
    rate = sample_rate()
    if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
        return None
    ctx = TraceContext(new_trace_id())
    # rta: disable=RTA101 benign racy read of the sink pointer (GIL-atomic reference); worst case one sample misses tail registration
    if tail_sample_rate() is not None and _sink_path is not None:
        ctx.tail = True
        _tail_register(ctx.trace_id)
    return ctx


# --- Envelope carry (bus frames) --------------------------------------

def inject(ctxs: Iterable[Optional[TraceContext]]) -> Optional[Dict]:
    """Envelope field for a bus frame carrying these requests' traces,
    or None when nothing is traced (the frame then looks exactly like
    an old frame). Tail-pending contexts are marked by INDEX in a
    separate ``tail`` key — old consumers read only ``ids`` (changing
    the id pair shape would break their unpack and degrade every
    trace), new ones buffer those traces' spans until the edge's
    verdict arrives (see the module docstring)."""
    ids = []
    tail = []
    for c in ctxs:
        if c is None:
            continue
        if len(ids) >= MAX_ENVELOPE_TRACES:
            break
        if c.tail:
            tail.append(len(ids))
        ids.append([c.trace_id, c.span_id])
    if not ids:
        return None
    env: Dict[str, Any] = {"ids": ids}
    if tail:
        env["tail"] = tail
    return env


def extract(frame: Any) -> List[TraceContext]:
    """Pop the trace envelope off a bus frame dict. Old frames (no
    ``_trace`` key) and malformed envelopes return ``[]`` — tracing
    must never fail a query.

    The returned contexts CONTINUE the propagated spans (same span id),
    so a consumer's ``record_event(child=True)`` parents its span onto
    the span that sent the frame."""
    if not isinstance(frame, dict):
        return []
    env = frame.pop(ENVELOPE_KEY, None)
    if not isinstance(env, dict):
        return []
    out = []
    try:
        for tid, sid in env.get("ids", []):
            out.append(TraceContext(str(tid), span_id=str(sid)))
        for i in env.get("tail") or ():
            # The tail marks survive the bus hop so a consumer in
            # ANOTHER process can hold these traces' spans for the
            # edge's retain/drop verdict instead of writing orphans.
            if isinstance(i, int) and 0 <= i < len(out):
                out[i].tail = True
    except (TypeError, ValueError):
        return []
    return out


def extract_frames(frames: Iterable[Any]) -> List[TraceContext]:
    """Extract across a popped burst, deduplicated by trace id (a
    worker burst may drain several frames of one super-batch)."""
    seen = set()
    out: List[TraceContext] = []
    for frame in frames:
        for ctx in extract(frame):
            if ctx.trace_id not in seen:
                seen.add(ctx.trace_id)
                out.append(ctx)
    return out


# --- Span sink (segmented JSONL store through the service log dir) ----

_sink_lock = threading.Lock()
_sink_path: Optional[str] = None
_sink_file = None

# Tail-sampling state: pending (buffered) trace ids -> span lines, an
# insertion-ordered dict so overflow flushes the OLDEST pending trace;
# recently dropped ids suppress straggler spans.
_tail_lock = threading.Lock()
_tail_pending: "Dict[str, List[str]]" = {}
_tail_dropped: "Dict[str, None]" = {}
_tail_rng = random.Random()

# Cross-process tail verdicts: spans of tail-pending traces minted in
# ANOTHER process (the bus envelope's tail marks) hold here —
# ``tid -> [deadline, [lines]]``, insertion-ordered — until the
# minting edge's verdict line lands in the verdict sidecar, the hold
# expires (retain-on-doubt), or the buffer overflows (flush, never
# drop). The verdict map is the sidecar's incremental read, bounded
# FIFO.
_remote_pending: "Dict[str, List[Any]]" = {}
_verdict_sink = None              # this process's verdict appender
_verdict_reader: List[Any] = [0, None]   # [bytes read, file identity]
_verdicts: "Dict[str, str]" = {}

# Incremental scan cache for the ACTIVE segment: path -> [bytes
# scanned, {trace_id: [line offsets]}]. Lookups only ever read the
# tail appended since the previous lookup.
_active_lock = threading.Lock()
_active_cache: Dict[str, List[Any]] = {}


def span_log_path(log_dir: str) -> str:
    return os.path.join(log_dir, SPAN_FILE)


def configure(log_dir: Optional[str]) -> None:
    """Point this process's span sink at ``<log_dir>/spans.jsonl``
    (append; created on first span). ``None``/"" disables recording.
    Resident-runner mode configures once per platform; subprocess
    services configure from their ``RAFIKI_TPU_LOG_DIR`` env. Any
    tail-pending buffers are flushed to the OLD sink first (retained:
    reconfiguring must not silently eat buffered spans)."""
    global _sink_path, _sink_file, _verdict_sink
    _tail_flush_all()
    flush_remote_tail()
    with _sink_lock:
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
            _sink_file = None
        if _verdict_sink is not None:
            try:
                _verdict_sink.close()
            except OSError:
                pass
            _verdict_sink = None
        _sink_path = span_log_path(log_dir) if log_dir else None
    with _tail_lock:
        _verdict_reader[:] = [0, None]
        _verdicts.clear()


def release(log_dir: str) -> None:
    """Turn the sink off if it points into ``log_dir`` (its owner is
    shutting down and the directory may go). Held tail spans are
    written first: a release keeps what a verdict has not dropped."""
    global _sink_file, _sink_path, _verdict_sink
    with _sink_lock:
        if _sink_path != span_log_path(log_dir):
            return
    _tail_flush_all()
    flush_remote_tail()
    with _sink_lock:
        if _sink_path != span_log_path(log_dir):
            return
        for f in (_sink_file, _verdict_sink):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        _sink_file = None
        _verdict_sink = None
        _sink_path = None
    with _tail_lock:
        _verdict_reader[:] = [0, None]
        _verdicts.clear()


def configured() -> bool:
    # rta: disable=RTA101 lock-free liveness probe; a reference read is GIL-atomic
    return _sink_path is not None


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


def _store_counter():
    from . import metrics

    return metrics.registry().counter(
        "rafiki_tpu_trace_store_total",
        "Trace span-store events (event=roll|index_build|index_read|"
        "tail_scan|compact)")


def _write_lines(lines: List[str]) -> None:
    global _sink_file
    wrote = 0
    rolled: Optional[str] = None
    with _sink_lock:
        if _sink_path is None:
            return
        try:
            if _sink_file is None or _sink_file.closed:
                os.makedirs(os.path.dirname(_sink_path) or ".",
                            exist_ok=True)
                # rta: disable=RTA105 the sink lock guards the handle itself; the lazy open IS the bind it serializes (once per roll)
                _sink_file = open(_sink_path, "a", encoding="utf-8")
            _sink_file.write("".join(lines))
            _sink_file.flush()
            wrote = len(lines)
            # Size cap (RAFIKI_TPU_TRACE_MAX_MB, default 64): roll the
            # active segment into the retained generation chain so a
            # busy node (or a client that always sends X-Trace-Id,
            # bypassing sampling) cannot fill the disk while multi-day
            # lookback stays possible. Append mode means tell() is the
            # file size; a concurrent multi-process rotation race is
            # benign — the atomic replaces at worst drop some spans of
            # one generation.
            if _sink_file.tell() > _max_span_bytes():
                _sink_file.close()
                _sink_file = None
                rolled = _roll_segments(_sink_path)
        except OSError:  # sink dir vanished (test teardown); drop spans
            _sink_file = None
    if rolled is not None:
        # The sidecar index scans the whole frozen segment — done
        # OUTSIDE the sink lock, or every in-flight handler's span
        # write (and tail flush) would stall behind a multi-MB read at
        # each roll. The segment is frozen, so nothing races the scan;
        # a reader arriving before the .idx lands just rebuilds it
        # lazily (the _load_index fallback).
        try:
            _build_index(rolled)
        except OSError:
            pass
        if tail_sample_rate() is not None:
            # Idle-time compaction (rolls are rare): rewrite ONE older
            # frozen segment to only-retained traces — orphan spans of
            # tail-dropped traces (eager pre-verdict writers, overflow
            # flushes) stop surviving on disk. The two NEWEST
            # generations are skipped: .1 because its traces' verdicts
            # may still be pending, and .2 because a co-writing
            # PROCESS whose append handle chased the renames may still
            # be flushing its last burst into it — compaction swaps
            # the inode (os.replace of a rewrite), and replacing a
            # segment a laggard writer still holds open would turn the
            # documented drop-a-few-spans rotation race into losing
            # every span that writer appends until its own next roll.
            # By the time a generation shifts to .3 every writer has
            # re-rolled (frozen segments sit above the size cap, so a
            # stale handle's very next write triggers its reopen).
            try:
                base = rolled[:-2]  # "<dir>/spans.jsonl.1" -> base
                compact_segments(os.path.dirname(rolled), limit=1,
                                 exclude={rolled, base + ".2"})
            except OSError:
                pass
    if wrote:
        # Counted at WRITE time (outside the sink lock), so a tail-
        # buffered span only counts once its trace's verdict actually
        # lands it in the store: the count is of spans that exist, not
        # of spans that were considered.
        from . import metrics

        metrics.registry().counter(
            "rafiki_tpu_trace_spans_total",
            "Span events written to the span log").inc(wrote)


def _roll_segments(path: str) -> Optional[str]:
    """Shift the generation chain (``.k`` -> ``.k+1``, oldest beyond
    the retention bounds deleted) and freeze the active file as
    ``.1``; returns the frozen segment's path so the CALLER can build
    its sidecar index outside the sink lock (None when the freeze
    itself failed). Caller holds ``_sink_lock``."""
    n = retain_segments()
    # Drop the generation that would shift past the count bound.
    for stale in (f"{path}.{n}", f"{path}.{n}{INDEX_SUFFIX}"):
        try:
            os.remove(stale)
        except OSError:
            pass
    for k in range(n - 1, 0, -1):
        for suffix in (INDEX_SUFFIX, ""):
            src = f"{path}.{k}{suffix}"
            if os.path.exists(src):
                try:
                    os.replace(src, f"{path}.{k + 1}{suffix}")
                except OSError:
                    pass
    try:
        os.replace(path, f"{path}.1")
    except OSError:
        return None
    with _active_lock:
        _active_cache.pop(path, None)  # the active file restarted
    # Total-bytes retention: delete oldest generations until the rolled
    # chain fits the byte budget (the newest generation always stays —
    # a budget below one segment must not erase the roll entirely).
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
        for stale in (f"{path}.{k}", f"{path}.{k}{INDEX_SUFFIX}"):
            try:
                os.remove(stale)
            except OSError:
                pass
        total -= size
    try:
        _store_counter().inc(event="roll")
    except Exception:  # metrics must never fail the span sink
        pass
    return f"{path}.1"


def _trace_id_of_line(line: str) -> Optional[str]:
    """Cheap trace-id extraction without a full JSON parse. Tolerates
    whitespace after the key separator (lines written by other tools /
    older versions with default ``json.dumps`` spacing); trace ids are
    hex, so the value can never contain escapes."""
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


def _scan_offsets(path: str, start: int = 0,
                  ) -> Tuple[Dict[str, List[int]], int]:
    """``{trace_id: [byte offsets]}`` for every span line from byte
    ``start`` to EOF, plus the byte position scanned to."""
    offsets: Dict[str, List[int]] = {}
    with open(path, "rb") as f:
        f.seek(start)
        pos = start
        for raw in f:
            if raw.endswith(b"\n"):
                tid = _trace_id_of_line(
                    raw.decode("utf-8", errors="replace"))
                if tid:
                    offsets.setdefault(tid, []).append(pos)
                pos += len(raw)
            else:
                break  # torn tail write; re-scan it next lookup
    return offsets, pos


def index_path(segment_path: str) -> str:
    return segment_path + INDEX_SUFFIX


def _write_index(segment_path: str, offsets: Dict[str, List[int]],
                 compacted: bool) -> None:
    """Persist one sidecar index atomically (tmp + replace) so a
    concurrent reader never loads a torn index. The segment's byte
    size is recorded so a reader can detect a STALE index: compaction
    replaces segment then index as two separate atomic steps, and
    offsets loaded against the wrong generation must read as
    missing-index (rebuild), never seek misaligned."""
    tmp = index_path(segment_path) + ".tmp"
    try:
        size = os.path.getsize(segment_path)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"v": 1, "compacted": compacted, "size": size,
                       "traces": offsets}, f, separators=(",", ":"))
        os.replace(tmp, index_path(segment_path))
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _build_index(segment_path: str,
                 compacted: bool = False) -> Dict[str, List[int]]:
    """Scan one FROZEN segment once and persist its sidecar index
    (``{trace_id: [offsets]}`` + the ``compacted`` marker)."""
    offsets, _pos = _scan_offsets(segment_path)
    _write_index(segment_path, offsets, compacted)
    try:
        _store_counter().inc(event="index_build")
    except Exception:
        pass
    return offsets


def _load_index_data(segment_path: str) -> Optional[Dict[str, Any]]:
    """The sidecar index as written (traces + compacted marker), or
    None when missing/torn — or STALE: an index whose recorded size
    disagrees with the segment on disk belongs to another generation
    of the file (a compaction replaced the segment but not yet the
    index, or vice versa); its offsets must not be seeked."""
    try:
        with open(index_path(segment_path), encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(data, dict) or \
            not isinstance(data.get("traces"), dict):
        return None
    size = data.get("size")
    if size is not None:
        try:
            if os.path.getsize(segment_path) != size:
                return None
        except OSError:
            return None
    return data


def segment_compacted(segment_path: str) -> bool:
    data = _load_index_data(segment_path)
    return bool(data and data.get("compacted"))


def _dropped_verdict_ids() -> set:
    """Every trace id the verdict sidecar (active + rolled generation)
    records as dropped — what compaction removes. A later 'kept' line
    for the same id wins (a re-used header id must never be erased)."""
    path = _verdict_path()
    out: Dict[str, str] = {}
    if path is None:
        return set()
    for p in (path + ".1", path):
        try:
            with open(p, "rb") as f:
                for raw in f:
                    if not raw.endswith(b"\n"):
                        break
                    try:
                        rec = json.loads(raw)
                    except json.JSONDecodeError:
                        continue
                    tid, v = rec.get("t"), rec.get("v")
                    if isinstance(tid, str) and v in ("kept",
                                                      "dropped"):
                        out[tid] = v
        except OSError:
            continue
    return {tid for tid, v in out.items() if v == "dropped"}


def compact_segment(segment_path: str,
                    dropped: Optional[set] = None) -> Dict[str, Any]:
    """Rewrite ONE frozen segment to only-retained traces: lines whose
    trace id carries a ``dropped`` tail verdict (orphan spans written
    eagerly by other processes, or flushed on buffer overflow before
    the verdict landed) are removed, everything else — including
    verdict-less lines — survives. The sidecar index is rebuilt from
    the new content and replaced atomically WITH its ``compacted``
    marker; the segment replace itself is atomic too (tmp + replace),
    so a concurrent reader sees either the old segment or the new one,
    never a torn file. The segment+index PAIR is not atomic — two
    replaces — but each index records its segment's byte size, so a
    reader that catches the window loads a size-mismatched index,
    treats it as missing, and rebuilds from the file it actually has
    instead of seeking stale offsets."""
    if dropped is None:
        dropped = _dropped_verdict_ids()
    kept_lines: List[bytes] = []
    offsets: Dict[str, List[int]] = {}
    removed = 0
    pos = 0
    with open(segment_path, "rb") as f:
        for raw in f:
            if not raw.endswith(b"\n"):
                break  # torn tail (shouldn't exist on a frozen file)
            tid = _trace_id_of_line(
                raw.decode("utf-8", errors="replace"))
            if tid and tid in dropped:
                removed += 1
                continue
            if tid:
                offsets.setdefault(tid, []).append(pos)
            kept_lines.append(raw)
            pos += len(raw)
    tmp = segment_path + ".compact.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(kept_lines))
    os.replace(tmp, segment_path)
    _write_index(segment_path, offsets, compacted=True)
    try:
        _store_counter().inc(event="compact")
    except Exception:
        pass
    return {"segment": os.path.basename(segment_path),
            "removed": removed, "kept": len(kept_lines)}


def compact_segments(log_dir: str, limit: Optional[int] = None,
                     exclude: Optional[set] = None,
                     ) -> List[Dict[str, Any]]:
    """The idle-time compaction pass: rewrite frozen segments (oldest
    first, never the active file) not yet marked compacted, up to
    ``limit``. Called with ``limit=1`` from the roll path — rolls are
    rare and already off the hot lock — and directly by tests/ops."""
    path = span_log_path(log_dir)
    out: List[Dict[str, Any]] = []
    dropped: Optional[set] = None
    for p in segment_paths(log_dir):
        if p == path or (exclude and p in exclude):
            continue
        if limit is not None and len(out) >= limit:
            break
        if segment_compacted(p):
            continue
        if dropped is None:
            dropped = _dropped_verdict_ids()
        try:
            out.append(compact_segment(p, dropped))
        except OSError:
            continue
    return out


def _read_lines_at(path: str, offsets: List[int],
                   ) -> Tuple[List[str], int]:
    """Seek-and-read one line per offset; returns the lines and the
    bytes actually read (the indexed-read evidence)."""
    out: List[str] = []
    n_bytes = 0
    try:
        with open(path, "rb") as f:
            for off in offsets:
                f.seek(off)
                raw = f.readline()
                n_bytes += len(raw)
                out.append(raw.decode("utf-8", errors="replace"))
    except OSError:
        return out, n_bytes
    return out, n_bytes


# --- Tail-sampling buffer ---------------------------------------------

def _tail_register(trace_id: str) -> None:
    flush: List[List[str]] = []
    with _tail_lock:
        if trace_id in _tail_pending:
            return
        while len(_tail_pending) >= _PENDING_MAX_TRACES:
            # Oldest pending first: its edge presumably died; retain.
            _oldest, lines = next(iter(_tail_pending.items()))
            del _tail_pending[_oldest]
            if lines:
                flush.append(lines)
        _tail_pending[trace_id] = []
    for lines in flush:
        _write_lines(lines)


def _tail_route(lines_by_ctx: List[Tuple[Optional[TraceContext],
                                         str]]) -> None:
    """Write span lines, detouring those of tail-pending traces into
    their buffer, suppressing those of recently dropped traces, and —
    for tail-marked traces MINTED IN ANOTHER PROCESS (the envelope's
    tail carry; their ids are unknown to this process's pending
    buffer) — holding them for the minting edge's verdict line in the
    verdict sidecar instead of writing orphans."""
    direct: List[str] = []
    overflow: List[str] = []
    now = time.monotonic()
    with _tail_lock:
        for ctx, line in lines_by_ctx:
            tid = ctx.trace_id if ctx is not None else None
            buf = _tail_pending.get(tid) if tid else None
            if buf is not None:
                if len(buf) >= _PENDING_MAX_SPANS:
                    # A runaway trace stops buffering: flush what it
                    # has, retain everything after (never drop spans
                    # we can no longer hold the verdict open for).
                    del _tail_pending[tid]
                    overflow.extend(buf)
                    overflow.append(line)
                else:
                    buf.append(line)
            elif tid and tid in _tail_dropped:
                continue
            elif ctx is not None and ctx.tail and \
                    _verdicts.get(tid) == "dropped":
                continue  # verdict already known: suppressed orphan
            elif ctx is not None and ctx.tail and \
                    _verdicts.get(tid) != "kept":
                # Remote-minted, verdict unknown: hold briefly.
                entry = _remote_pending.get(tid)
                if entry is None:
                    while len(_remote_pending) >= _REMOTE_MAX_TRACES:
                        _oldest, old = next(iter(
                            _remote_pending.items()))
                        del _remote_pending[_oldest]
                        overflow.extend(old[1])  # retain-on-doubt
                    entry = _remote_pending[tid] = \
                        [now + _REMOTE_HOLD_S, []]
                if len(entry[1]) >= _PENDING_MAX_SPANS:
                    # A runaway remote trace stops holding: flush and
                    # retain, mirroring the local pending buffer's
                    # overflow contract (bounded per trace, not just
                    # per trace COUNT).
                    del _remote_pending[tid]
                    overflow.extend(entry[1])
                    overflow.append(line)
                else:
                    entry[1].append(line)
            else:
                direct.append(line)
    if overflow:
        _write_lines(overflow)
    if direct:
        _write_lines(direct)
    _remote_sweep(now)


# --- Cross-process tail verdicts (the verdict sidecar) ----------------

def _verdict_path() -> Optional[str]:
    with _sink_lock:
        path = _sink_path
    if path is None:
        return None
    return os.path.join(os.path.dirname(path), VERDICT_FILE)


def _write_verdict(trace_id: str, verdict: str) -> None:
    """Append one retain/drop verdict line (minting edge only) so
    OTHER processes' held spans can honor it. Bounded: the file rolls
    once to ``.1`` at the size cap — verdicts only matter for the hold
    window, so losing old ones degrades to retain-on-doubt."""
    global _verdict_sink
    path = _verdict_path()
    if path is None:
        return
    line = json.dumps({"t": trace_id, "v": verdict},
                      separators=(",", ":")) + "\n"
    with _sink_lock:
        try:
            f = _verdict_sink
            if f is None or f.closed or f.name != path:
                os.makedirs(os.path.dirname(path) or ".",
                            exist_ok=True)
                # rta: disable=RTA105 same sink-bind idiom as _write_lines: the lock guards the handle, the lazy open is the bind
                _verdict_sink = f = open(path, "a", encoding="utf-8")
            f.write(line)
            f.flush()
            if f.tell() > _VERDICT_MAX_BYTES:
                f.close()
                _verdict_sink = None
                os.replace(path, path + ".1")
        except OSError:
            _verdict_sink = None


def _refresh_verdicts() -> None:
    """Incrementally fold new verdict-sidecar lines into the bounded
    verdict map (inode-aware: a roll by the writing process resets the
    read position)."""
    path = _verdict_path()
    if path is None:
        return
    try:
        st = os.stat(path)
    except OSError:
        return
    ident = (st.st_ino, st.st_dev)
    with _tail_lock:
        pos, prev_ident = _verdict_reader
        if prev_ident != ident or pos > st.st_size:
            pos = 0
        if st.st_size <= pos:
            _verdict_reader[:] = [pos, ident]
            return
    updates: Dict[str, str] = {}
    try:
        with open(path, "rb") as f:
            f.seek(pos)
            for raw in f:
                if not raw.endswith(b"\n"):
                    break  # torn tail write; re-read next refresh
                pos += len(raw)
                try:
                    rec = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                tid, v = rec.get("t"), rec.get("v")
                if isinstance(tid, str) and v in ("kept", "dropped"):
                    updates[tid] = v
    except OSError:
        return
    with _tail_lock:
        _verdict_reader[:] = [pos, ident]
        _verdicts.update(updates)
        while len(_verdicts) > _VERDICT_REMEMBER:
            _verdicts.pop(next(iter(_verdicts)))


def _remote_sweep(now: Optional[float] = None,
                  force: bool = False) -> None:
    """Resolve held remote-tail spans: a ``dropped`` verdict suppresses
    them (the orphan-rate win), ``kept`` — or hold expiry / ``force``
    with no verdict — writes them (retain-on-doubt)."""
    with _tail_lock:
        any_pending = bool(_remote_pending)
    if not any_pending:
        return
    _refresh_verdicts()
    if now is None:
        now = time.monotonic()
    write: List[str] = []
    kept = dropped = 0
    with _tail_lock:
        for tid in list(_remote_pending):
            deadline, lines = _remote_pending[tid]
            v = _verdicts.get(tid)
            if v == "dropped":
                del _remote_pending[tid]
                dropped += 1
            elif v == "kept" or force or now >= deadline:
                del _remote_pending[tid]
                write.extend(lines)
                kept += 1
    if write:
        _write_lines(write)
    for verdict, n in (("remote_kept", kept),
                       ("remote_dropped", dropped)):
        if n:
            try:
                _tail_counter().inc(n, verdict=verdict)
            except Exception:
                pass


def flush_remote_tail() -> None:
    """Resolve every held remote-tail span NOW (verdicts honored when
    already known, everything else retained) — shutdown/reconfigure
    hygiene and the test seam."""
    _remote_sweep(force=True)


def flush_remote_expired() -> None:
    """Resolve remote-held spans whose verdict arrived or whose hold
    deadline passed. The routine sweep rides every span write, but an
    IDLE worker writes none — long-poll loops (the inference worker's
    serve loop) call this per iteration so a quiet worker's held spans
    still honor the edge's verdict within ~one poll interval instead
    of waiting for its next burst. One lock check when nothing is
    pending."""
    _remote_sweep()


def complete(ctx: Optional[TraceContext], dur_s: float,
             error: bool = False) -> None:
    """The tail-sampling verdict, called by the minting edge when its
    request finishes: error and slow-over-threshold traces always
    flush to the store; fast/ok ones keep with the tail sample rate.
    No-op for non-tail contexts (honored headers, head-sampled legacy
    mode)."""
    if ctx is None or not ctx.tail:
        return
    rate = tail_sample_rate()
    with _tail_lock:
        lines = _tail_pending.pop(ctx.trace_id, None)
        if lines is None:
            verdict = None  # already flushed (overflow) — retained
        elif error:
            verdict = "kept_error"
        elif dur_s * 1e3 >= tail_slow_ms():
            verdict = "kept_slow"
        elif rate is None or _tail_rng.random() < rate:
            verdict = "kept_sampled"
        else:
            verdict = "dropped"
            _tail_dropped[ctx.trace_id] = None
            while len(_tail_dropped) > _DROPPED_REMEMBER:
                _tail_dropped.pop(next(iter(_tail_dropped)))
    # The verdict rides the sidecar EITHER WAY (overflow counts as
    # kept): a subprocess worker holding this trace's spans needs the
    # retain signal as much as the drop.
    _write_verdict(ctx.trace_id,
                   "dropped" if verdict == "dropped" else "kept")
    if verdict is None:
        return
    if verdict != "dropped" and lines:
        _write_lines(lines)
    try:
        # rta: disable=RTA301 verdict is the fixed vocabulary in _tail_counter's help; process-global family, deliberately immortal
        _tail_counter().inc(verdict=verdict)
    except Exception:
        pass


def _tail_counter():
    from . import metrics

    return metrics.registry().counter(
        "rafiki_tpu_trace_tail_total",
        "Tail-sampling verdicts (verdict=kept_error|kept_slow|"
        "kept_sampled|dropped at the minting edge; remote_kept|"
        "remote_dropped for held spans of edge-minted traces resolved "
        "in this process)")


def _tail_flush_all() -> None:
    with _tail_lock:
        pending = list(_tail_pending.values())
        _tail_pending.clear()
    for lines in pending:
        if lines:
            _write_lines(lines)


def exemplar_ok(ctx: TraceContext) -> bool:
    """Whether a metric exemplar may reference this trace: a
    tail-PENDING trace's verdict could still drop its spans, and a
    dropped trace's exemplar would link to an empty timeline. Non-tail
    contexts (honored headers, tail-off mode) and tail traces whose
    verdict KEPT them qualify; pending/dropped ones don't — the
    exemplar under-captures rather than dangles."""
    if not ctx.tail:
        return True
    with _tail_lock:
        return ctx.trace_id not in _tail_pending and \
            ctx.trace_id not in _tail_dropped


def seed_tail(seed: int) -> None:
    """Deterministic tail-sampling decisions (tests, seeded runs)."""
    global _tail_rng
    with _tail_lock:
        _tail_rng = random.Random(seed)


def reset_tail_for_tests() -> None:
    with _tail_lock:
        _tail_pending.clear()
        _tail_dropped.clear()
        _remote_pending.clear()
        _verdicts.clear()
        _verdict_reader[:] = [0, None]


def record_event(name: str, service: str,
                 ctxs: Iterable[Optional[TraceContext]],
                 start_wall: float, dur_s: float,
                 attrs: Optional[Dict[str, Any]] = None,
                 child: bool = True) -> None:
    """Append one span event per traced context. ``child=True`` (the
    common case) records a NEW span parented on each context's span;
    ``child=False`` records the context's own span (the HTTP edge,
    which minted it)."""
    # rta: disable=RTA101 hot-path early-out on the sink pointer (GIL-atomic reference read); the append path re-reads under _sink_lock
    if _sink_path is None:
        return
    lines: List[Tuple[Optional[TraceContext], str]] = []
    for ctx in ctxs:
        if ctx is None:
            continue
        span = {
            "trace_id": ctx.trace_id,
            "span_id": new_span_id() if child else ctx.span_id,
            "parent_id": ctx.span_id if child else ctx.parent_id,
            "name": name,
            "service": service,
            "start_s": round(start_wall, 6),
            "dur_ms": round(dur_s * 1e3, 3),
        }
        if attrs:
            span["attrs"] = attrs
        lines.append((ctx,
                      json.dumps(span, separators=(",", ":")) + "\n"))
    if lines:
        _tail_route(lines)


class span:
    """``with trace.span("worker.predict", service=sid, ctxs=...)`` —
    times the block (monotonic) and records the event(s) at exit.
    No-ops entirely when nothing is traced or no sink is configured."""

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


# --- Stitching (admin's GET /trace/<id>) ------------------------------

def segment_paths(log_dir: str) -> List[str]:
    """Store segments oldest-first: rolled generations ``.N`` .. ``.1``
    then the active file (only the ones that exist)."""
    path = span_log_path(log_dir)
    out = [f"{path}.{k}"
           for k in range(retain_segments(), 0, -1)
           if os.path.exists(f"{path}.{k}")]
    if os.path.exists(path):
        out.append(path)
    return out


def _active_offsets(path: str, trace_id: str) -> Tuple[List[int], int]:
    """The active segment's offsets for one trace via the incremental
    scan cache; second value is the bytes scanned by THIS lookup (the
    appended tail only, 0 on a warm repeat). The cache entry carries
    the file's inode: a roll performed by ANOTHER process replaces the
    active file (``os.replace`` + fresh create), and a size check
    alone would miss it whenever the new file has already grown past
    the cached scan position — stale offsets against new content would
    silently truncate timelines."""
    try:
        st = os.stat(path)
        size, ident = st.st_size, (st.st_ino, st.st_dev)
    except OSError:
        return [], 0
    with _active_lock:
        entry = _active_cache.get(path)
        if entry is None or entry[0] > size or entry[2] != ident:
            entry = [0, {}, ident]  # rolled/truncated/replaced: reset
            _active_cache[path] = entry
        scanned_from = entry[0]
        if size > entry[0]:
            # rta: disable=RTA105 the scan must fold into the cache entry atomically — two threads scanning the same tail concurrently would double-append offsets
            fresh, pos = _scan_offsets(path, start=entry[0])
            for tid, offs in fresh.items():
                entry[1].setdefault(tid, []).extend(offs)
            entry[0] = pos
        offsets = list(entry[1].get(trace_id, ()))
    return offsets, max(0, size - scanned_from)


def collect_trace(log_dir: str, trace_id: str,
                  max_spans: int = 1000) -> Dict[str, Any]:
    """Stitch every span of one trace across the segmented store into
    an ordered timeline. Frozen segments are INDEXED reads (sidecar
    ``.idx`` built at roll time, rebuilt lazily if missing): a seek
    and one readline per matching span, never a full-segment scan.
    The active segment rides the incremental scan cache — only bytes
    appended since the previous lookup are read. The per-segment
    ``segments`` diagnostics (mode + bytes_read) show which read each
    segment took. A corrupt line is skipped, never
    fatal."""
    path = span_log_path(log_dir)
    spans: List[Dict[str, Any]] = []
    diags: List[Dict[str, Any]] = []
    for p in segment_paths(log_dir):
        if len(spans) >= max_spans:
            break
        compacted = None
        if p == path:
            offsets, scanned = _active_offsets(p, trace_id)
            mode, overhead = "scan_tail", scanned
            try:
                _store_counter().inc(event="tail_scan")
            except Exception:
                pass
        else:
            data = _load_index_data(p)
            if data is None:
                try:
                    index = _build_index(p)
                    mode, compacted = "index_rebuilt", False
                except OSError:
                    continue
            else:
                index = data["traces"]
                mode = "index"
                compacted = bool(data.get("compacted"))
            try:
                _store_counter().inc(event="index_read")
            except Exception:
                pass
            offsets, overhead = list(index.get(trace_id, ())), 0
        lines, n_bytes = _read_lines_at(p, offsets[:max_spans
                                                   - len(spans)])
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("trace_id") == trace_id:
                spans.append(rec)
        diag = {"segment": os.path.basename(p), "mode": mode,
                "n_spans": len(lines),
                "bytes_read": n_bytes + overhead}
        if compacted is not None:
            # Frozen segments report whether the idle-time compaction
            # pass already rewrote them to only-retained traces.
            diag["compacted"] = compacted
        diags.append(diag)
    spans.sort(key=lambda s: (s.get("start_s", 0.0), s.get("name", "")))
    t0 = spans[0].get("start_s", 0.0) if spans else 0.0
    for s in spans:
        s["offset_ms"] = round((s.get("start_s", t0) - t0) * 1e3, 3)
    return {"trace_id": trace_id, "n_spans": len(spans),
            "spans": spans, "segments": diags}
