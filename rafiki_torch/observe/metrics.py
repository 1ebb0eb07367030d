"""Process-wide metrics registry with Prometheus text exposition.

The port's copy of ``rafiki_tpu/observe/metrics.py`` (:50-552): the one
place counters, gauges and fixed-bucket latency histograms live, so
every service exposes the same numbers over ``GET /metrics`` (wired
into ``utils.service.JsonHttpServer``) that ``GET /stats`` reads.

- Stdlib only: the bus and the HTTP layer instrument their hot path
  through this module.
- Cheap enough to be always on: a counter ``inc`` is one lock and one
  add; a histogram ``observe`` adds a scan over 14 bounds.
  ``RAFIKI_TPU_METRICS=0`` turns off the ``/metrics`` route and the
  call sites' wiring (read when they are built, not per operation).
- Bounded label cardinality: per-service serving series label by the
  frontend's short per-instance id, and their owners remove them when
  they stop.

Metric names are the reference's (``rafiki_tpu_<subsystem>_<name>_
<unit>``), so one parser reads both packages' expositions. The
reference's standalone metrics server for worker processes waits for
the port's process services.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

METRICS_ENV = "RAFIKI_TPU_METRICS"
EXEMPLARS_ENV = "RAFIKI_TPU_METRICS_EXEMPLARS"

#: Default latency buckets (seconds): 0.5 ms .. 10 s, roughly
#: logarithmic — wide enough for a bus push (~us, lands in the first
#: bucket) and a cold predictor gather (~seconds) alike.
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def metrics_enabled() -> bool:
    """``RAFIKI_TPU_METRICS=0`` disables exposition + instrumentation
    wiring. Read where wiring happens (server/bus construction), not
    per operation."""
    return os.environ.get(METRICS_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off")


#: Exemplar wiring, resolved once at the first histogram observe (off =
#: one check per observe).
_exemplars_flag: Optional[bool] = None
_exemplars_lock = threading.Lock()


def exemplars_enabled() -> bool:
    """Whether histograms attach a last-trace-id exemplar per bucket
    (``RAFIKI_TPU_METRICS_EXEMPLARS``, default off), rendered
    OpenMetrics-style in the exposition. Resolved once per process."""
    global _exemplars_flag
    # rta: disable=RTA101 double-checked init: the bare read is the fast path; the write re-checks under _exemplars_lock
    flag = _exemplars_flag
    if flag is None:
        with _exemplars_lock:
            flag = _exemplars_flag
            if flag is None:
                raw = os.environ.get(EXEMPLARS_ENV, "0")
                flag = raw.strip().lower() not in (
                    "0", "false", "no", "off", "")
                _exemplars_flag = flag
    return flag


def reset_exemplars_for_tests() -> None:
    """Drop the cached exemplar flag so a test that flips
    ``RAFIKI_TPU_METRICS_EXEMPLARS`` sees its env take effect."""
    global _exemplars_flag
    with _exemplars_lock:
        _exemplars_flag = None


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: Tuple[Tuple[str, str], ...],
                   extra: Optional[Dict[str, str]] = None) -> str:
    items = list(key) + sorted((extra or {}).items())
    if not items:
        return ""
    # json.dumps gives the exact escaping the exposition format wants
    # for label values (backslash, quote, newline).
    body = ",".join(f"{k}={json.dumps(str(v))}" for k, v in items)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically increasing float, one series per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]

    def remove(self, **labels: str) -> None:
        """Drop every series whose labels INCLUDE this subset. Series
        are otherwise immortal; owners of per-instance labels (a
        stopped predictor frontend, a finished trial) must call this or
        the registry and every scrape grow monotonically with churn."""
        match = set(_label_key(labels))
        with self._lock:
            for key in [k for k in self._values if match <= set(k)]:
                del self._values[key]

    def expose(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{_render_labels(k)} {_fmt(v)}"
                    for k, v in sorted(self._values.items())]


class Gauge(Counter):
    """Point-in-time value; ``set`` replaces, ``inc`` may go down."""

    kind = "gauge"

    def set(self, v: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels: str) -> None:
        # rta: disable=RTA301 registry plumbing: labels pass through; series lifecycle belongs to callers
        self.inc(-n, **labels)


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` buckets + sum/count),
    one series set per label set."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be a sorted non-empty sequence")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        # label key -> [per-bucket counts..., +Inf count, sum]
        self._series: Dict[Tuple, List[float]] = {}
        # label key -> {bucket index (len(buckets) = +Inf): (trace_id,
        # observed value, wall ts)} — the LAST traced observation per
        # bucket, attached OpenMetrics-style in the exposition so a p99
        # bucket links to an actual stitched timeline. Populated only
        # when RAFIKI_TPU_METRICS_EXEMPLARS is on AND the observing
        # thread carries a trace context.
        self._exemplars: Dict[Tuple, Dict[int, Tuple[str, float,
                                                     float]]] = {}

    def _row(self, key: Tuple) -> List[float]:
        row = self._series.get(key)
        if row is None:
            row = [0.0] * (len(self.buckets) + 2)
            self._series[key] = row
        return row

    def observe(self, v: float, **labels: str) -> None:
        exemplar = None
        if exemplars_enabled():
            from . import trace as _trace

            ctx = _trace.current()
            # exemplar_ok: a tail-sampled trace whose verdict is still
            # pending (or dropped) is not referenced, since the link
            # would lead to an empty timeline.
            if ctx is not None and _trace.exemplar_ok(ctx):
                import time as _time

                exemplar = (ctx.trace_id, float(v), _time.time())
        key = _label_key(labels)
        with self._lock:
            row = self._row(key)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    row[i] += 1
                    break
            else:
                i = len(self.buckets)
                row[i] += 1  # +Inf only
            row[-1] += v
            if exemplar is not None:
                self._exemplars.setdefault(key, {})[i] = exemplar

    # --- Reads ---

    def count(self, **labels: str) -> int:
        with self._lock:
            row = self._series.get(_label_key(labels))
            return int(sum(row[:-1])) if row else 0

    def sum(self, **labels: str) -> float:
        with self._lock:
            row = self._series.get(_label_key(labels))
            return row[-1] if row else 0.0

    def cumulative_buckets(self, **labels: str) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending at ``(+Inf, count)``
        — the exposition shape, also what percentile math wants."""
        with self._lock:
            row = self._series.get(_label_key(labels))
            if row is None:
                return []
            out, cum = [], 0
            for bound, n in zip(self.buckets, row):
                cum += int(n)
                out.append((bound, cum))
            out.append((math.inf, cum + int(row[len(self.buckets)])))
            return out

    def percentile(self, q: float, **labels: str) -> Optional[float]:
        return bucket_percentile(self.cumulative_buckets(**labels), q)

    def exemplars(self, **labels: str) -> Dict[str, Dict[str, Any]]:
        """``{le: {"trace_id", "value", "ts"}}`` for one label set —
        what a p99 bucket links to (empty unless
        exemplars are enabled and traced observations landed)."""
        with self._lock:
            ex = self._exemplars.get(_label_key(labels))
            if not ex:
                return {}
            out = {}
            for i, (tid, v, ts) in ex.items():
                le = (_fmt(self.buckets[i]) if i < len(self.buckets)
                      else "+Inf")
                out[le] = {"trace_id": tid, "value": v,
                           "ts": round(ts, 3)}
            return out

    def remove(self, **labels: str) -> None:
        """Drop every series whose labels include this subset (see
        :meth:`Counter.remove`)."""
        match = set(_label_key(labels))
        with self._lock:
            for key in [k for k in self._series if match <= set(k)]:
                del self._series[key]
                self._exemplars.pop(key, None)

    @staticmethod
    def _exemplar_suffix(ex: Optional[Tuple[str, float, float]]) -> str:
        """OpenMetrics exemplar annotation for one bucket line
        (`` # {trace_id="…"} <value> <ts>``), empty when absent."""
        if ex is None:
            return ""
        tid, v, ts = ex
        return (f' # {{trace_id="{tid}"}} {_fmt(v)} '
                f"{round(ts, 3)}")

    def expose(self, exemplars: bool = False) -> List[str]:
        lines = []
        with self._lock:
            series = sorted(self._series.items())
            exemplars_by_key = ({k: dict(v)
                                 for k, v in self._exemplars.items()}
                                if exemplars else {})
        for key, row in series:
            ex = exemplars_by_key.get(key, {})
            cum = 0
            for i, (bound, n) in enumerate(zip(self.buckets, row)):
                cum += int(n)
                lines.append(
                    f"{self.name}_bucket"
                    f"{_render_labels(key, {'le': _fmt(bound)})} {cum}"
                    f"{self._exemplar_suffix(ex.get(i))}")
            total = cum + int(row[len(self.buckets)])
            lines.append(
                f"{self.name}_bucket"
                f"{_render_labels(key, {'le': '+Inf'})} {total}"
                f"{self._exemplar_suffix(ex.get(len(self.buckets)))}")
            lines.append(f"{self.name}_sum{_render_labels(key)} "
                         f"{_fmt(row[-1])}")
            lines.append(f"{self.name}_count{_render_labels(key)} {total}")
        return lines


def bucket_percentile(cum_buckets: List[Tuple[float, int]],
                      q: float) -> Optional[float]:
    """Approximate the q-quantile (0..1) from cumulative ``le`` buckets
    by linear interpolation inside the containing bucket — the same
    estimate Prometheus's ``histogram_quantile`` computes, so a scrape
    and ``/stats`` agree by construction. None when empty; a
    quantile landing in the +Inf bucket reports the last finite bound
    (a known floor, not a fabricated value)."""
    if not cum_buckets:
        return None
    total = cum_buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0
    for bound, cum in cum_buckets:
        if cum >= rank:
            if bound == math.inf:
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, cum
    return prev_bound


class MetricsRegistry:
    """Get-or-create metric registry; ``registry()`` is the process
    singleton every subsystem shares."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def find(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format 0.0.4. ``exemplars=True``
        (the explicit ``?exemplars=1`` debug view — see
        ``metrics_route``) additionally annotates histogram buckets
        with their last traced observation, OpenMetrics-style; the
        default exposition never carries them — annotation syntax is
        not part of 0.0.4, and a scrape config must never receive it
        by accident."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if exemplars and isinstance(m, Histogram):
                lines.extend(m.expose(exemplars=True))
            else:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


# --- Thread-local label context -------------------------------------
#
# Code that publishes series without knowing whose they are reads the
# labels its caller bound, e.g. ``trial=<id>`` around a train loop.

_labels_local = threading.local()


class label_context:
    """``with metrics.label_context(trial=tid): ...`` — labels every
    ``bound_labels()`` read on this thread for the duration."""

    def __init__(self, **labels: str):
        self._labels = {k: str(v) for k, v in labels.items()}

    def __enter__(self):
        prior = getattr(_labels_local, "labels", {})
        self._prior = prior
        _labels_local.labels = {**prior, **self._labels}
        return self

    def __exit__(self, *exc):
        _labels_local.labels = self._prior
        return False


def bound_labels() -> Dict[str, str]:
    return dict(getattr(_labels_local, "labels", {}))


# --- Exposition parsing (tests and checks read what a service exposes) -

def _is_escaped(s: str, i: int) -> bool:
    """Whether ``s[i]`` is escaped: preceded by an ODD number of
    backslashes (a value ending in ``\\\\`` must not hide its closing
    quote — the bug a single-backslash look-behind has)."""
    n = 0
    j = i - 1
    while j >= 0 and s[j] == "\\":
        n += 1
        j -= 1
    return n % 2 == 1


def strip_exemplar(line: str) -> str:
    """Drop an OpenMetrics exemplar annotation (`` # {...} value
    [ts]``) from a sample line, respecting quotes — a ``#`` inside a
    quoted label value is data, not an annotation. Scrapers of the
    exposition route through
    :func:`parse_exposition`, so exemplars can never break them."""
    if "#" not in line:  # the overwhelming default: no scan at all
        return line
    in_quote = False
    for i, ch in enumerate(line):
        if ch == '"' and not _is_escaped(line, i):
            in_quote = not in_quote
        elif ch == "#" and not in_quote and i >= 1 \
                and line[i - 1] in " \t":
            return line[:i - 1].rstrip()
    return line


def parse_exposition(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Parse Prometheus text into ``{name: [(labels, value), ...]}``.
    Minimal by design: handles what ``MetricsRegistry.expose`` emits —
    including OpenMetrics-style exemplar annotations on histogram
    bucket lines (tolerated and stripped) and json-escaped label
    values (``\\"``, ``\\n``, ``\\\\`` round-trip exactly). It is how
    readers of ``/metrics`` get numbers instead of
    re-deriving numbers client-side, so it must never regress on what
    the exposition grows."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        line = strip_exemplar(line)
        name_part, _, value_part = line.rpartition(" ")
        labels: Dict[str, str] = {}
        if "{" in name_part:
            name, _, label_body = name_part.partition("{")
            label_body = label_body.rstrip("}")
            # Label values are json-escaped strings; wrap the body into
            # a json object to parse them exactly.
            body = "{" + ",".join(
                f'"{kv.split("=", 1)[0]}":{kv.split("=", 1)[1]}'
                for kv in _split_labels(label_body)) + "}"
            labels = {k: str(v) for k, v in json.loads(body).items()}
        else:
            name = name_part
        value = math.inf if value_part == "+Inf" else float(value_part)
        out.setdefault(name, []).append((labels, value))
    return out


def _split_labels(body: str) -> Iterable[str]:
    """Split ``k1="v1",k2="v2"`` on commas outside quoted values
    (escape-aware: ``\\"`` stays inside a value, ``\\\\"`` closes it)."""
    depth_quote = False
    start = 0
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == '"' and not _is_escaped(body, i):
            depth_quote = not depth_quote
        elif ch == "," and not depth_quote:
            yield body[start:i]
            start = i + 1
        i += 1
    if start < len(body):
        yield body[start:]


def histogram_percentiles_ms(samples: List[Tuple[Dict[str, str], float]],
                             qs: Sequence[float] = (0.5, 0.95, 0.99),
                             **match: str) -> Optional[List[float]]:
    """Percentiles (milliseconds) of one exposed histogram: feed the
    ``<name>_bucket`` samples from :func:`parse_exposition`, filtered
    to the label subset ``match``. None when no matching observations."""
    cum: Dict[float, int] = {}
    for labels, value in samples:
        if any(labels.get(k) != str(v) for k, v in match.items()):
            continue
        le = labels.get("le")
        if le is None:
            continue
        bound = math.inf if le == "+Inf" else float(le)
        cum[bound] = cum.get(bound, 0) + int(value)
    if not cum:
        return None
    buckets = sorted(cum.items(), key=lambda kv: kv[0])
    if buckets[-1][1] <= 0:
        return None
    out = []
    for q in qs:
        v = bucket_percentile(buckets, q)
        out.append(round(v * 1e3, 3) if v is not None else None)
    return out


# --- The metrics-only server of a service process ---

#: A service process (``python -m rafiki_torch.container.services``)
#: starts ``serve_metrics`` on this port when it is set (0 = a free
#: port).
METRICS_PORT_ENV = "RAFIKI_TPU_METRICS_PORT"


def serve_metrics(host: str = "0.0.0.0", port: int = 0,
                  name: str = "metrics"):
    """A ``JsonHttpServer``, started, whose only routes are the
    ``GET /metrics`` every such server has and a health ``GET /``: the
    scrape surface of a train or inference worker in a process of its
    own. Services that are threads of the admin's process need none,
    since the admin serves the same registry."""
    from ..utils.service import JsonHttpServer

    server = JsonHttpServer(
        # rta: disable=RTA702 exporter liveness stub for scrapers; /metrics is the real surface
        [("GET", "/", lambda params, body, ctx: (200, {"status": "ok"}))],
        host=host, port=port, name=name)
    return server.start()
