"""SLO plane: declarative objectives, error budgets, burn-rate alerts.

The port's copy of ``rafiki_tpu/observe/slo.py``: the vocabulary that
``admin/slo_engine.py`` evaluates on the supervise sweep.

An objective asks that at least ``target`` of the events over a rolling
budget window ``window_s`` be good:

- ``latency``: requests that complete within ``threshold_ms``, read from
  histogram bucket deltas with the interpolation ``bucket_percentile``
  makes. Scope ``job`` reads the predictor's ``/predict`` histogram,
  ``bin`` the workers' per-bin device-time histogram and ``tenant`` the
  frontend's tenant-labelled request histogram;
- ``ratio``: admitted requests, from the serving requests and rejected
  counters (``job`` scope only).

The budget is ``1 - target``; ``budget_remaining = 1 -
bad_fraction/budget`` (floored at 0), and a window's burn rate is
``bad_fraction/budget`` (1.0 spends the budget at the window's pace).

An alert goes pending when the burn rate reaches ``burn`` over both the
fast and the slow window, fires after ``for_s`` of breach, and resolves
once the fast window has stayed under ``burn`` for ``resolve_s``.

Rules come from ``RAFIKI_TPU_SLO_RULES`` (``NodeConfig.slo_rules``): a
``.json``/``.toml`` rules file, or ``;``-separated inline rules::

    predict-p99:p99<50ms,window=300,fast=60,slow=300,burn=2,for=10,resolve=30
    avail:ratio>=0.995,window=600

An unknown key or a malformed spec is rejected, so a typo'd objective
fails the node's construction. Nothing here reads the clock: the caller
passes ``now``.
"""

from __future__ import annotations

import json
import math
import os
import re
from collections import deque
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

SLO_RULES_ENV = "RAFIKI_TPU_SLO_RULES"

#: The series the evaluator reads (and never registers), by (type,
#: scope).
CONSUMED_SERIES: Dict[Tuple[str, str], str] = {
    ("latency", "job"): "rafiki_tpu_http_request_seconds",
    ("latency", "bin"): "rafiki_tpu_serving_bin_device_seconds",
    ("latency", "tenant"): "rafiki_tpu_serving_tenant_request_seconds",
    ("ratio", "good"): "rafiki_tpu_serving_requests_total",
    ("ratio", "bad"): "rafiki_tpu_serving_rejected_total",
}

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,39}$")
_LATENCY_SPEC_RE = re.compile(
    r"^p([0-9]+(?:\.[0-9]+)?)<([0-9]+(?:\.[0-9]+)?)ms$")
_RATIO_SPEC_RE = re.compile(r"^ratio>=(0?\.[0-9]+|1(?:\.0+)?)$")

_INLINE_KEYS = frozenset({"scope", "window", "fast", "slow", "burn",
                          "for", "resolve", "route", "job", "metric"})
_SCOPES = ("job", "bin", "tenant")


@dataclass(frozen=True)
class Objective:
    """One declarative objective (see the module docstring)."""

    name: str
    otype: str                 # "latency" | "ratio"
    target: float              # required good-event fraction, (0, 1)
    threshold_ms: float = 0.0  # latency objectives only
    scope: str = "job"         # "job" | "bin" | "tenant"
    window_s: float = 300.0    # error-budget window
    fast_s: float = 60.0       # fast burn window (reaction)
    slow_s: float = 300.0      # slow burn window (flap guard)
    burn: float = 2.0          # burn-rate alert threshold, both windows
    for_s: float = 0.0         # continuous breach before firing
    resolve_s: float = 0.0     # fast-window-quiet before resolving
    route: str = "/predict"    # http route (latency/job scope)
    job: str = ""              # inference-job id prefix filter ("": all)
    metric: str = ""           # source-series override ("": the default)

    def source_metric(self) -> str:
        if self.metric:
            return self.metric
        return CONSUMED_SERIES[(self.otype, self.scope
                                if self.otype == "latency" else "good")]

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def validate(self) -> "Objective":
        if not _NAME_RE.match(self.name):
            raise ValueError(f"SLO objective name {self.name!r} must "
                             f"match {_NAME_RE.pattern}")
        if self.otype not in ("latency", "ratio"):
            raise ValueError(f"SLO objective {self.name}: type "
                             f"{self.otype!r} is not latency/ratio")
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"SLO objective {self.name}: target "
                             f"{self.target} must be within (0, 1)")
        if self.otype == "latency" and self.threshold_ms <= 0:
            raise ValueError(f"SLO objective {self.name}: latency "
                             f"objectives need threshold_ms > 0")
        if self.scope not in _SCOPES:
            raise ValueError(f"SLO objective {self.name}: scope "
                             f"{self.scope!r} is not one of {_SCOPES}")
        if self.otype == "ratio" and self.scope != "job":
            raise ValueError(
                f"SLO objective {self.name}: ratio objectives are "
                f"job-scoped only (no per-bin/per-tenant error "
                f"counter exists to read)")
        if self.otype == "ratio" and self.metric:
            raise ValueError(
                f"SLO objective {self.name}: ratio objectives read a "
                f"counter PAIR (requests + rejected) — a single "
                f"metric override cannot express that, and silently "
                f"ignoring it would judge the wrong series")
        if not (0 < self.fast_s <= self.slow_s):
            raise ValueError(f"SLO objective {self.name}: need "
                             f"0 < fast_s <= slow_s")
        if self.window_s < self.slow_s:
            raise ValueError(f"SLO objective {self.name}: the budget "
                             f"window must be >= the slow burn window")
        if self.burn <= 0:
            raise ValueError(f"SLO objective {self.name}: burn "
                             f"threshold must be positive")
        if self.for_s < 0 or self.resolve_s < 0:
            raise ValueError(f"SLO objective {self.name}: for_s and "
                             f"resolve_s must be >= 0")
        return self


def _from_mapping(name: str, raw: Dict[str, Any]) -> Objective:
    """Build one objective from a rules-file table. Unknown keys are
    rejected loudly — a typo'd field must not silently fall back to a
    default."""
    keymap = {
        "type": "otype", "target": "target",
        "threshold_ms": "threshold_ms", "scope": "scope",
        "window_s": "window_s", "fast_window_s": "fast_s",
        "slow_window_s": "slow_s", "burn_threshold": "burn",
        "for_s": "for_s", "resolve_for_s": "resolve_s",
        "route": "route", "job": "job", "metric": "metric",
    }
    unknown = set(raw) - set(keymap) - {"name"}
    if unknown:
        raise ValueError(
            f"SLO objective {name}: unknown field(s) "
            f"{sorted(unknown)} (valid: {sorted(keymap)})")
    kwargs: Dict[str, Any] = {"name": name}
    ftypes = {f.name: f.type for f in fields(Objective)}
    for src, dst in keymap.items():
        if src not in raw:
            continue
        value = raw[src]
        if ftypes[dst] == "float":
            value = float(value)
        elif ftypes[dst] == "str":
            value = str(value)
        kwargs[dst] = value
    if "otype" not in kwargs:
        raise ValueError(f"SLO objective {name}: missing 'type'")
    if "target" not in kwargs:
        raise ValueError(f"SLO objective {name}: missing 'target'")
    _window_defaults(kwargs)
    return Objective(**kwargs).validate()


def _window_defaults(kwargs: Dict[str, Any]) -> None:
    """Fill dependent window defaults in place: slow defaults to the
    budget window, fast to window/5 capped at 60 s, resolve to one
    fast window of quiet (shared by the file and inline parsers so the
    two sources cannot drift)."""
    window = kwargs.get("window_s", 300.0)
    kwargs.setdefault("slow_s", window)
    kwargs.setdefault("fast_s", min(60.0, window / 5.0))
    kwargs.setdefault("resolve_s", kwargs["fast_s"])


def _parse_inline_rule(rule: str) -> Objective:
    name, sep, rest = rule.partition(":")
    if not sep or not rest.strip():
        raise ValueError(f"SLO rule {rule!r} is not name:spec[,k=v...]")
    name = name.strip()
    parts = [p.strip() for p in rest.split(",") if p.strip()]
    spec, kvs = parts[0], parts[1:]
    kwargs: Dict[str, Any] = {"name": name}
    m = _LATENCY_SPEC_RE.match(spec)
    if m:
        kwargs["otype"] = "latency"
        kwargs["target"] = float(m.group(1)) / 100.0
        kwargs["threshold_ms"] = float(m.group(2))
    else:
        m = _RATIO_SPEC_RE.match(spec)
        if m:
            kwargs["otype"] = "ratio"
            kwargs["target"] = float(m.group(1))
        else:
            raise ValueError(
                f"SLO rule {name}: spec {spec!r} is neither "
                f"p<q><<ms>ms (e.g. p99<50ms) nor ratio>=<frac>")
    # Window keys resolve AFTER all kvs are read (fast/slow default
    # from window); collect first.
    seen: Dict[str, str] = {}
    for kv in kvs:
        key, sep, value = kv.partition("=")
        key, value = key.strip(), value.strip()
        if not sep or not value:
            raise ValueError(f"SLO rule {name}: {kv!r} is not k=v")
        if key not in _INLINE_KEYS:
            raise ValueError(f"SLO rule {name}: unknown key {key!r} "
                             f"(valid: {sorted(_INLINE_KEYS)})")
        if key in seen:
            raise ValueError(f"SLO rule {name}: duplicate key {key!r}")
        seen[key] = value
    for key, value in seen.items():
        if key in ("window", "fast", "slow", "burn", "for", "resolve"):
            try:
                num = float(value)
            except ValueError:
                raise ValueError(f"SLO rule {name}: {key}={value!r} is "
                                 f"not a number") from None
            kwargs[{"window": "window_s", "fast": "fast_s",
                    "slow": "slow_s", "burn": "burn", "for": "for_s",
                    "resolve": "resolve_s"}[key]] = num
        else:
            kwargs[key] = value
    _window_defaults(kwargs)
    return Objective(**kwargs).validate()


def _parse_rules_data(data: Any, source: str) -> List[Objective]:
    if not isinstance(data, dict) or \
            not isinstance(data.get("objectives"), list):
        raise ValueError(f"SLO rules {source}: expected an object with "
                         f"an 'objectives' array")
    out: List[Objective] = []
    for i, raw in enumerate(data["objectives"]):
        if not isinstance(raw, dict):
            raise ValueError(f"SLO rules {source}: objectives[{i}] is "
                             f"not an object")
        name = str(raw.get("name") or "")
        if not name:
            raise ValueError(f"SLO rules {source}: objectives[{i}] "
                             f"has no name")
        out.append(_from_mapping(name, raw))
    return out


def parse_rules(text: str) -> List[Objective]:
    """Parse a rules source: '' → no objectives; a value ending in
    ``.json``/``.toml`` → that rules file (which must exist and parse —
    failing the node loudly beats silently judging nothing); anything
    else → the compact inline grammar. Duplicate objective names are
    rejected (the name keys every gauge/alert label)."""
    text = (text or "").strip()
    if not text:
        return []
    if text.endswith(".json") or text.endswith(".toml"):
        try:
            with open(text, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise ValueError(f"SLO rules file {text!r}: {e}") from None
        if text.endswith(".json"):
            try:
                data = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(
                    f"SLO rules file {text!r}: {e}") from None
        else:
            try:
                import tomllib
            except ImportError:  # pragma: no cover - py<3.11
                raise ValueError(
                    f"SLO rules file {text!r}: TOML rules need "
                    f"Python 3.11+ (tomllib); use JSON") from None
            try:
                data = tomllib.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, tomllib.TOMLDecodeError) as e:
                raise ValueError(
                    f"SLO rules file {text!r}: {e}") from None
        objectives = _parse_rules_data(data, text)
    else:
        objectives = [_parse_inline_rule(rule)
                      for rule in text.split(";") if rule.strip()]
    names = [o.name for o in objectives]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(f"SLO rules: duplicate objective name(s) "
                         f"{dupes}")
    return objectives


def rules_from_env() -> List[Objective]:
    return parse_rules(os.environ.get(SLO_RULES_ENV, ""))


# --- Event accounting -------------------------------------------------

def good_total_from_deltas(cum_deltas: List[Tuple[float, int]],
                           threshold_s: float) -> Tuple[float, float]:
    """``(good, total)`` events from one sweep's cumulative bucket
    DELTAS (``[(le_seconds, cumulative_delta), ...]`` sorted, ending at
    ``(inf, total)``): good = the interpolated count at the latency
    threshold — the same linear-within-bucket estimate
    ``bucket_percentile`` makes, so the SLO's good fraction and the
    dashboard's quantile agree by construction. Events beyond the last
    finite bound count bad."""
    if not cum_deltas:
        return 0.0, 0.0
    total = float(cum_deltas[-1][1])
    if total <= 0:
        return 0.0, 0.0
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in cum_deltas:
        if bound >= threshold_s:
            if bound == math.inf:
                return float(prev_cum), total
            if bound == prev_bound:
                return float(cum), total
            frac = (threshold_s - prev_bound) / (bound - prev_bound)
            return prev_cum + (cum - prev_cum) * frac, total
        prev_bound, prev_cum = bound, float(cum)
    return total, total


class WindowRing:
    """Ring of per-sweep ``(t, good, total)`` event deltas, bounded by
    the horizon (the longest window that ever reads it). Sums are exact
    over whatever landed inside the window — no decay math, no
    bucketing drift; the supervise cadence bounds the entry count."""

    __slots__ = ("horizon_s", "_ring")

    def __init__(self, horizon_s: float, maxlen: int = 4096):
        self.horizon_s = horizon_s
        self._ring: "deque[Tuple[float, float, float]]" = \
            deque(maxlen=maxlen)

    def add(self, t: float, good: float, total: float) -> None:
        if total > 0:
            self._ring.append((t, max(0.0, good), total))
        while self._ring and t - self._ring[0][0] > self.horizon_s:
            self._ring.popleft()

    def sums(self, t: float, window_s: float) -> Tuple[float, float]:
        good = total = 0.0
        for ts, g, n in reversed(self._ring):
            if t - ts > window_s:
                break
            good += g
            total += n
        return good, total

    def bad_fraction(self, t: float, window_s: float) -> float:
        good, total = self.sums(t, window_s)
        if total <= 0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - good / total))

    def burn_rate(self, t: float, window_s: float,
                  budget: float) -> float:
        """``bad_fraction / budget``: 1.0 = spending the error budget
        exactly at the window's pace; N = N× faster."""
        if budget <= 0:
            return 0.0
        return self.bad_fraction(t, window_s) / budget

    def budget_remaining(self, t: float, window_s: float,
                         budget: float) -> float:
        """Fraction of the window's error budget left, floored at 0
        (a gauge reading -3 helps nobody; the burn gauge carries the
        overshoot)."""
        if budget <= 0:
            return 0.0
        return max(0.0, min(1.0,
                            1.0 - self.bad_fraction(t, window_s)
                            / budget))


# --- Alert state machine ----------------------------------------------

#: Fixed transition vocabulary (the ``state`` label of
#: ``rafiki_tpu_slo_alerts_total`` — never free text).
TRANSITIONS = ("pending", "firing", "resolved", "cleared")


class AlertMachine:
    """Pure multi-window burn-rate alert state per objective instance.

    ``ok -> pending`` when BOTH windows breach; ``pending -> firing``
    after ``for_s`` of continuous breach (``for_s == 0`` fires
    immediately); ``pending -> ok`` ("cleared") the moment either
    window recovers; ``firing -> ok`` ("resolved") once the FAST
    window has stayed under threshold for ``resolve_s``. Flap-proof by
    construction: entering takes both windows + the for-duration,
    leaving takes sustained quiet — oscillation around the threshold
    inside one fast window changes nothing (unit-tested like
    ``AutoscalePolicy``'s decision table).
    """

    __slots__ = ("state", "_t_breach", "_t_quiet")

    def __init__(self):
        self.state = "ok"
        self._t_breach: Optional[float] = None
        self._t_quiet: Optional[float] = None

    def update(self, now: float, burn_fast: float, burn_slow: float,
               obj: Objective) -> Optional[str]:
        """Advance one evaluation tick; returns the transition taken
        (one of :data:`TRANSITIONS`) or None."""
        breach = burn_fast >= obj.burn and burn_slow >= obj.burn
        if self.state == "ok":
            if breach:
                self._t_breach = now
                if obj.for_s <= 0:
                    self.state = "firing"
                    self._t_quiet = None
                    return "firing"
                self.state = "pending"
                return "pending"
            return None
        if self.state == "pending":
            if not breach:
                self.state = "ok"
                self._t_breach = None
                return "cleared"
            t_breach = self._t_breach if self._t_breach is not None \
                else now
            if now - t_breach >= obj.for_s:
                self.state = "firing"
                self._t_quiet = None
                return "firing"
            return None
        # firing: resolve on sustained FAST-window quiet.
        if burn_fast < obj.burn:
            if self._t_quiet is None:
                self._t_quiet = now
            if now - self._t_quiet >= obj.resolve_s:
                self.state = "ok"
                self._t_breach = None
                self._t_quiet = None
                return "resolved"
        else:
            self._t_quiet = None
        return None


@dataclass
class Instance:
    """One evaluated (objective, scope-labels) series: its event ring,
    alert machine, previous-scrape basis, and last evaluation."""

    objective: Objective
    labels: Dict[str, str]
    ring: WindowRing
    machine: AlertMachine = field(default_factory=AlertMachine)
    prev: Optional[Any] = None      # previous cumulative snapshot
    last_seen: float = 0.0
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    budget_remaining: float = 1.0
    good: float = 0.0               # window sums at the last eval
    total: float = 0.0

    @classmethod
    def create(cls, obj: Objective,
               labels: Dict[str, str]) -> "Instance":
        return cls(objective=obj, labels=dict(labels),
                   ring=WindowRing(max(obj.window_s, obj.slow_s)))

    def evaluate(self, now: float, good: float,
                 total: float) -> Optional[str]:
        """Fold one sweep's event deltas and advance the alert machine;
        returns the transition taken, if any."""
        obj = self.objective
        self.ring.add(now, good, total)
        self.last_seen = now
        self.burn_fast = self.ring.burn_rate(now, obj.fast_s,
                                             obj.budget)
        self.burn_slow = self.ring.burn_rate(now, obj.slow_s,
                                             obj.budget)
        self.budget_remaining = self.ring.budget_remaining(
            now, obj.window_s, obj.budget)
        self.good, self.total = self.ring.sums(now, obj.window_s)
        return self.machine.update(now, self.burn_fast,
                                   self.burn_slow, obj)
