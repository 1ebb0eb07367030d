"""Deterministic, seedable fault-injection plane.

The port's copy of ``rafiki_tpu/faults.py``. Every injection site asks
it for a hook when the site is built, and a process with no fault plan
stores ``None``: the hot path then pays one attribute comparison.

Plan grammar (``RAFIKI_TPU_FAULT_PLAN``; rules ``;``-separated)::

    rule   := site '.' kind [ ':' params ]
    params := key '=' value [ ',' key '=' value ... ]

Sites and kinds:

==========  ==============  ===============================================
site        kind            effect at the site
==========  ==============  ===============================================
``bus``     ``delay``       sleep ``ms`` before the op (memory and TCP)
``bus``     ``drop``        discard a ``push``/``push_many`` (other ops
                            ignore a drop verdict)
``bus``     ``disconnect``  raise ``ConnectionError`` (the TCP client also
                            drops its socket, as after a broker's death)
``http``    ``error``       reply ``code`` (503 by default) before dispatch
``http``    ``timeout``     stall the handler ``ms`` before dispatch
``worker``  ``slow``        sleep ``ms`` before an inference dispatch
``worker``  ``crash``       raise :class:`InjectedCrash` in the serve loop:
                            the worker dies hard (row left RUNNING,
                            registration stale), so ``supervise`` must
                            notice it
``node``    ``kill``        hard-kill every running service of the
                            matching node at the end of its supervise
                            sweep; ``op=`` matches the node id
==========  ==============  ===============================================

Selection params (at most one a rule; ``p=1`` by default):

- ``p=0.1``: fire with probability 0.1, drawn from a PRNG seeded by
  ``RAFIKI_TPU_FAULT_SEED`` and the rule's position, so a seeded plan
  replays the same decision sequence (per rule; the interleaving of
  calls across threads still varies). The seed string is the
  reference's, so one seed gives both packages one sequence.
- ``n=3``: fire on the 3rd eligible call (1-based), once.
- ``every=5``: fire on every 5th eligible call.

Match params (optional): ``op`` (bus op or HTTP method, or the node id
at the node site), ``kind`` (bus queue kind: ``query``, ``reply`` or
``other``) and ``route`` (an HTTP route pattern). Effect params: ``ms``
(50 by default) and ``code`` (503 by default).

Every fired injection counts in
``rafiki_tpu_fault_injections_total{site,kind}``; the series is born at
the first fire, so a plan that never fires leaves the registry as it
was.

``set_plan(text, seed)`` swaps the live rules: a site built while a plan
was armed consults the current rules on every op, so a stack can be
built quietly (``set_plan("")``: armed, no rules) and injured later.
``set_plan(None)`` disarms the plane; only sites built after that get
no hook.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .observe import metrics as _metrics

_log = logging.getLogger(__name__)

PLAN_ENV = "RAFIKI_TPU_FAULT_PLAN"
SEED_ENV = "RAFIKI_TPU_FAULT_SEED"

SITES = ("bus", "http", "worker", "node")

_KINDS = {
    "bus": ("delay", "drop", "disconnect"),
    "http": ("error", "timeout"),
    "worker": ("slow", "crash"),
    "node": ("kill",),
}

#: Every param key a rule may carry (selection, match and effect).
_PARAM_KEYS = frozenset(
    {"p", "n", "every", "op", "kind", "route", "ms", "code"})


class FaultInjected(Exception):
    """Raised by the fault plane only, never by a real failure."""


class InjectedCrash(FaultInjected):
    """A ``worker.crash`` rule fired: the serve loop dies hard. Not a
    ``RuntimeError``, which the loop's bus recovery would absorb."""


class _Rule:
    __slots__ = ("site", "kind", "params", "rng", "_count", "_spent",
                 "_lock")

    def __init__(self, site: str, kind: str, params: Dict[str, str],
                 seed: int, index: int):
        self.site = site
        self.kind = kind
        self.params = params
        self.rng = random.Random(f"{seed}:{index}:{site}.{kind}")
        self._count = 0  # eligible (matched) calls seen
        self._spent = False  # an n= rule fires once
        self._lock = threading.Lock()

    def matches(self, op: str, kind: str, route: str) -> bool:
        for key, got in (("op", op), ("kind", kind), ("route", route)):
            want = self.params.get(key)
            if want is not None and want != got:
                return False
        return True

    def due(self) -> bool:
        """One eligible call: advance the counter or the PRNG and say
        whether the rule fires. Locked: the sites are multithreaded,
        and a torn counter would break ``n=`` and ``every=``."""
        with self._lock:
            if self._spent:
                return False
            self._count += 1
            if "n" in self.params:
                if self._count == int(self.params["n"]):
                    self._spent = True
                    return True
                return False
            if "every" in self.params:
                return self._count % max(1, int(self.params["every"])) == 0
            p = float(self.params.get("p", 1.0))
            if p >= 1.0:
                return True
            return self.rng.random() < p

    def ms(self, default: float = 50.0) -> float:
        return float(self.params.get("ms", default))


class FaultPlan:
    """A parsed plan: rules by site, and the injection counter, born at
    the first fire (``NodeConfig.validate`` parses plans it never
    arms)."""

    def __init__(self, rules: List[_Rule]):
        self.rules: Dict[str, List[_Rule]] = {}
        for r in rules:
            self.rules.setdefault(r.site, []).append(r)
        self._counter = None
        self._counter_known = False
        self._counter_lock = threading.Lock()

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse a plan; an unknown site, kind or param key, a malformed
        rule or two selection params raise ``ValueError``: a typo must
        not leave a plan that injects something else or nothing."""
        rules: List[_Rule] = []
        for i, raw in enumerate(t for t in text.split(";") if t.strip()):
            rule = raw.strip()
            head, _, param_s = rule.partition(":")
            site, _, kind = head.strip().partition(".")
            site, kind = site.strip(), kind.strip()
            if site not in _KINDS or kind not in _KINDS[site]:
                raise ValueError(
                    f"fault plan rule {rule!r}: unknown site.kind "
                    f"{head.strip()!r} (valid: "
                    f"{ {s: list(k) for s, k in _KINDS.items()} })")
            params: Dict[str, str] = {}
            for pair in (p for p in param_s.split(",") if p.strip()):
                k, sep, v = pair.partition("=")
                if not sep:
                    raise ValueError(f"fault plan rule {rule!r}: param "
                                     f"{pair.strip()!r} is not key=value")
                params[k.strip()] = v.strip()
            unknown = set(params) - _PARAM_KEYS
            if unknown:
                raise ValueError(
                    f"fault plan rule {rule!r}: unknown param(s) "
                    f"{sorted(unknown)} (valid: {sorted(_PARAM_KEYS)})")
            sel = [k for k in ("p", "n", "every") if k in params]
            if len(sel) > 1:
                raise ValueError(
                    f"fault plan rule {rule!r}: selection params {sel} "
                    f"are mutually exclusive (exactly one of p=/n=/every=)")
            for k in ("p", "ms"):
                if k in params:
                    float(params[k])
            for k in ("n", "every", "code"):
                if k in params:
                    int(params[k])
            rules.append(_Rule(site, kind, params, seed, i))
        return cls(rules)

    def _count_fire(self, site: str, kind: str) -> None:
        if not self._counter_known:
            with self._counter_lock:
                if not self._counter_known:
                    if _metrics.metrics_enabled():
                        self._counter = _metrics.registry().counter(
                            "rafiki_tpu_fault_injections_total",
                            "Fault-plane injections fired, by site and "
                            "kind")
                    self._counter_known = True
        if self._counter is not None:
            self._counter.inc(site=site, kind=kind)

    def fire(self, site: str, op: str = "", kind: str = "",
             route: str = "") -> Optional[Tuple[str, Any]]:
        """Evaluate one call at ``site``: apply every matching rule that
        is due (sleeps happen here; ``disconnect`` and ``crash`` raise)
        and return the last verdict, ``("drop", None)``, ``("kill",
        None)`` or ``("error", code)``, or None."""
        out: Optional[Tuple[str, Any]] = None
        for rule in self.rules.get(site, ()):
            if not rule.matches(op, kind, route) or not rule.due():
                continue
            self._count_fire(site, rule.kind)
            k = rule.kind
            if k in ("delay", "slow", "timeout"):
                time.sleep(rule.ms() / 1e3)
            elif k == "drop":
                out = ("drop", None)
            elif k == "disconnect":
                raise ConnectionError(
                    f"injected: {site}.disconnect ({op or route})")
            elif k == "crash":
                raise InjectedCrash("injected: worker.crash")
            elif k == "kill":
                # A verdict: the supervise sweep owns the teardown.
                out = ("kill", None)
            elif k == "error":
                out = ("error", int(rule.params.get("code", 503)))
        return out


def should_drop(act: Optional[Tuple[str, Any]], op: str) -> bool:
    """Whether a ``fire`` verdict discards this op: only ``push`` and
    ``push_many`` honour a drop, on every bus backend."""
    return act is not None and act[0] == "drop" and op.startswith("push")


# --- The armed plan and the sites' hooks ---

_state_lock = threading.Lock()
_armed: Optional[FaultPlan] = None
_loaded = False  # the environment was read


class _SiteHook:
    """What a site stores: it consults the plan armed now on every
    call, so ``set_plan`` re-arms sites built earlier."""

    __slots__ = ("site",)

    def __init__(self, site: str):
        self.site = site

    def __call__(self, op: str = "", kind: str = "", route: str = "",
                 ) -> Optional[Tuple[str, Any]]:
        plan = _armed
        if plan is None:
            return None
        return plan.fire(self.site, op=op, kind=kind, route=route)


def _load_env_locked() -> None:
    """Read the plan from the environment once; the caller holds
    ``_state_lock``."""
    global _armed, _loaded
    if _loaded:
        return
    _loaded = True
    text = os.environ.get(PLAN_ENV, "")
    if not text.strip():
        return
    try:
        seed = int(os.environ.get(SEED_ENV, "0") or "0")
    except ValueError:
        seed = 0
    try:
        _armed = FaultPlan.parse(text, seed=seed)
    except ValueError:
        _log.exception("invalid %s; the fault plane stays disarmed",
                       PLAN_ENV)


def site_hook(site: str):
    """A site's hook, resolved when the site is built: None when the
    plane is disarmed (the site then runs as if it had no hook), else a
    hook that follows ``set_plan``."""
    if site not in _KINDS:
        raise ValueError(f"unknown fault site {site!r}")
    with _state_lock:
        _load_env_locked()
        if _armed is None:
            return None
        return _SiteHook(site)


def set_plan(text: Optional[str], seed: int = 0) -> None:
    """Arm a plan (``""``: armed with no rules) or disarm (``None``).
    A malformed plan raises ``ValueError`` and changes nothing."""
    global _armed, _loaded
    plan = None if text is None else FaultPlan.parse(text, seed=seed)
    with _state_lock:
        _loaded = True  # an explicit plan overrides the environment
        _armed = plan


def enabled() -> bool:
    """Whether the plane is armed (maybe with no rules)."""
    with _state_lock:
        _load_env_locked()
        return _armed is not None


def reset() -> None:
    """Forget the plan; the next ``site_hook`` reads the environment
    again."""
    global _armed, _loaded
    with _state_lock:
        _armed = None
        _loaded = False
