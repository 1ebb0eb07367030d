"""The serving switches, and the serving wire series: the port's copy of
``rafiki_tpu/observe/wire.py``.

- ``RAFIKI_TPU_SERVING_PACKED_WIRE`` (``NodeConfig.serving_packed_wire``,
  ``packed_wire_mode``): ``on`` (the default) packs a shard of
  same-shape arrays into one ``__ndbatch__`` frame toward a worker that
  advertises ``ndbatch1``, and lets a query frame ask for a packed reply
  (``rw``); ``off`` sends the per-query frames only, advertises nothing
  and registers no wire series; ``compat`` sends the per-query frames
  but keeps the series. The cache, the predictor and the inference
  worker each read it once, when they are built. An unknown spelling
  fails safe to ``compat``, with a warning: a mistyped rollback must
  not leave the packed wire on.
- ``RAFIKI_TPU_SERVING_QUANT``: ``""`` (or an off spelling) serves the
  trained dtype, ``"int8"`` serves int8 weights. An unknown spelling
  serves unquantized, with a warning.
- ``RAFIKI_TPU_SERVING_STACKED``: on by default; a multi-member bin of
  congruent members serves as one stacked dispatch a burst. An unknown
  spelling turns it off, with a warning.

Each fails safe rather than raising: a worker's environment is set by
hand, and a typo must degrade to the plain path, not stop every worker.
``NodeConfig.validate`` refuses a spelling outside the vocabularies
below (``known_*_spelling``).

The series, each registered on first use and only while metrics are on
(a process that never serves a kind registers none of its series); the
wire series also only while the packed wire is not ``off``:

- ``rafiki_tpu_serving_wire_bytes_total{format=packed|perquery,
  direction=scatter|reply}``: estimated payload bytes at every send;
- ``rafiki_tpu_serving_host_copies_total{site=encode|decode|assemble}``:
  host copies of query tensors on the serving path;
- ``rafiki_tpu_serving_quant_total{mode}``: queries a quantised model
  served;
- ``rafiki_tpu_serving_stacked_dispatch_total{mode=stacked|fallback}``
  and ``rafiki_tpu_serving_dispatches_per_query_ratio``: the device
  dispatches of a stacked-capable worker's bursts (registered only with
  ``RAFIKI_TPU_SERVING_STACKED`` on).

Their labels are fixed vocabularies, so the series live as long as the
process.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Tuple

from . import metrics as _metrics

_log = logging.getLogger(__name__)

PACKED_WIRE_ENV = "RAFIKI_TPU_SERVING_PACKED_WIRE"
QUANT_ENV = "RAFIKI_TPU_SERVING_QUANT"
STACKED_ENV = "RAFIKI_TPU_SERVING_STACKED"

PACKED_WIRE_SPELLINGS = ("", "1", "on", "true", "yes",
                         "0", "off", "false", "no", "compat")
QUANT_OFF_SPELLINGS = ("", "0", "off", "none", "no", "false")
QUANT_MODES = ("int8",)
STACKED_SPELLINGS = ("", "1", "on", "true", "yes",
                     "0", "off", "false", "no")


def known_packed_wire_spelling(raw: str) -> bool:
    return raw.strip().lower() in PACKED_WIRE_SPELLINGS


def known_quant_spelling(raw: str) -> bool:
    return raw.strip().lower() in QUANT_OFF_SPELLINGS + QUANT_MODES


def known_stacked_spelling(raw: str) -> bool:
    return raw.strip().lower() in STACKED_SPELLINGS


def packed_wire_mode(raw: Optional[str] = None) -> str:
    """``"on"``, ``"off"`` or ``"compat"``, from ``raw`` or the
    environment (default on); an unknown spelling is ``"compat"``."""
    if raw is None:
        raw = os.environ.get(PACKED_WIRE_ENV, "on")
    raw = raw.strip().lower()
    if raw == "compat":
        return "compat"
    if raw in ("0", "false", "no", "off"):
        return "off"
    if raw in PACKED_WIRE_SPELLINGS:
        return "on"
    _log.warning("%s=%r is not one of on/off/compat; failing safe to "
                 "'compat' (legacy frames, wire metrics kept)",
                 PACKED_WIRE_ENV, raw)
    return "compat"


def quant_mode(raw: Optional[str] = None) -> str:
    """``""`` (off) or a member of ``QUANT_MODES``, from ``raw`` or the
    environment."""
    if raw is None:
        raw = os.environ.get(QUANT_ENV, "")
    raw = raw.strip().lower()
    if raw in QUANT_OFF_SPELLINGS:
        return ""
    if raw in QUANT_MODES:
        return raw
    _log.warning("%s=%r is not one of %s; failing safe to unquantized "
                 "serving", QUANT_ENV, raw, ("",) + QUANT_MODES)
    return ""


def stacked_mode(raw: Optional[str] = None) -> bool:
    """Whether stacked-ensemble serving is asked for, from ``raw`` or
    the environment (default on)."""
    if raw is None:
        raw = os.environ.get(STACKED_ENV, "on")
    raw = raw.strip().lower()
    if raw in ("0", "off", "false", "no"):
        return False
    if raw in STACKED_SPELLINGS:
        return True
    _log.warning("%s=%r is not one of on/off; failing safe to per-member "
                 "serving", STACKED_ENV, raw)
    return False


#: (wire bytes counter, host copies counter), or (None, None) with
#: metrics or the packed wire off; resolved on first use.
_state: Optional[Tuple] = None
_quant_counter = None
#: (dispatch counter, dispatches-per-query gauge), or (None, None).
_stacked_state: Optional[Tuple] = None
_lock = threading.Lock()


def _counters() -> Tuple:
    global _state
    # rta: disable=RTA101 double-checked init: the bare read is the fast path; the write re-checks under _lock
    s = _state
    if s is None:
        with _lock:
            s = _state
            if s is None:
                if packed_wire_mode() != "off" \
                        and _metrics.metrics_enabled():
                    reg = _metrics.registry()
                    s = (
                        reg.counter(
                            "rafiki_tpu_serving_wire_bytes_total",
                            "Estimated serialized serving payload "
                            "bytes (format=packed|perquery, "
                            "direction=scatter|reply)"),
                        reg.counter(
                            "rafiki_tpu_serving_host_copies_total",
                            "Per-tensor host copies on the serving "
                            "path (site=encode|decode|stack|pad|"
                            "assemble)"),
                    )
                else:
                    s = (None, None)
                _state = s
    return s


def counting() -> bool:
    """Whether the wire series are live: a caller that must compute a
    byte estimate asks first."""
    return _counters()[0] is not None


def count_bytes(fmt: str, direction: str, nbytes: int) -> None:
    c = _counters()[0]
    if c is not None and nbytes > 0:
        # rta: disable=RTA301 format/direction are a 2x2 fixed vocabulary (packed|perquery x scatter|reply); the family is process-global and deliberately immortal
        c.inc(nbytes, format=fmt, direction=direction)


def count_copies(site: str, n: int = 1) -> None:
    c = _counters()[1]
    if c is not None and n > 0:
        # rta: disable=RTA301 site is the fixed encode|decode|stack|pad|assemble vocabulary; process-global family, deliberately immortal
        c.inc(n, site=site)


def count_quant(n: int, mode: str) -> None:
    """Queries served by a quantised model."""
    global _quant_counter
    if n <= 0 or not mode:
        return
    # rta: disable=RTA101 double-checked init: the bare read is the fast path; the write re-checks under _lock
    c = _quant_counter
    if c is None:
        with _lock:
            c = _quant_counter
            if c is None:
                if not _metrics.metrics_enabled():
                    return
                c = _metrics.registry().counter(
                    "rafiki_tpu_serving_quant_total",
                    "Queries served by a quantized ensemble model "
                    "(mode=int8)")
                _quant_counter = c
    # rta: disable=RTA301 mode is the fixed quant vocabulary (int8); registered only while quantized serving is live, deliberately immortal
    c.inc(n, mode=mode)


def _stacked_counters() -> Tuple:
    global _stacked_state
    # rta: disable=RTA101 double-checked init: the bare read is the fast path; the write re-checks under _lock
    s = _stacked_state
    if s is None:
        with _lock:
            s = _stacked_state
            if s is None:
                if stacked_mode() and _metrics.metrics_enabled():
                    reg = _metrics.registry()
                    s = (
                        reg.counter(
                            "rafiki_tpu_serving_stacked_dispatch_total",
                            "Ensemble-burst device dispatches on a "
                            "stacked-capable worker (mode=stacked: one "
                            "vmapped program served the whole member "
                            "group; mode=fallback: per-member "
                            "dispatches of a burst that could not ride "
                            "the stacked program)"),
                        reg.gauge(
                            "rafiki_tpu_serving_dispatches_per_query_ratio",
                            "Device dispatches per served query of the "
                            "last ensemble burst (stacked mode: "
                            "1/queries; per-member fallback: "
                            "members/queries)"),
                    )
                else:
                    s = (None, None)
                _stacked_state = s
    return s


def count_stacked_dispatch(mode: str, n: int = 1) -> None:
    """``stacked``: one dispatch served the member group; ``fallback``:
    the member-by-member dispatches of a stacked-capable worker."""
    c = _stacked_counters()[0]
    if c is not None and n > 0:
        c.inc(n, mode=mode)


def observe_dispatches_per_query(dispatches: int, queries: int) -> None:
    g = _stacked_counters()[1]
    if g is not None and queries > 0:
        g.set(dispatches / queries)


def reset_for_tests() -> None:
    """Forget the resolved series, so a test that flips
    ``RAFIKI_TPU_METRICS``, ``RAFIKI_TPU_SERVING_PACKED_WIRE`` or
    ``RAFIKI_TPU_SERVING_STACKED`` sees it."""
    global _state, _quant_counter, _stacked_state
    with _lock:
        _state = None
        _quant_counter = None
        _stacked_state = None
