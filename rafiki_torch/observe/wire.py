"""The serving variables the port's inference workers read: the port's
own copy of the two parsers of ``rafiki_tpu/observe/wire.py`` (:50-60,
:107-145) that ensemble serving needs. The reference's wire metrics
series wait for the port of ``observe/metrics``.

- ``RAFIKI_TPU_SERVING_QUANT``: ``""`` (or an off spelling) serves the
  trained dtype, ``"int8"`` serves int8 weights. An unknown spelling
  serves unquantized, with a warning.
- ``RAFIKI_TPU_SERVING_STACKED``: on by default; a multi-member bin of
  congruent members serves as one stacked dispatch a burst. An unknown
  spelling turns it off, with a warning.

Both fail safe rather than raise: a worker's environment is set by
hand, and a typo must degrade to the plain path, not stop every worker.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

_log = logging.getLogger(__name__)

QUANT_ENV = "RAFIKI_TPU_SERVING_QUANT"
STACKED_ENV = "RAFIKI_TPU_SERVING_STACKED"

QUANT_OFF_SPELLINGS = ("", "0", "off", "none", "no", "false")
QUANT_MODES = ("int8",)
STACKED_SPELLINGS = ("", "1", "on", "true", "yes",
                     "0", "off", "false", "no")


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
