"""Trial-lifecycle phase metrics, in the metrics registry.

The port's copy of ``rafiki_tpu/observe/phases.py``. The trial loop
(propose -> load -> stage -> train -> eval -> persist) is where a
train job's trials/hour goes; these series break it down:

- ``rafiki_tpu_trial_phase_seconds{phase=}``: wall time a phase.
  ``propose``, ``train``, ``eval`` and ``persist`` are recorded by
  ``TrialRunner`` around each step of the trial; ``load`` (the dataset
  read from disk) and ``stage`` (the whole set copied to the device)
  are recorded inside ``TorchModel.train`` and ``evaluate``, so they
  are parts of ``train`` and ``eval``, not added to them.
- ``rafiki_tpu_trial_dataset_cache_total{event=hit|miss|evict}`` and
  ``rafiki_tpu_trial_stage_cache_total{event=hit|miss|evict}``, with
  ``rafiki_tpu_trial_dataset_cache_bytes`` and
  ``rafiki_tpu_trial_stage_cache_bytes``: the host dataset cache and
  the device staging cache (``model/dataset.py`` and
  ``model/torch_model.py``). A sub-train job's trials 2..N show as
  misses staying flat while hits grow.

Stdlib only. Labels are bounded (phase names, cache events), never a
trial's, so the series need no clean-up and sum over a whole window.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import metrics

PHASES = ("propose", "load", "stage", "train", "eval", "persist")

#: Trial phases span four orders of magnitude more than a bus push:
#: a warm load/stage is sub-millisecond, a real train phase minutes.
PHASE_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                 10.0, 30.0, 60.0, 300.0, 1800.0)

_m: Optional[Dict[str, object]] = None


def _reg() -> Dict[str, object]:
    global _m
    if _m is None:
        r = metrics.registry()
        _m = {
            "phase": r.histogram(
                "rafiki_tpu_trial_phase_seconds",
                "Wall time of one trial-lifecycle phase (phase="
                "propose|load|stage|train|eval|persist; load/stage are "
                "sub-spans of train/eval)", buckets=PHASE_BUCKETS),
            "dataset_cache": r.counter(
                "rafiki_tpu_trial_dataset_cache_total",
                "Host dataset cache events (event=hit|miss|evict)"),
            "stage_cache": r.counter(
                "rafiki_tpu_trial_stage_cache_total",
                "Device staging cache events (event=hit|miss|evict)"),
            "dataset_cache_bytes": r.gauge(
                "rafiki_tpu_trial_dataset_cache_bytes",
                "Bytes held by the host dataset cache"),
            "stage_cache_bytes": r.gauge(
                "rafiki_tpu_trial_stage_cache_bytes",
                "Bytes held by the device staging cache"),
        }
    return _m


def observe_phase(phase: str, seconds: float) -> None:
    """Record one phase duration. Always-on cheap (one histogram
    observe); ``RAFIKI_TPU_METRICS=0`` disables it wholesale."""
    if metrics.metrics_enabled():
        # rta: disable=RTA301 phase is drawn from the fixed PHASES tuple; deliberately immortal (module docstring)
        _reg()["phase"].observe(seconds, phase=phase)


def cache_event(cache: str, event: str, n: int = 1) -> None:
    """``cache`` is ``"dataset"`` or ``"stage"``; ``event`` one of
    hit/miss/evict."""
    if metrics.metrics_enabled():
        # rta: disable=RTA301 event is hit|miss|evict; deliberately immortal (module docstring)
        _reg()[f"{cache}_cache"].inc(n, event=event)


def set_cache_bytes(cache: str, n_bytes: int) -> None:
    if metrics.metrics_enabled():
        _reg()[f"{cache}_cache_bytes"].set(n_bytes)


def cache_counts(cache: str) -> Dict[str, int]:
    """Current {event: count} for one cache family."""
    m = _reg()[f"{cache}_cache"]
    return {labels.get("event", ""): int(v) for labels, v in m.samples()}


def phase_totals() -> Dict[str, Dict[str, float]]:
    """{phase: {"sum": seconds, "count": n}}: two snapshots' difference
    is the breakdown of the trials between them."""
    h = _reg()["phase"]
    return {p: {"sum": h.sum(phase=p), "count": h.count(phase=p)}
            for p in PHASES}
