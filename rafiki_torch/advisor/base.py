"""Advisor contract: propose knob assignments, learn from trial scores.

The port's copy of ``Proposal`` and ``BaseAdvisor`` from
``rafiki_tpu/advisor/base.py`` (:24-137): the trial runner calls
``advisor.propose()`` before each trial and ``advisor.feedback(...)``
after. The port has no bus yet, so the runner holds the advisor in
process.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..constants import ParamsType
from ..model.knobs import KnobConfig, Knobs, PolicyKnob


@dataclass
class Proposal:
    """One concrete trial request handed to a TrainWorker.

    ``params_type`` tells the worker which shared parameters to warm-start
    from (ParamStore sharing policy; ENAS weight sharing uses
    ``GLOBAL_RECENT``). ``meta`` carries advisor-internal bookkeeping that
    must round-trip through ``feedback`` (e.g. the controller's log-probs
    index for REINFORCE).
    """

    trial_no: int
    knobs: Knobs
    params_type: str = ParamsType.NONE
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"trial_no": self.trial_no, "knobs": self.knobs,
                "params_type": self.params_type, "meta": self.meta}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Proposal":
        return Proposal(trial_no=int(d["trial_no"]), knobs=d["knobs"],
                        params_type=d.get("params_type", ParamsType.NONE),
                        meta=d.get("meta", {}))


class BaseAdvisor:
    """Base search strategy. Thread-safe: one advisor serves many workers."""

    def __init__(self, knob_config: KnobConfig, seed: int = 0,
                 total_trials: Optional[int] = None):
        self.knob_config = knob_config
        self.rng = np.random.default_rng(seed)
        # Proposal-issuance cap: the advisor is the single coordinator for
        # many workers, so enforcing MODEL_TRIAL_COUNT here (not in each
        # worker's loop) is what keeps N parallel workers from racing past
        # the budget. forget() refunds a slot so errored trials re-propose.
        self.total_trials = total_trials
        self._forgotten = 0
        self._lock = threading.RLock()
        self._trial_no = 0
        self._history: List[Tuple[Knobs, float]] = []
        self._best: Optional[Tuple[Knobs, float]] = None

    # --- Public API (TrainWorker-facing) ---

    def propose(self) -> Optional[Proposal]:
        with self._lock:
            if self.total_trials is not None and \
                    self._trial_no - self._forgotten >= self.total_trials:
                return None
            self._trial_no += 1
            knobs = self._propose_knobs(self._trial_no)
            knobs = self._fill_policies(knobs, self._trial_no)
            proposal = Proposal(trial_no=self._trial_no, knobs=knobs,
                                params_type=self._params_type(
                                    self._trial_no))
            self._decorate(proposal)
            return proposal

    def feedback(self, proposal: Proposal, score: float) -> None:
        with self._lock:
            # ``record_knobs``: a strategy may execute reduced knobs
            # (PBT trains one round on inherited weights) while the
            # reproducible configuration — what best() must hand back —
            # carries the cumulative values.
            knobs = {**proposal.knobs,
                     **(proposal.meta.get("record_knobs") or {})}
            self._history.append((knobs, float(score)))
            if self._best is None or score > self._best[1]:
                self._best = (dict(knobs), float(score))
            self._observe(proposal, float(score))

    def forget(self, proposal: Proposal) -> None:
        """Discard a proposal whose trial will never report a score
        (errored/abandoned): refunds its budget slot and releases any
        per-proposal state."""
        with self._lock:
            self._forgotten += 1
            self._forget(proposal)

    def best(self) -> Optional[Tuple[Knobs, float]]:
        with self._lock:
            return self._best

    @property
    def n_trials(self) -> int:
        with self._lock:
            return len(self._history)

    # --- Strategy hooks ---

    def _propose_knobs(self, trial_no: int) -> Knobs:
        raise NotImplementedError

    def _observe(self, proposal: Proposal, score: float) -> None:
        """Incorporate one result; called under the lock."""

    def _forget(self, proposal: Proposal) -> None:
        """Release per-proposal state; called under the lock."""

    def _params_type(self, trial_no: int) -> str:
        return ParamsType.NONE

    def _decorate(self, proposal: Proposal) -> None:
        """Attach strategy metadata to an outgoing proposal (e.g. a
        ``params_scope`` for scoped warm-starts); called under the lock."""

    def _fill_policies(self, knobs: Knobs, trial_no: int) -> Knobs:
        """Default policy activation: all off. Strategies override."""
        for name, knob in self.knob_config.items():
            if isinstance(knob, PolicyKnob) and name not in knobs:
                knobs[name] = False
        return knobs
