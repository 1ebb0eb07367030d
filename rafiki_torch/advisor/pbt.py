"""Population-based training: weights and hyperparameters evolved
together.

The port's copy of ``PbtAdvisor`` from ``rafiki_tpu/advisor/pbt.py``
(:36-193). A population of configurations trains in short rounds;
after a round, a member in the bottom quantile of the latest scores
EXPLOITS a top-quantile member (warm-starts from the winner's weights
in the ParamStore) and EXPLORES by perturbing its hyperparameters.

On the platform's trial machinery: one round of one member is one
trial whose budget knob is ``epochs_per_round``; the weights are
inherited through the warm start, retrieving from the source member's
``params_scope`` and saving under the member's own
``params_save_scope`` (the ``TrialRunner`` honours the split); rounds
interleave freely across train workers, exploitation comparing the
latest completed score of each member. The recorded knobs carry the
member's cumulative epochs (``record_knobs``, also the cold-start
fallback), so a trial row is reproducible on its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..constants import ParamsType
from ..model.knobs import (CategoricalKnob, FloatKnob, IntegerKnob,
                           KnobConfig, Knobs)
from .base import BaseAdvisor, Proposal


class PbtAdvisor(BaseAdvisor):
    """Asynchronous PBT; thread-safe like every advisor."""

    def __init__(self, knob_config: KnobConfig, seed: int = 0,
                 total_trials: Optional[int] = None, *,
                 population: int = 4, epochs_per_round: Optional[int] = None,
                 budget_knob: str = "max_epochs",
                 quantile: float = 0.25, perturb: float = 1.2):
        super().__init__(knob_config, seed, total_trials=total_trials)
        self.population = max(2, int(population))
        self.budget_knob = budget_knob
        self.quantile = quantile
        self.perturb = perturb
        knob = knob_config.get(budget_knob)
        if epochs_per_round is None:
            if isinstance(knob, IntegerKnob):
                epochs_per_round = max(1, knob.value_min)
            elif isinstance(knob, CategoricalKnob):
                numeric = sorted(int(v) for v in knob.values
                                 if isinstance(v, (int, float)))
                epochs_per_round = numeric[0] if numeric else 0
            else:
                epochs_per_round = 0  # no tunable budget: plain rounds
        self.epochs_per_round = int(epochs_per_round)
        # Member state: current knobs (budget knob excluded when rounds
        # override it), last completed score, completed round count, and
        # in-flight (unreported) round count per member.
        self._member_knobs: List[Knobs] = []
        self._last_score: Dict[int, float] = {}
        self._rounds_done: Dict[int, int] = {}
        self._inflight: Dict[int, int] = {}
        self._issued = 0
        # trial_no -> (member, retrieve_scope, cumulative_epochs)
        self._pending: Dict[int, Tuple[int, str, int]] = {}

    # --- Strategy hooks (called under the base lock) ---

    def _scope(self, member: int) -> str:
        return f"pbt-{member}"

    def _propose_knobs(self, trial_no: int) -> Knobs:
        member = self._issued % self.population
        self._issued += 1
        if member >= len(self._member_knobs):
            knobs = {name: knob.sample(self.rng)
                     for name, knob in self.knob_config.items()}
            if self.epochs_per_round:
                # Rounds override the budget knob; with no usable
                # budget knob (epochs_per_round == 0) the sampled value
                # stays — every round trains that fixed budget.
                knobs.pop(self.budget_knob, None)
            self._member_knobs.append(knobs)
        retrieve = self._scope(member)

        # Exploit + explore once this member has a completed round,
        # sits in the bottom quantile of the latest scores, and has NO
        # round still in flight (async oversubscription must not
        # compound perturbations off stale scores).
        scored = sorted(self._last_score.items(), key=lambda kv: kv[1])
        if member in self._last_score and len(scored) >= 2 \
                and not self._inflight.get(member):
            k = max(1, int(len(scored) * self.quantile))
            bottom = {m for m, _ in scored[:k]}
            top = [m for m, _ in scored[-k:]]
            if member in bottom:
                winner = top[int(self.rng.integers(len(top)))]
                if winner != member:
                    self._member_knobs[member] = self._explore(
                        dict(self._member_knobs[winner]))
                    retrieve = self._scope(winner)

        knobs = dict(self._member_knobs[member])
        if self.epochs_per_round:
            knobs[self.budget_knob] = self.epochs_per_round
        # Cumulative epochs after this round, counting rounds already
        # in flight (each will add its own epochs before this reports).
        rounds = self._rounds_done.get(member, 0) \
            + self._inflight.get(member, 0) + 1
        self._inflight[member] = self._inflight.get(member, 0) + 1
        self._pending[trial_no] = (member, retrieve,
                                   rounds * self.epochs_per_round)
        return knobs

    def _explore(self, knobs: Knobs) -> Knobs:
        """Perturb continuous knobs; occasionally resample categorical."""
        out = {}
        for name, value in knobs.items():
            knob = self.knob_config.get(name)
            if isinstance(knob, FloatKnob):
                factor = self.perturb if self.rng.random() < 0.5 \
                    else 1.0 / self.perturb
                out[name] = float(min(max(value * factor, knob.value_min),
                                      knob.value_max))
            elif isinstance(knob, IntegerKnob) and name != self.budget_knob:
                factor = self.perturb if self.rng.random() < 0.5 \
                    else 1.0 / self.perturb
                out[name] = int(min(max(round(value * factor),
                                        knob.value_min), knob.value_max))
            elif isinstance(knob, CategoricalKnob) \
                    and self.rng.random() < 0.25:
                out[name] = knob.sample(self.rng)
            else:
                out[name] = value
        return out

    def _params_type(self, trial_no: int) -> str:
        return ParamsType.LOCAL_RECENT

    def _record_budget(self, cumulative: int) -> Optional[int]:
        """The largest legal budget value <= cumulative (clamped: once
        a member has trained past the knob's range, trial rows record
        the knob's maximum rather than silently dropping to the tiny
        per-round delta)."""
        knob = self.knob_config.get(self.budget_knob)
        if isinstance(knob, IntegerKnob):
            return min(max(cumulative, knob.value_min), knob.value_max)
        if isinstance(knob, CategoricalKnob):
            numeric = sorted(int(v) for v in knob.values
                             if isinstance(v, (int, float)))
            below = [v for v in numeric if v <= cumulative]
            return below[-1] if below else (numeric[0] if numeric
                                            else None)
        return None

    def _decorate(self, proposal: Proposal) -> None:
        entry = self._pending.get(proposal.trial_no)
        if entry is None:
            return
        member, retrieve, cumulative = entry
        proposal.meta["params_scope"] = retrieve
        proposal.meta["params_save_scope"] = self._scope(member)
        if self.epochs_per_round:
            total = self._record_budget(cumulative)
            if total is not None:
                # Reproducible budget: cumulative epochs this member
                # will have trained after this round — ALSO the
                # cold-start fallback, so a lost-params round retrains
                # the full cumulative budget instead of silently
                # training one round and recording many.
                proposal.meta["record_knobs"] = {self.budget_knob: total}
                proposal.meta["cold_start_knobs"] = \
                    {self.budget_knob: total}

    def _observe(self, proposal: Proposal, score: float) -> None:
        entry = self._pending.pop(proposal.trial_no, None)
        if entry is None:
            return
        member = entry[0]
        self._last_score[member] = float(score)
        self._rounds_done[member] = self._rounds_done.get(member, 0) + 1
        self._inflight[member] = max(0, self._inflight.get(member, 1) - 1)

    def _forget(self, proposal: Proposal) -> None:
        entry = self._pending.pop(proposal.trial_no, None)
        if entry is not None:
            member = entry[0]
            self._inflight[member] = max(0,
                                         self._inflight.get(member, 1) - 1)
