"""ASHA: asynchronous successive halving over an epoch-budget knob.

The port's copy of ``_budget_ladder`` and ``AshaAdvisor`` from
``rafiki_tpu/advisor/asha.py`` (:34-176). New configurations start at
the smallest rung's epoch budget; one that places in the top 1/eta of
its rung is promoted, as soon as that is justified, to the next rung,
eta times the budget. The budget rides the model's own ``max_epochs``
knob (an ``IntegerKnob`` range or a ``CategoricalKnob``'s sorted
numeric values).

A promotion proposes the FULL cumulative rung budget and warm-starts by
checkpoint resume: every trial of a configuration shares a
``ckpt_scope`` (``asha-cfg-<id>``), under which the ``TrialRunner``
keeps the configuration's final train state after each rung, so the
model's resume trains only the epochs past the previous rung, at their
true indices. Every rung sizes its lr schedule to the ladder's top
(``schedule_total_epochs``), which makes a chain of rungs step for step
one uninterrupted run. Where the checkpoint is gone the trial trains its
whole budget from scratch, so scores stay comparable across rungs.
With no tunable budget knob the strategy is random search at a fixed
budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..constants import ParamsType
from ..model.knobs import CategoricalKnob, IntegerKnob, KnobConfig, Knobs
from .base import BaseAdvisor, Proposal


def _budget_ladder(knob, eta: int) -> List[int]:
    """Geometric rung budgets within the knob's legal values."""
    if isinstance(knob, IntegerKnob):
        # A zero/negative floor would make the geometric ladder never
        # grow; the smallest meaningful epoch budget is 1.
        lo, hi = max(1, knob.value_min), knob.value_max
        if lo >= hi:
            return [lo]
        ladder = [lo]
        while ladder[-1] < hi:
            ladder.append(min(ladder[-1] * eta, hi))
        return ladder
    if isinstance(knob, CategoricalKnob):
        numeric = sorted({int(v) for v in knob.values
                          if isinstance(v, (int, float))})
        if not numeric:
            return []
        # Subsample the sorted values geometrically: always keep the
        # smallest and largest, and only values >= eta x the previous rung.
        ladder = [numeric[0]]
        for v in numeric[1:]:
            if v >= ladder[-1] * eta or v == numeric[-1]:
                ladder.append(v)
        return ladder
    return []


class AshaAdvisor(BaseAdvisor):
    """Asynchronous successive halving; thread-safe like every advisor."""

    def __init__(self, knob_config: KnobConfig, seed: int = 0,
                 total_trials: Optional[int] = None, *, eta: int = 3,
                 budget_knob: str = "max_epochs"):
        super().__init__(knob_config, seed, total_trials=total_trials)
        self.eta = max(2, int(eta))
        self.budget_knob = budget_knob
        self._ladder = _budget_ladder(knob_config.get(budget_knob),
                                      self.eta)
        n_rungs = max(1, len(self._ladder))
        # Per rung: best score seen per configuration id.
        self._rung_scores: List[Dict[int, float]] = [
            {} for _ in range(n_rungs)]
        self._promoted: List[Set[int]] = [set() for _ in range(n_rungs)]
        self._configs: Dict[int, Knobs] = {}
        self._next_config = 0
        # trial_no -> (config_id, rung); popped by _observe/_forget.
        self._pending: Dict[int, Tuple[int, int]] = {}

    # --- Strategy hooks (called under the base lock) ---

    def _propose_knobs(self, trial_no: int) -> Knobs:
        promo = self._find_promotion()
        if promo is not None:
            cid, rung = promo
            knobs = dict(self._configs[cid])
            # The FULL cumulative rung budget — checkpoint resume (the
            # shared ckpt_scope set in _decorate) makes only the delta
            # epochs execute, at their true epoch indices. The proposed
            # knobs are therefore also the reproducible record.
            knobs[self.budget_knob] = self._ladder[rung]
            self._pending[trial_no] = (cid, rung)
            return knobs
        # New configuration at rung 0.
        knobs = {name: knob.sample(self.rng)
                 for name, knob in self.knob_config.items()}
        cid = self._next_config
        self._next_config += 1
        base = dict(knobs)
        base.pop(self.budget_knob, None)
        self._configs[cid] = base
        if self._ladder:
            knobs[self.budget_knob] = self._ladder[0]
        self._pending[trial_no] = (cid, 0)
        return knobs

    def _find_promotion(self) -> Optional[Tuple[int, int]]:
        """Highest-rung promotable configuration, or None."""
        for rung in reversed(range(len(self._ladder) - 1)):
            scores = self._rung_scores[rung]
            k = len(scores) // self.eta
            if k == 0:
                continue
            top = sorted(scores.items(), key=lambda kv: -kv[1])[:k]
            for cid, _ in top:
                if cid not in self._promoted[rung]:
                    self._promoted[rung].add(cid)
                    return cid, rung + 1
        return None

    def _params_type(self, trial_no: int) -> str:
        # The warm start is the checkpoint (ckpt_scope below), not
        # ParamStore retrieval: the checkpoint carries the FULL train
        # state (optimizer moments, early-stop counters), which dumped
        # inference params cannot. Rung-0 trials and checkpoint-less
        # promotions alike start fresh and train their full budget.
        return ParamsType.NONE

    def _decorate(self, proposal: Proposal) -> None:
        entry = self._pending.get(proposal.trial_no)
        if entry is None or len(self._ladder) < 2:
            # No ladder (degenerate random search) or a single rung:
            # nothing will ever be promoted/resumed, so don't tax every
            # trial with per-epoch checkpointing it cannot use.
            return
        cid = entry[0]
        # Every trial of one configuration shares a checkpoint scope:
        # rung r leaves its final state on disk
        # (checkpoint_final_epoch, set by the TrialRunner for scoped
        # proposals) and rung r+1 resumes it. Scoped params keep each
        # configuration's dumped-weights lineage separate as well.
        proposal.meta["ckpt_scope"] = f"asha-cfg-{cid}"
        proposal.meta["params_scope"] = f"asha-cfg-{cid}"
        # One schedule shape for the whole ladder: every rung sizes
        # its lr schedule to the TOP budget, so a resumed rung
        # continues the exact schedule an uninterrupted full-budget
        # run would be on.
        proposal.meta["train_kwargs"] = {
            "schedule_total_epochs": self._ladder[-1]}

    def _observe(self, proposal: Proposal, score: float) -> None:
        entry = self._pending.pop(proposal.trial_no, None)
        if entry is None:
            return
        cid, rung = entry
        prev = self._rung_scores[rung].get(cid)
        if prev is None or score > prev:
            self._rung_scores[rung][cid] = float(score)

    def _forget(self, proposal: Proposal) -> None:
        entry = self._pending.pop(proposal.trial_no, None)
        if entry is None:
            return
        cid, rung = entry
        # A promotion that never reported stays eligible for re-issue.
        if rung > 0:
            self._promoted[rung - 1].discard(cid)
