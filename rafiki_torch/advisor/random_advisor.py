"""Uniform-random search strategy.

The port's copy of ``RandomAdvisor`` from
``rafiki_tpu/advisor/random_advisor.py``: knobs are drawn with the
advisor's numpy generator, so a seed proposes the same knobs in both
packages.
"""

from __future__ import annotations

from ..model.knobs import Knobs, sample_knobs
from .base import BaseAdvisor


class RandomAdvisor(BaseAdvisor):
    def _propose_knobs(self, trial_no: int) -> Knobs:
        return sample_knobs(self.knob_config, self.rng)
