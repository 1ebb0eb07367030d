"""Advisor factory: pick a strategy from the knob config.

The port of ``rafiki_tpu/advisor/registry.py`` (:21-42): a type given
by name (``"random"``, ``"bayes"``, ``"enas"``, ``"asha"``, ``"pbt"``)
is built; given no type, an ``ArchKnob`` space gets the ENAS
controller, a space with searchable dimensions the Bayesian GP,
anything else random search (never ASHA or PBT unless asked for).
"""

from __future__ import annotations

from typing import Optional

from ..model.knobs import ArchKnob, KnobConfig, searchable_dims
from ..torchenv import DeviceLike
from .asha import AshaAdvisor
from .base import BaseAdvisor
from .bayes import BayesOptAdvisor
from .enas import EnasAdvisor
from .pbt import PbtAdvisor
from .random_advisor import RandomAdvisor

ADVISOR_TYPES = {
    "random": RandomAdvisor,
    "bayes": BayesOptAdvisor,
    "enas": EnasAdvisor,
    "asha": AshaAdvisor,
    "pbt": PbtAdvisor,
}


def make_advisor(knob_config: KnobConfig, seed: int = 0,
                 advisor_type: Optional[str] = None,
                 total_trials: Optional[int] = None,
                 device: DeviceLike = None) -> BaseAdvisor:
    """The strategy for one search. ``device`` is where the ENAS
    controller runs (the card unless the caller asks for the CPU)."""
    if advisor_type is None:
        if any(isinstance(k, ArchKnob) for k in knob_config.values()):
            advisor_type = "enas"
        elif searchable_dims(knob_config) > 0:
            advisor_type = "bayes"
        else:
            advisor_type = "random"
    cls = ADVISOR_TYPES.get(advisor_type)
    if cls is None:
        raise ValueError(f"Unknown advisor type: {advisor_type!r}; one of "
                         f"{sorted(ADVISOR_TYPES)}")
    if cls is EnasAdvisor:
        return cls(knob_config, seed, total_trials=total_trials,
                   device=device)
    return cls(knob_config, seed, total_trials=total_trials)
