"""Search strategies of the port, and the advisor service that shares
one search among a job's train workers over the bus.

``make_advisor`` builds the strategy of a sub-train-job. The port has
only ``RandomAdvisor``: the reference's ASHA, Bayes, PBT and ENAS
advisors raise ``NotImplementedError`` until they are ported (ROADMAP,
queue 1).
"""

from typing import Optional

from ..model.knobs import ArchKnob, KnobConfig
from .base import BaseAdvisor, Proposal
from .random_advisor import RandomAdvisor

__all__ = ["BaseAdvisor", "Proposal", "RandomAdvisor", "make_advisor"]

#: The reference's advisor types (``rafiki_tpu/advisor/registry.py``)
#: that the port does not have yet.
NOT_PORTED = ("asha", "bayes", "enas", "pbt")


def make_advisor(knob_config: KnobConfig, seed: int = 0,
                 advisor_type: Optional[str] = None,
                 total_trials: Optional[int] = None) -> BaseAdvisor:
    """The strategy for one search. ``advisor_type`` ``"random"`` or
    None builds ``RandomAdvisor``. Where the reference, given no type,
    picks ENAS for a knob space with an ``ArchKnob`` and Bayes for one
    with searchable dimensions, the port searches at random; an
    ``ArchKnob`` space, which only ENAS can search, raises."""
    if advisor_type in NOT_PORTED or (
            advisor_type is None
            and any(isinstance(k, ArchKnob) for k in knob_config.values())):
        raise NotImplementedError(
            f"advisor {advisor_type or 'enas'!r} is not ported yet "
            "(ROADMAP.md, queue 1); use 'random'")
    if advisor_type not in (None, "random"):
        raise ValueError(f"Unknown advisor type: {advisor_type!r}; one of "
                         f"{sorted(NOT_PORTED + ('random',))}")
    return RandomAdvisor(knob_config, seed, total_trials=total_trials)
