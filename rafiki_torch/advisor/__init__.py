"""Search strategies of the port, and the advisor service that shares
one search among a job's train workers over the bus.

- ``RandomAdvisor``: uniform sampling.
- ``BayesOptAdvisor``: a Gaussian process and expected improvement over
  the knobs' continuous-box embedding (its own GP on numpy and scipy).
- ``EnasAdvisor``: an LSTM controller trained with REINFORCE, proposing
  ``ArchKnob`` encodings with weight sharing through the ParamStore.

``make_advisor`` picks the strategy from the knob config as the
reference's registry does. The reference's ASHA, PBT and prefetching
advisors are not ported yet (ROADMAP.md, queue 1 item 5).
"""

from .base import BaseAdvisor, Proposal
from .bayes import BayesOptAdvisor
from .enas import EnasAdvisor
from .random_advisor import RandomAdvisor
from .registry import ADVISOR_TYPES, make_advisor

__all__ = ["ADVISOR_TYPES", "BaseAdvisor", "BayesOptAdvisor",
           "EnasAdvisor", "Proposal", "RandomAdvisor", "make_advisor"]
