"""Search strategies of the port, and the advisor service that shares
one search among a job's train workers over the bus.

- ``RandomAdvisor``: uniform sampling.
- ``BayesOptAdvisor``: a Gaussian process and expected improvement over
  the knobs' continuous-box embedding (its own GP on numpy and scipy).
- ``EnasAdvisor``: an LSTM controller trained with REINFORCE, proposing
  ``ArchKnob`` encodings with weight sharing through the ParamStore.
- ``AshaAdvisor``: asynchronous successive halving over the model's
  epoch-budget knob, promotions resuming their configuration's
  checkpoint (``advisor_type="asha"``).
- ``PbtAdvisor``: population-based training, rounds of short trials
  with weight inheritance through the ParamStore and hyperparameters
  exploited and explored between rounds (``advisor_type="pbt"``).
- ``PrefetchAdvisor``: wraps any of them and computes the next proposal
  while the current trial trains (the train worker's default).

``make_advisor`` picks the strategy from the knob config as the
reference's registry does.
"""

from .asha import AshaAdvisor
from .base import BaseAdvisor, Proposal
from .bayes import BayesOptAdvisor
from .enas import EnasAdvisor
from .pbt import PbtAdvisor
from .prefetch import PrefetchAdvisor
from .random_advisor import RandomAdvisor
from .registry import ADVISOR_TYPES, make_advisor

__all__ = ["ADVISOR_TYPES", "AshaAdvisor", "BaseAdvisor",
           "BayesOptAdvisor", "EnasAdvisor", "PbtAdvisor",
           "PrefetchAdvisor", "Proposal", "RandomAdvisor", "make_advisor"]
