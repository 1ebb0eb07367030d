"""Search strategies of the port. The registry and the ASHA, Bayes, PBT
and ENAS advisors are not ported yet."""

from .base import BaseAdvisor, Proposal
from .random_advisor import RandomAdvisor

__all__ = ["BaseAdvisor", "Proposal", "RandomAdvisor"]
