"""Workers of the port: the serving data plane and the trial loop."""

from .inference import InferenceWorker
from .runner import BudgetTracker, TrialRunner

__all__ = ["BudgetTracker", "InferenceWorker", "TrialRunner"]
