"""Workers of the port: the serving data plane."""

from .inference import InferenceWorker

__all__ = ["InferenceWorker"]
