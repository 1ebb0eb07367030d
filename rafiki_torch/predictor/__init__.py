"""Predictor of the port: the serving frontend over the workers."""

from .app import PredictorService
from .predictor import ensemble_predictions

__all__ = ["PredictorService", "ensemble_predictions"]
