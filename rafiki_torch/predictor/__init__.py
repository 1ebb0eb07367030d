"""Predictor of the port: the serving frontend over the workers."""

from .app import PredictorService
from .predictor import Predictor, ensemble_predictions

__all__ = ["Predictor", "PredictorService", "ensemble_predictions"]
