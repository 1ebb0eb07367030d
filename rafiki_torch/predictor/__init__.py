"""Predictor of the port: the serving frontend over the workers."""

from .app import PredictorService
from .batcher import Backpressure, MicroBatcher
from .predictor import Predictor, ensemble_predictions

__all__ = ["Backpressure", "MicroBatcher", "Predictor", "PredictorService",
           "ensemble_predictions"]
