"""Predictor of the port: the serving frontend over the workers."""

from .app import PredictorService
from .batcher import Backpressure, MicroBatcher
from .edge_cache import EdgeCache, query_key
from .predictor import Predictor, ensemble_predictions

__all__ = ["Backpressure", "EdgeCache", "MicroBatcher", "Predictor",
           "PredictorService", "ensemble_predictions", "query_key"]
