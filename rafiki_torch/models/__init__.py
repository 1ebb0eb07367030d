"""Model zoo of the port: the flagship language model and the
feed-forward image classifier."""

from .feedforward import TorchFeedForward
from .lm import TorchTransformerLM

__all__ = ["TorchFeedForward", "TorchTransformerLM"]
