"""Model zoo of the port (so far the flagship language model)."""

from .lm import TorchTransformerLM

__all__ = ["TorchTransformerLM"]
