"""Model zoo of the port: the flagship language model, the
feed-forward image classifier, DenseNet and the ENAS cell network."""

from .densenet import TorchDenseNet
from .enas import TorchEnas
from .feedforward import TorchFeedForward
from .lm import TorchTransformerLM

__all__ = ["TorchDenseNet", "TorchEnas", "TorchFeedForward",
           "TorchTransformerLM"]
