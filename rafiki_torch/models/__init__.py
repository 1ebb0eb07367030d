"""Model zoo of the port: the flagship language model, the image
classifiers (feed-forward, DenseNet, ENAS, the VGG-style CNN, ViT), the
corpus taggers (BiLSTM, transformer), the tabular MLPs and the sklearn
family (``SkDt``, ``SkSvm``; sklearn is imported only when one builds
its estimator)."""

from .cnn import TorchCnn
from .densenet import TorchDenseNet
from .enas import TorchEnas
from .feedforward import TorchFeedForward
from .lm import TorchTransformerLM
from .pos_tagger import TorchPosTagger
from .sk import SkDt, SkSvm
from .tabular import TorchTabMlpClf, TorchTabMlpReg
from .transformer import TorchTransformerTagger
from .vit import TorchViT

__all__ = ["SkDt", "SkSvm", "TorchCnn", "TorchDenseNet", "TorchEnas",
           "TorchFeedForward", "TorchPosTagger", "TorchTabMlpClf",
           "TorchTabMlpReg", "TorchTransformerLM", "TorchTransformerTagger",
           "TorchViT"]
