"""Datasets of the port (no network: made from a seed, converted from
raw files already on disk, shipped inside scikit-learn, or bundled in
the repository)."""

from .prep import prepare_cifar10, prepare_fashion_mnist
from .real import (BUNDLED_POS_CORPUS, prepare_bundled_pos_corpus,
                   prepare_sklearn_digits, prepare_sklearn_tabular)
from .synth import (make_synthetic_corpus_dataset,
                    make_synthetic_image_dataset,
                    make_synthetic_tabular_dataset,
                    make_synthetic_token_dataset)

__all__ = ["BUNDLED_POS_CORPUS", "make_synthetic_corpus_dataset",
           "make_synthetic_image_dataset", "make_synthetic_tabular_dataset",
           "make_synthetic_token_dataset", "prepare_bundled_pos_corpus",
           "prepare_cifar10", "prepare_fashion_mnist",
           "prepare_sklearn_digits", "prepare_sklearn_tabular"]
