"""Datasets of the port (no network: made from a seed, or shipped
inside scikit-learn)."""

from .real import prepare_sklearn_digits
from .synth import (make_synthetic_corpus_dataset,
                    make_synthetic_image_dataset,
                    make_synthetic_tabular_dataset,
                    make_synthetic_token_dataset)

__all__ = ["make_synthetic_corpus_dataset", "make_synthetic_image_dataset",
           "make_synthetic_tabular_dataset", "make_synthetic_token_dataset",
           "prepare_sklearn_digits"]
