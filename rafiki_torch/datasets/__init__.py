"""Synthetic datasets of the port (no network: made from a seed)."""

from .synth import make_synthetic_token_dataset

__all__ = ["make_synthetic_token_dataset"]
