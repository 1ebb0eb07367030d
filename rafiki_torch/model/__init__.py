"""Model SDK of the port: knobs, the BaseModel contract, token datasets."""

from .base import BaseModel, Params, params_size_bytes
from .knobs import (ArchKnob, BaseKnob, CategoricalKnob, FixedKnob,
                    FloatKnob, IntegerKnob, PolicyKnob)

__all__ = ["ArchKnob", "BaseKnob", "BaseModel", "CategoricalKnob",
           "FixedKnob", "FloatKnob", "IntegerKnob", "Params",
           "PolicyKnob", "params_size_bytes"]
