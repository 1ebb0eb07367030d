"""State of the AutoML loop: durable metadata (MetaStore) and trial
parameters (ParamStore)."""

from .meta import MetaStore
from .params import ParamStore

__all__ = ["MetaStore", "ParamStore"]
