"""State of the AutoML loop: durable metadata (MetaStore), trial
parameters (ParamStore) and mid-trial checkpoints (CheckpointManager)."""

from .checkpoint import CheckpointManager
from .meta import MetaStore
from .params import ParamStore

__all__ = ["MetaStore", "ParamStore", "CheckpointManager"]
