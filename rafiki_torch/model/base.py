"""The BaseModel contract every platform model implements.

Parity: SURVEY.md §2 "Model SDK — BaseModel" (upstream
``rafiki/model/model.py``): ``get_knob_config()`` (static),
``__init__(**knobs)``, ``train(dataset_path)``, ``evaluate(dataset_path)``,
``predict(queries)``, ``dump_parameters()``, ``load_parameters()``.

Parameters are a flat ``dict[str, np.ndarray]`` — the canonical
interchange format between trials, the param store, and inference
workers. The port keeps the reference package's contract and key names,
so a parameter dict dumped by either package loads into the other.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional

import numpy as np

from .knobs import KnobConfig, Knobs, validate_knobs

Params = Dict[str, np.ndarray]


class BaseModel(abc.ABC):
    """Base class for all trainable/servable models on the platform.

    Subclasses declare their hyperparameter search space via
    ``get_knob_config()`` and receive one concrete assignment per trial as
    ``__init__`` keyword arguments.
    """

    def __init__(self, **knobs: Any):
        self.knobs: Knobs = knobs

    # --- Contract ---

    @staticmethod
    @abc.abstractmethod
    def get_knob_config() -> KnobConfig:
        """The model's searchable hyperparameter declarations."""

    @abc.abstractmethod
    def train(self, dataset_path: str, *,
              shared_params: Optional[Params] = None, **kwargs: Any) -> None:
        """Train on the dataset at ``dataset_path``.

        ``shared_params``, when given, are warm-start parameters fetched
        from the ParamStore according to the trial proposal's
        ``ParamsType`` (ENAS-style weight sharing).
        """

    @abc.abstractmethod
    def evaluate(self, dataset_path: str) -> float:
        """Return a scalar score on the dataset (higher is better)."""

    @abc.abstractmethod
    def predict(self, queries: List[Any]) -> List[Any]:
        """Predict for a batch of queries; returns one JSON-able result each.

        For classification, each result is the list of class probabilities
        (the Predictor's ensembler averages these across workers).
        """

    @abc.abstractmethod
    def dump_parameters(self) -> Params:
        """Return trained parameters as a flat ``{name: ndarray}`` dict."""

    @abc.abstractmethod
    def load_parameters(self, params: Params) -> None:
        """Restore parameters produced by ``dump_parameters``."""

    # --- Optional hooks ---

    def destroy(self) -> None:
        """Release device/process resources. Idempotent."""

    # --- Helpers ---

    @classmethod
    def validate_knobs(cls, knobs: Knobs) -> Knobs:
        return validate_knobs(cls.get_knob_config(), knobs)


def params_size_bytes(params: Params) -> int:
    return int(sum(np.asarray(v).nbytes for v in params.values()))
