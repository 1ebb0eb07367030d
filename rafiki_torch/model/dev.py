"""Local model self-check harness for model developers.

The port's copy of ``test_model_class`` from ``rafiki_tpu/model/dev.py``
(:25-122): the full trial lifecycle — knob-config validation, a sampled
proposal, ``train → evaluate → dump_parameters → load_parameters →
predict`` — in one process, with ``device=`` passed through to the
model (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import logging
import time
from typing import Any, List, Optional, Type

import numpy as np

from .base import BaseModel, Params
from ..torchenv import DeviceLike
from .knobs import (BaseKnob, Knobs, knob_config_from_json,
                    knob_config_to_json, sample_knobs)
from .logger import logger

_log = logging.getLogger(__name__)


def test_model_class(model_class: Type[BaseModel], task: str,
                     train_dataset_path: str, val_dataset_path: str,
                     test_queries: Optional[List[Any]] = None,
                     knobs: Optional[Knobs] = None,
                     seed: int = 0,
                     device: DeviceLike = None) -> "TestModelResult":
    """Validate a model class end-to-end in-process; returns scores/outputs.

    Raises on any contract violation (bad knob config, non-serialisable
    params, predict shape mismatch, score out of band).
    """
    t0 = time.time()

    # 1. Knob config is declared, typed, and JSON round-trips.
    knob_config = model_class.get_knob_config()
    assert isinstance(knob_config, dict) and knob_config, \
        "get_knob_config() must return a non-empty dict"
    for name, knob in knob_config.items():
        assert isinstance(knob, BaseKnob), f"knob {name!r} is not a BaseKnob"
    rt = knob_config_from_json(knob_config_to_json(knob_config))
    assert set(rt) == set(knob_config), "knob config JSON round-trip changed keys"

    # 2. Sample and validate a proposal.
    rng = np.random.default_rng(seed)
    knobs = dict(knobs) if knobs is not None else sample_knobs(knob_config, rng)
    knobs = model_class.validate_knobs(knobs)
    _log.info("test_model_class: knobs=%s", knobs)

    records = []
    # Save + restore the caller's sink binding (same invariant as
    # logger.current_sink documents): a harness wrapping this helper in
    # its own capture must not lose it when we return.
    prior_sink = logger.current_sink()

    def _capture(rec, _prior=prior_sink):
        records.append(rec)
        if _prior is not None:
            _prior(rec)

    logger.set_sink(_capture)
    try:
        # 3. Train → evaluate.
        model = model_class(device=device, **knobs)
        model.train(train_dataset_path)
        score = model.evaluate(val_dataset_path)
        assert isinstance(score, float), "evaluate() must return a float"

        # 4. Parameter round-trip into a fresh instance.
        params = model.dump_parameters()
        _check_params(params)
        model.destroy()

        model2 = model_class(device=device, **knobs)
        model2.load_parameters(params)
        score2 = model2.evaluate(val_dataset_path)
        assert abs(score - score2) < 1e-3, \
            f"score changed across param round-trip: {score} vs {score2}"

        # 5. Predict contract.
        predictions = None
        if test_queries is not None:
            predictions = model2.predict(test_queries)
            assert isinstance(predictions, list) and \
                len(predictions) == len(test_queries), \
                "predict() must return one result per query"
        model2.destroy()
    finally:
        logger.set_sink(prior_sink)

    return TestModelResult(score=score, predictions=predictions,
                           knobs=knobs, log_records=records,
                           duration_s=time.time() - t0)


# Not a pytest test, despite the reference-parity name.
test_model_class.__test__ = False  # type: ignore[attr-defined]


def _check_params(params: Params) -> None:
    assert isinstance(params, dict) and params, \
        "dump_parameters() must return a non-empty dict"
    # Leaves may be tensors on the card (TorchModel's dump): one packed
    # readback, as the reference's np.asarray pulls its device arrays.
    from ..parallel.transfer import device_get_tree

    for k, arr in device_get_tree(dict(params)).items():
        assert isinstance(k, str), f"param key {k!r} is not str"
        assert arr.dtype != object, f"param {k!r} is not a numeric ndarray"


class TestModelResult:
    def __init__(self, score: float, predictions, knobs: Knobs,
                 log_records, duration_s: float):
        self.score = score
        self.predictions = predictions
        self.knobs = knobs
        self.log_records = log_records
        self.duration_s = duration_s

    def __repr__(self):
        return (f"TestModelResult(score={self.score:.4f}, "
                f"duration_s={self.duration_s:.1f})")
