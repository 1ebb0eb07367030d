"""SklearnModel: the scikit-learn path of the BaseModel contract.

The port's copy of ``rafiki_tpu/model/sklearn_model.py``: image
classifiers on flattened, [0, 1]-scaled pixels, whose subclasses only
declare knobs and build an estimator. They are the cheap members of the
zoo: trials that need no card and diversity in an ensemble.

The fitted estimator is pickled into a uint8 array under
``_sk/estimator``, beside ``_meta/n_classes`` and ``_meta/image_shape``,
so it rides the ParamStore's flat ``{name: ndarray}`` format, and each
package loads the other's dump. ``device`` is taken for the worker's
contract (every model class is built with one) and not used: sklearn
runs on the host's CPU. ``sklearn`` is imported only by the subclasses'
``create_estimator`` (the card's machine has none), and ``pickle`` loads
only parameters this platform wrote.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from ..torchenv import DeviceLike
from .base import BaseModel, Params
from .dataset import load_image_dataset, normalize_query
from .logger import logger


class SklearnModel(BaseModel):
    """Base for sklearn-estimator-backed image classifiers."""

    def __init__(self, device: DeviceLike = None, **knobs: Any):
        super().__init__(**knobs)
        self.device = device
        self._estimator = None
        self._meta: Dict[str, Any] = {}

    # --- Subclass API ---

    def create_estimator(self):
        raise NotImplementedError

    # --- BaseModel contract ---

    def _require_estimator(self):
        if self._estimator is None:
            raise RuntimeError("train() or load_parameters() first")
        return self._estimator

    def train(self, dataset_path: str, *,
              shared_params: Optional[Params] = None, **kwargs: Any) -> None:
        ds = load_image_dataset(dataset_path)
        x = ds.normalized().reshape(ds.size, -1)
        y = ds.labels
        self._estimator = self.create_estimator()
        self._estimator.fit(x, y)
        self._meta = {"n_classes": int(ds.n_classes),
                      "image_shape": list(ds.image_shape)}
        acc = float(self._estimator.score(x, y))
        logger.log(msg="sklearn fit done", train_acc=acc)

    def evaluate(self, dataset_path: str) -> float:
        est = self._require_estimator()
        ds = load_image_dataset(dataset_path)
        x = ds.normalized().reshape(ds.size, -1)
        return float(est.score(x, ds.labels))

    def predict(self, queries: List[Any]) -> List[Any]:
        est = self._require_estimator()
        if not queries:
            return []
        n_classes = self._meta["n_classes"]
        imgs = [normalize_query(q, self._meta["image_shape"]).reshape(-1)
                for q in queries]
        x = np.stack(imgs)
        # The estimator's classes_ columns go back onto the full label
        # range, so the Predictor can average the probabilities of
        # members that saw different classes.
        probs = np.zeros((len(imgs), n_classes), np.float32)
        raw = est.predict_proba(x)
        for col, cls in enumerate(est.classes_):
            probs[:, int(cls)] = raw[:, col]
        return [p.tolist() for p in probs]

    def dump_parameters(self) -> Params:
        est = self._require_estimator()
        buf = io.BytesIO()
        pickle.dump(est, buf, protocol=pickle.HIGHEST_PROTOCOL)
        return {
            "_sk/estimator": np.frombuffer(buf.getvalue(), np.uint8),
            "_meta/n_classes": np.asarray(self._meta["n_classes"]),
            "_meta/image_shape": np.asarray(self._meta["image_shape"]),
        }

    def load_parameters(self, params: Params) -> None:
        blob = params.get("_sk/estimator")
        if blob is None:
            raise ValueError("params missing _sk/estimator")
        self._estimator = pickle.loads(np.asarray(blob).tobytes())
        self._meta = {
            "n_classes": int(np.asarray(
                params["_meta/n_classes"]).reshape(-1)[0]),
            "image_shape": [int(v) for v in
                            np.asarray(params["_meta/image_shape"])],
        }

    def destroy(self) -> None:
        self._estimator = None
