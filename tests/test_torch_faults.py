"""Repairs of two faults of the port against the reference, on the CPU.

F1: ``TorchTransformerLM.predict`` with token ids outside ``[0, V)``
answers what ``JaxTransformerLM.predict`` answers on the same weights: a
negative id wraps once; an input id still out of range is clamped, as
JAX's gather clamps; a target id still out of range scores ``nan``, as
``take_along_axis`` fills, and then nothing is launched. Finite scores
agree within 1e-2, the tolerance of ``tests/test_torch_lm.py`` (bf16
matmuls round at different places in the two frameworks).

F2: a worker whose ``predict`` raises answers each query with an error
reply, and ``POST /predict`` answers 200 with the other workers'
ensemble, or ``null`` when every worker failed.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import math
import urllib.request

import numpy as np
import pytest

from rafiki_tpu.models import JaxTransformerLM
from rafiki_torch.model.base import BaseModel
from rafiki_torch.models import TorchTransformerLM
from rafiki_torch.predictor import PredictorService
from rafiki_torch.worker import InferenceWorker

TINY = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 4,
        "learning_rate": 1e-2, "train_steps": 200, "vocab_size": 512,
        "quick_train": False}
V = TINY["vocab_size"]


def _params(seed=0, d=256, L=2):
    rng = np.random.default_rng(seed)
    p = {"embed": 0.02 * rng.standard_normal((V, d)), "lnf": np.ones(d),
         "layers/ln1": np.ones((L, d)), "layers/ln2": np.ones((L, d))}
    for name, shape in {"qkv": (L, d, 3 * d), "proj": (L, d, d),
                        "w1": (L, d, 4 * d), "w2": (L, 4 * d, d)}.items():
        p[f"layers/{name}"] = rng.standard_normal(shape) / np.sqrt(shape[-2])
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.fixture(scope="module")
def lms():
    p = _params()
    jm = JaxTransformerLM(**JaxTransformerLM.validate_knobs(TINY))
    jm.load_parameters(p)
    tm = TorchTransformerLM(device="cpu",
                            **TorchTransformerLM.validate_knobs(TINY))
    tm.load_parameters(p)
    yield jm, tm
    jm.destroy()
    tm.destroy()


# (query, whether the reference scores it nan)
F1_QUERIES = [
    ([1, 600, 3], True),        # a target past V
    ([1, 2, 600], True),        # the last target past V
    ([1, -5, 3], False),        # a negative id wraps to V - 5
    ([600, 1, 2], False),       # an input-only id past V is clamped
    ([-600, 1, 2], False),      # below -V: wraps to -88, clamped to 0
    ([1, -512, 3], False),      # exactly -V wraps to 0
    ([1, -513, 3], True),       # one below -V: a target out of range
    ([1, 2, 3, 40000], True),   # far past V
]


@pytest.mark.parametrize("query,is_nan", F1_QUERIES,
                         ids=[str(q) for q, _ in F1_QUERIES])
def test_out_of_vocabulary_ids_answer_as_the_reference(lms, query, is_nan):
    jm, tm = lms
    ref = jm.predict([query])[0]
    out = tm.predict([query])[0]
    assert math.isnan(ref) == is_nan
    assert math.isnan(out) == is_nan
    if not is_nan:
        assert abs(out - ref) <= 1e-2


def test_a_nan_query_launches_nothing(lms, monkeypatch):
    _, tm = lms

    def no_forward(ids):
        raise AssertionError("a query scored nan must not run the model")

    monkeypatch.setattr(tm, "_forward", no_forward)
    assert all(math.isnan(p) for p in tm.predict([[1, 600, 3],
                                                  [1, -513, 3]]))


def test_a_bad_query_leaves_the_rest_of_the_batch_intact(lms):
    jm, tm = lms
    good = np.random.default_rng(3).integers(0, V, 50).tolist()
    out = tm.predict([good, [1, 600, 3], good])
    ref = jm.predict([good])[0]
    assert math.isnan(out[1])
    assert out[0] == out[2]
    assert abs(out[0] - ref) <= 1e-2


class _Fixed(BaseModel):
    """A model whose ``predict`` gives a fixed probability vector per
    query, or raises ``ValueError("boom")``."""

    def __init__(self, device=None, **knobs):
        super().__init__(**knobs)
        self.probs = None

    @staticmethod
    def get_knob_config():
        return {}

    def train(self, dataset_path, *, shared_params=None, **kwargs):
        raise NotImplementedError

    def evaluate(self, dataset_path):
        raise NotImplementedError

    def predict(self, queries):
        if self.probs is None:
            raise ValueError("boom")
        return [list(self.probs) for _ in queries]

    def dump_parameters(self):
        return {}

    def load_parameters(self, params):
        self.probs = params.get("probs")


def _post(url, body):
    req = urllib.request.Request(url + "/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("good", [1, 0], ids=["one-fails", "all-fail"])
def test_a_failed_worker_is_skipped_by_the_ensemble(good):
    params = [{"probs": np.asarray([0.25, 0.75])}] * good + [{}]
    workers = [InferenceWorker(_Fixed, {}, p, device="cpu").start()
               for p in params]
    app = PredictorService(workers, device="cpu").start()
    try:
        status, body = _post(app.url, {"query": [1, 2]})
        assert status == 200
        assert body == {"prediction": [0.25, 0.75] if good else None}
        status, body = _post(app.url, {"queries": [[1], [2], [3]]})
        assert status == 200
        want = [0.25, 0.75] if good else None
        assert body == {"predictions": [want] * 3}
        # The failing worker answers each query with an error reply.
        assert workers[-1].predict([[1], [2]], timeout=30) == \
            [{"error": "ValueError: boom"}] * 2
    finally:
        app.stop()
        for w in workers:
            w.stop()
