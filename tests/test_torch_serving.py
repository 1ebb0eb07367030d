"""The port's serving path on the CPU: ``InferenceWorker`` and the
predictor's ``POST /predict`` answer with exactly ``model.predict``'s
values, on the reference's wire."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from rafiki_torch.models import TorchTransformerLM
from rafiki_torch.predictor import PredictorService, ensemble_predictions
from rafiki_torch.worker import InferenceWorker

KNOBS = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 4,
         "learning_rate": 1e-2, "train_steps": 200, "vocab_size": 512,
         "quick_train": False}


def _params(seed=0, d=256, L=2, V=512):
    rng = np.random.default_rng(seed)
    p = {"embed": 0.02 * rng.standard_normal((V, d)), "lnf": np.ones(d),
         "layers/ln1": np.ones((L, d)), "layers/ln2": np.ones((L, d))}
    for name, shape in {"qkv": (L, d, 3 * d), "proj": (L, d, d),
                        "w1": (L, d, 4 * d), "w2": (L, 4 * d, d)}.items():
        p[f"layers/{name}"] = rng.standard_normal(shape) / np.sqrt(shape[-2])
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.fixture(scope="module")
def served():
    worker = InferenceWorker(TorchTransformerLM, KNOBS, _params(),
                             device="cpu").start()
    app = PredictorService([worker], device="cpu").start()
    yield worker, app
    app.stop()
    worker.stop()
    assert not worker.running


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _queries(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(k)).tolist()
            for k in rng.integers(1, 300, n)]


def test_single_query(served):
    worker, app = served
    q = _queries(1, 1)[0]
    status, body = _post(app.url + "/predict", {"query": q})
    assert status == 200
    assert body == {"prediction": worker.model.predict([q])[0]}


def test_batched_queries(served):
    worker, app = served
    qs = _queries(2, 4) + [[5]]
    status, body = _post(app.url + "/predict", {"queries": qs})
    assert status == 200
    assert body == {"predictions": worker.model.predict(qs)}
    assert body["predictions"][-1] == 0.0


@pytest.mark.parametrize("body", [b"", {}, {"other": 1}, b"not json",
                                  {"queries": 3}])
def test_bad_bodies_get_400(served, body):
    _, app = served
    status, reply = _post(app.url + "/predict", body)
    assert status == 400 and "error" in reply


def test_unknown_route_gets_404(served):
    _, app = served
    status, _ = _post(app.url + "/nope", {"query": [1, 2]})
    assert status == 404


def test_worker_coalesces_concurrent_callers(served):
    """Callers submitting at once each get their own predictions back,
    whatever batches the worker formed."""
    worker, _ = served
    batches = [_queries(10 + i, 2) for i in range(6)]
    expected = [worker.model.predict(qs) for qs in batches]
    results = [None] * len(batches)

    def call(i):
        results[i] = worker.predict(batches[i], timeout=120)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert results == expected


def test_predict_errors_reach_the_caller():
    worker = InferenceWorker(TorchTransformerLM, KNOBS, _params(),
                             device="cpu").start()
    try:
        with pytest.raises(TypeError):
            worker.predict([None], timeout=60)   # not a list of ids
        assert worker.predict([[1, 2, 3]], timeout=60)[0] < 0
    finally:
        worker.stop()


def test_ensemble_of_scores_is_the_mean():
    assert ensemble_predictions([-2.0, -4.0]) == -3.0
    assert ensemble_predictions([{"error": "x"}, -1.5]) == -1.5
    assert ensemble_predictions(["a", "b", "a"]) == "a"
