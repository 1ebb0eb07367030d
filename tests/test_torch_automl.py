"""The port's AutoML loop on the CPU, against the reference's parts.

advise (``RandomAdvisor``) → train a trial (``TrialRunner`` on
``TorchFeedForward``) → persist (``MetaStore``, ``ParamStore``) → deploy
the two best trials as ``InferenceWorker``s behind one
``PredictorService`` → ``POST /predict``. The stores are held against the
reference's: the same files (safetensors, written without the
``safetensors`` package) load in both packages, and the four sharing
policies pick the same saves. Probabilities across packages agree within
``PROB_ATOL`` of ``tests/test_torch_feedforward.py`` (bf16 logits).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import urllib.request

import numpy as np
import pytest
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save as st_save

from rafiki_tpu.advisor.random_advisor import RandomAdvisor as JaxRandomAdvisor
from rafiki_tpu.datasets import make_synthetic_image_dataset as jax_synth
from rafiki_tpu.models.feedforward import JaxFeedForward
from rafiki_tpu.store import ParamStore as JaxParamStore
from rafiki_torch.advisor import RandomAdvisor
from rafiki_torch.constants import (BudgetOption, ParamsType, TaskType,
                                    TrainJobStatus, TrialStatus)
from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.model.base import BaseModel
from rafiki_torch.models import TorchFeedForward
from rafiki_torch.predictor import PredictorService
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.store import tensorfile
from rafiki_torch.worker import InferenceWorker, TrialRunner

SHAPE = (12, 12, 1)
N_CLASSES = 4
PROB_ATOL = 3.9e-3


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("automl")), n_train=256, n_val=64,
        image_shape=SHAPE, n_classes=N_CLASSES)


def test_synthetic_images_are_the_references_bytes(tmp_path):
    ours = make_synthetic_image_dataset(str(tmp_path / "a"), n_train=40,
                                        n_val=8, image_shape=(6, 5, 1),
                                        n_classes=3, seed=7, name="x")
    ref = jax_synth(str(tmp_path / "b"), n_train=40, n_val=8,
                    image_shape=(6, 5, 1), n_classes=3, seed=7, name="x")
    for a, b in zip(ours, ref):
        assert os.path.basename(a) == os.path.basename(b)
        with np.load(a) as za, np.load(b) as zb:
            assert set(za.files) == set(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
                assert za[k].dtype == zb[k].dtype


def test_random_advisor_proposes_the_references_knobs():
    ours = RandomAdvisor(TorchFeedForward.get_knob_config(), seed=0)
    ref = JaxRandomAdvisor(JaxFeedForward.get_knob_config(), seed=0)
    for _ in range(5):
        a, b = ours.propose(), ref.propose()
        assert a.trial_no == b.trial_no
        assert a.knobs == b.knobs


def _job(meta):
    user = meta.create_user("dev@example.com", "x", "MODEL_DEVELOPER")
    model = meta.create_model(user["id"], "ff", TaskType.IMAGE_CLASSIFICATION,
                              "rafiki_torch.models:TorchFeedForward", {})
    job = meta.create_train_job(user["id"], "app",
                                TaskType.IMAGE_CLASSIFICATION,
                                {BudgetOption.MODEL_TRIAL_COUNT: 3},
                                "train.npz", "val.npz",
                                TrainJobStatus.RUNNING)
    sub = meta.create_sub_train_job(job["id"], model["id"], "RUNNING")
    return job, sub, model


def _post(url, body):
    req = urllib.request.Request(url + "/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_the_loop_end_to_end(synth, tmp_path):
    train, val = synth
    meta = MetaStore(str(tmp_path / "meta.db"))
    params = ParamStore(str(tmp_path / "params"))
    job, sub, model = _job(meta)
    runner = TrialRunner(TorchFeedForward,
                         RandomAdvisor(TorchFeedForward.get_knob_config(),
                                       seed=0),
                         train, val, meta, params, sub["id"],
                         model_id=model["id"],
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 3},
                         device="cpu")
    rows = runner.run()
    assert [r["status"] for r in rows] == [TrialStatus.COMPLETED] * 3
    assert [r["no"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert params.exists(r["params_id"])
        logs = [json.loads(x["record"]) if isinstance(x["record"], str)
                else x["record"] for x in meta.get_trial_logs(r["id"])]
        epochs = [x["values"] for x in logs if x["type"] == "values"
                  and "epoch" in x["values"]]
        assert len(epochs) == 5
    best = meta.get_best_trials_of_train_job(job["id"], max_count=2)
    assert len(best) == 2 and best[0]["score"] >= best[1]["score"]
    assert best[0]["score"] > 1.5 / N_CLASSES  # well above chance

    workers = [InferenceWorker(TorchFeedForward, t["knobs"],
                               params.load(t["params_id"]),
                               device="cpu").start() for t in best]
    app = PredictorService(workers, device="cpu").start()
    try:
        # JSON carries numbers, not uint8: a client sends normalised
        # floats, as to the reference's JSON wire.
        images = np.load(val)["images"][:6]
        floats = (images.astype(np.float32) / 255.0).tolist()
        status, body = _post(app.url, {"queries": floats})
        assert status == 200
        served = np.asarray(body["predictions"])
        own = np.mean([w.predict(list(images), timeout=60)
                       for w in workers], axis=0)
        np.testing.assert_allclose(served, own, atol=1e-6, rtol=0)
        assert (served.argmax(-1) == np.load(val)["labels"][:6]).mean() > 0.5
        # A 2-D query gains its channel axis.
        status, body = _post(app.url, {
            "query": np.asarray(floats)[0, :, :, 0].tolist()})
        assert status == 200
        np.testing.assert_allclose(body["prediction"], own[0], atol=1e-6)
    finally:
        app.stop()
        for w in workers:
            w.stop()
    params.close()
    meta.close()


class _Broken(TorchFeedForward):
    def train(self, dataset_path, **kwargs):
        raise RuntimeError("broken model")


def test_failing_trials_trip_the_breaker(synth, tmp_path):
    train, val = synth
    meta = MetaStore(":memory:")
    params = ParamStore(str(tmp_path / "p"))
    _, sub, _ = _job(meta)
    advisor = RandomAdvisor(_Broken.get_knob_config(), seed=0)
    runner = TrialRunner(_Broken, advisor, train, val, meta, params,
                         sub["id"], budget={BudgetOption.MODEL_TRIAL_COUNT: 5},
                         max_consecutive_errors=2, device="cpu")
    rows = runner.run()
    assert [r["status"] for r in rows] == [TrialStatus.ERRORED] * 2
    assert "broken model" in rows[0]["error"]
    assert advisor._forgotten == 2


def test_trial_runner_needs_a_card_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrialRunner(TorchFeedForward, None, "t", "v", MetaStore(":memory:"),
                    None, "sub")


def _ff_params(seed=0):
    rng = np.random.default_rng(seed)
    widths = [int(np.prod(SHAPE)), 128, 128, 128, N_CLASSES]
    p = {}
    for i in range(4):
        p[f"params/Dense_{i}/kernel"] = (
            rng.standard_normal((widths[i], widths[i + 1]))
            / np.sqrt(widths[i])).astype(np.float32)
        p[f"params/Dense_{i}/bias"] = (
            0.1 * rng.standard_normal(widths[i + 1])).astype(np.float32)
    p["_meta/n_classes"] = np.asarray(N_CLASSES)
    p["_meta/image_shape"] = np.asarray(SHAPE)
    return p


KNOBS = {"hidden_layer_count": 2, "hidden_layer_units": 90,
         "learning_rate": 1e-3, "batch_size": 32}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_param_files_interchange(tmp_path, writer):
    """A file written by either package's ParamStore loads in the other
    and serves the same predictions from both models."""
    ours = ParamStore(str(tmp_path / "ours"))
    ref = JaxParamStore(str(tmp_path / "ref"))
    p = _ff_params()
    if writer == "port":
        tm = TorchFeedForward(device="cpu",
                              **TorchFeedForward.validate_knobs(KNOBS))
        tm.load_parameters(p)
        pid = ours.save(tm.dump_parameters(), session_id="s")
        ours.flush()  # the dump's tensors take the write-behind
        path = os.path.join(ours.params_dir, f"{pid}.safetensors")
        loaded = st_load_file(path)
        # The reference's store reads the same file.
        os.link(path, os.path.join(ref.params_dir, f"{pid}.safetensors"))
        for k, v in ref.load(pid).items():
            np.testing.assert_array_equal(v, loaded[k])
    else:
        jm = JaxFeedForward(**JaxFeedForward.validate_knobs(KNOBS))
        jm.load_parameters(p)
        pid = ref.save(jm.dump_parameters(), session_id="s")
        ref.flush()
        path = os.path.join(ref.params_dir, f"{pid}.safetensors")
        os.link(path, os.path.join(ours.params_dir, f"{pid}.safetensors"))
        loaded = ours.load(pid)
    for k in p:
        np.testing.assert_array_equal(np.asarray(loaded[k]).reshape(
            np.shape(p[k])), p[k])
    jm = JaxFeedForward(**JaxFeedForward.validate_knobs(KNOBS))
    jm.load_parameters(loaded)
    tm = TorchFeedForward(device="cpu", **TorchFeedForward.validate_knobs(KNOBS))
    tm.load_parameters(loaded)
    q = list(np.random.default_rng(4).integers(0, 256, (9, *SHAPE),
                                               dtype=np.uint8))
    np.testing.assert_allclose(tm.predict(q), jm.predict(q), atol=PROB_ATOL,
                               rtol=0)
    ours.close()
    ref.close()


def test_tensorfile_writes_the_packages_bytes():
    arrays = {"params/Dense_1/kernel": np.ones((2, 3), np.float32),
              "params/Dense_0/bias": np.arange(3, dtype=np.float32),
              "_meta/n_classes": np.asarray(10),
              "_meta/image_shape": np.asarray([28, 28, 1]),
              "f64": np.linspace(0, 1, 5), "u8": np.arange(7, dtype=np.uint8),
              "f16": np.ones(3, np.float16), "i32": np.arange(2, dtype=np.int32),
              "bool": np.array([True, False, True]),
              "empty": np.zeros((0, 4), np.float32)}
    data = tensorfile.save(arrays)
    assert data == st_save(arrays)
    back = tensorfile.load(data)
    assert list(back) == list(tensorfile.load(st_save(arrays)))
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError):
        tensorfile.load(data[:-1])


SAVES = [("w1", 0.5), ("w2", 0.9), ("w1", 0.7), ("w2", 0.1), ("w1", 0.7)]


@pytest.mark.parametrize("policy", [ParamsType.LOCAL_RECENT,
                                    ParamsType.LOCAL_BEST,
                                    ParamsType.GLOBAL_RECENT,
                                    ParamsType.GLOBAL_BEST,
                                    ParamsType.NONE])
def test_sharing_policies_match_the_reference(tmp_path, policy):
    ours = ParamStore(str(tmp_path / "ours"))
    ref = JaxParamStore(str(tmp_path / "ref"))
    for store in (ours, ref):
        for i, (worker, score) in enumerate(SAVES):
            store.save({"tag": np.asarray([i], np.int64)}, session_id="s",
                       worker_id=worker, score=score)
        store.save({"tag": np.asarray([99], np.int64)}, session_id="other",
                   worker_id="w1", score=2.0)
    ref.flush()
    for worker in ("w1", "w2", "w3"):
        a = ours.retrieve(policy, session_id="s", worker_id=worker)
        b = ref.retrieve(policy, session_id="s", worker_id=worker)
        assert (a is None) == (b is None), worker
        if a is not None:
            assert int(a["tag"][0]) == int(np.asarray(b["tag"])[0]), worker
    ours.close()
    ref.close()


def test_delete_removes_the_file_and_the_row(tmp_path):
    ours = ParamStore(str(tmp_path / "ours"))
    first = ours.save({"tag": np.asarray([1])}, session_id="s", score=0.5)
    second = ours.save({"tag": np.asarray([2])}, session_id="s", score=0.1)
    ours.delete(first)
    assert not ours.exists(first) and ours.exists(second)
    best = ours.retrieve(ParamsType.GLOBAL_BEST, session_id="s")
    assert int(best["tag"][0]) == 2
    ours.delete(second)
    assert ours.retrieve(ParamsType.GLOBAL_RECENT, session_id="s") is None
    ours.close()


class _Recorder(BaseModel):
    """Counts how the runner drives a model."""

    calls: list = []

    def __init__(self, device=None, **knobs):
        super().__init__(**knobs)
        self.device = device

    @staticmethod
    def get_knob_config():
        from rafiki_torch.model import FloatKnob
        return {"x": FloatKnob(0.0, 1.0)}

    def train(self, dataset_path, *, shared_params=None, **kwargs):
        self.calls.append(("train", str(self.device), shared_params))

    def evaluate(self, dataset_path):
        return float(self.knobs["x"])

    def predict(self, queries):
        return [0.0 for _ in queries]

    def dump_parameters(self):
        return {"x": np.asarray([self.knobs["x"]], np.float32)}

    def load_parameters(self, params):
        pass


def test_runner_passes_the_device_and_warm_starts(tmp_path):
    """A proposal asking for GLOBAL_BEST warm-starts from the best save
    so far; every model is built on the runner's device."""
    from rafiki_torch.advisor import BaseAdvisor

    class Warm(BaseAdvisor):
        def _propose_knobs(self, trial_no):
            return {"x": [0.3, 0.8, 0.5][trial_no - 1]}

        def _params_type(self, trial_no):
            return ParamsType.GLOBAL_BEST

    _Recorder.calls = []
    meta = MetaStore(":memory:")
    params = ParamStore(str(tmp_path / "p"))
    _, sub, _ = _job(meta)
    rows = TrialRunner(_Recorder, Warm(_Recorder.get_knob_config()), "t",
                       "v", meta, params, sub["id"],
                       budget={BudgetOption.MODEL_TRIAL_COUNT: 3},
                       device="cpu").run()
    assert [r["score"] for r in rows] == [0.3, 0.8, 0.5]
    assert [c[1] for c in _Recorder.calls] == ["cpu"] * 3
    shared = [c[2] for c in _Recorder.calls]
    assert shared[0] is None
    assert float(shared[1]["x"][0]) == pytest.approx(0.3)
    assert float(shared[2]["x"][0]) == pytest.approx(0.8)
