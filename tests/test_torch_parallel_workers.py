"""The workers bind their chip group to their thread, and the SDK's and
the store's last calls.

- A train worker and an inference worker on a 2-chip CPU group train
  and serve a ``sequence_parallel`` 2 tagger: the tagger's mesh is the
  group's (sp 2), the served distributions are a single-device tagger's
  on the same file within 1e-2 (bf16 logits, as
  ``test_torch_tagger.py``'s predict tolerance), and each worker's
  thread is unbound when it ends.
- ``BaseModel.predict_submit`` runs ``predict`` at once (an error raises
  at submit, as in the reference); the packed worker path calls it with
  no fallback; ``MetaStore.get_train_job_by_app`` and
  ``get_inference_job_by_train_job`` answer as the reference's on the
  same calls.
- ``python -m rafiki_torch.parallelism_tour`` raises without a card
  unless ``--device cpu`` is given.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rafiki_torch.advisor import RandomAdvisor
from rafiki_torch.bus import MemoryBus, connect
from rafiki_torch.cache import Cache
from rafiki_torch.constants import (BudgetOption, ServiceStatus, ServiceType,
                                    TrialStatus, UserType)
from rafiki_torch.datasets import make_synthetic_corpus_dataset
from rafiki_torch.model.base import BaseModel
from rafiki_torch.model.dataset import load_corpus_dataset
from rafiki_torch.models import TorchTransformerTagger
from rafiki_torch.parallel.chips import ChipGroup
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.worker.inference import BusInferenceWorker, _PackedEnsemble
from rafiki_torch.worker.train import TrainWorker

ROOT = Path(__file__).resolve().parents[1]

SP_SOURCE = """
import numpy as np
from rafiki_torch.model import FixedKnob
from rafiki_torch.models import TorchTransformerTagger


class SpTagger(TorchTransformerTagger):
    @staticmethod
    def get_knob_config():
        return {"d_model": FixedKnob(32), "n_heads": FixedKnob(4),
                "n_layers": FixedKnob(2), "max_len": FixedKnob(16),
                "vocab_size": FixedKnob(300), "dropout": FixedKnob(0.0),
                "learning_rate": FixedKnob(3e-3), "batch_size": FixedKnob(8),
                "max_epochs": FixedKnob(2), "sequence_parallel": FixedKnob(2),
                "seed": FixedKnob(0)}

    def dump_parameters(self):
        out = super().dump_parameters()
        shape = self.mesh.shape
        out["_meta/mesh"] = np.asarray([shape["dp"], shape["sp"],
                                        self.mesh.size])
        return out
"""


def test_the_workers_train_and_serve_an_sp_tagger_on_their_group(tmp_path):
    meta = MetaStore(str(tmp_path / "meta.db"))
    params = ParamStore(str(tmp_path / "params"))
    train, val = make_synthetic_corpus_dataset(
        str(tmp_path / "corpus"), n_train=16, n_val=8, vocab=60, n_tags=4,
        max_len=16, seed=0)
    user = meta.create_user("d@x.c", "-", UserType.MODEL_DEVELOPER)
    model = meta.create_model(user["id"], "sp", "POS_TAGGING", "SpTagger",
                              {}, model_source=SP_SOURCE)
    job = meta.create_train_job(user["id"], "app", "POS_TAGGING",
                                {BudgetOption.MODEL_TRIAL_COUNT: 1},
                                train, val, status="RUNNING")
    sub = meta.create_sub_train_job(job["id"], model["id"],
                                    status="RUNNING")
    svc = meta.create_service(ServiceType.TRAIN, ServiceStatus.STARTED)
    group = ChipGroup(indices=(0, 1), device_type="cpu")
    from rafiki_torch.utils.model_loader import load_model_class

    cls = load_model_class("SpTagger", SP_SOURCE)
    w = TrainWorker(svc["id"], sub["id"], meta, params, connect(""),
                    chips=group, advisor=RandomAdvisor(cls.get_knob_config()))
    w.start()
    w.join(120)
    assert not w.running
    (trial,) = meta.get_trials(sub["id"])
    assert trial["status"] == TrialStatus.COMPLETED, trial
    p = params.load(trial["params_id"])
    assert np.asarray(p["_meta/mesh"]).tolist() == [1, 2, 2]
    assert ChipGroup.bound() is None

    inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
    isvc = meta.create_service(ServiceType.INFERENCE, ServiceStatus.DEPLOYING)
    bus = MemoryBus()
    iw = BusInferenceWorker(isvc["id"], inf["id"], trial["id"], meta, params,
                            bus, chips=group).start()
    cache = Cache(bus)
    try:
        for _ in range(600):
            if isvc["id"] in cache.running_workers(inf["id"]):
                break
            time.sleep(0.05)
        queries = load_corpus_dataset(val).sentences[:3]
        bus.push(f"q:{isvc['id']}", {"batch_id": "b1", "shard": "s",
                                     "queries": queries})
        (reply,) = cache.gather_prediction_batches("b1", 1, timeout=60)
        served = iw.model  # a bin of one trial serves its model
        assert dict(served.mesh.shape)["sp"] == 2
        assert served.mesh.size == 2
    finally:
        iw.stop(30)
    assert not iw._thread.is_alive()
    single = TorchTransformerTagger(device="cpu", **{
        k: v.value for k, v in cls.get_knob_config().items()
        if k != "sequence_parallel"})
    single.load_parameters(p)
    want = single.predict(queries)
    assert [len(r) for r in reply["predictions"]] == [len(q) for q in want]
    for got, ref in zip(reply["predictions"], want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-2, rtol=0)


class _Model(BaseModel):
    @staticmethod
    def get_knob_config():
        return {}

    def __init__(self, fail=False, **knobs):
        super().__init__(**knobs)
        self.fail, self.calls = fail, 0

    def train(self, dataset_path, **kwargs):
        pass

    def evaluate(self, dataset_path):
        return 0.0

    def predict(self, queries):
        self.calls += 1
        if self.fail:
            raise RuntimeError("no prediction")
        return [[1.0, 0.0] for _ in queries]

    def dump_parameters(self):
        return {}

    def load_parameters(self, params):
        pass


def test_predict_submit_predicts_at_once_and_raises_at_submit():
    from rafiki_tpu.model.base import BaseModel as JaxBase

    assert JaxBase.predict_submit.__doc__ and BaseModel.predict_submit
    m = _Model()
    finish = m.predict_submit(["a", "b"])
    assert m.calls == 1
    assert finish() == [[1.0, 0.0], [1.0, 0.0]] and m.calls == 1
    with pytest.raises(RuntimeError, match="no prediction"):
        _Model(fail=True).predict_submit(["a"])


def test_the_packed_worker_path_calls_predict_submit_without_a_fallback():
    """A member whose predict raises drops its vote at submit; a member
    without ``predict_submit`` is not served through ``predict``."""
    good, bad = _Model(), _Model(fail=True)
    ens = _PackedEnsemble([good, bad])
    finish = ens.predict_submit(["q"])
    assert good.calls == bad.calls == 1
    assert finish() == [[1.0, 0.0]] and ens.last_weight == 1

    class NotABaseModel:
        calls = 0

        def predict(self, queries):
            NotABaseModel.calls += 1
            return [[0.0, 1.0] for _ in queries]

    ens = _PackedEnsemble([good, NotABaseModel()])
    assert ens.predict_submit(["q"])() == [[1.0, 0.0]]
    assert NotABaseModel.calls == 0


def test_the_store_s_lookups_match_the_reference_s(tmp_path):
    from rafiki_tpu.store import MetaStore as JaxMeta

    rows = {}
    for name, cls in (("jax", JaxMeta), ("torch", MetaStore)):
        meta = cls(str(tmp_path / f"{name}.db"))
        user = meta.create_user("a@b.c", "-", UserType.APP_DEVELOPER)
        other = meta.create_user("o@b.c", "-", UserType.APP_DEVELOPER)
        jobs = [meta.create_train_job(user["id"], "app", "POS_TAGGING", {},
                                      "t", "v", "STOPPED") for _ in range(3)]
        meta.create_train_job(other["id"], "app", "POS_TAGGING", {}, "t", "v",
                              "STOPPED")
        infs = []
        for _ in range(2):
            infs.append(meta.create_inference_job(user["id"], jobs[1]["id"],
                                                  "STOPPED"))
            time.sleep(0.01)
        got = {
            "latest": meta.get_train_job_by_app(user["id"], "app"),
            "v2": meta.get_train_job_by_app(user["id"], "app", 2),
            "none": meta.get_train_job_by_app(user["id"], "nope"),
            "v9": meta.get_train_job_by_app(user["id"], "app", 9),
            "inf": meta.get_inference_job_by_train_job(jobs[1]["id"]),
            "no_inf": meta.get_inference_job_by_train_job(jobs[0]["id"])}
        ids = {j["id"]: f"job{i}" for i, j in enumerate(jobs)}
        ids.update({j["id"]: f"inf{i}" for i, j in enumerate(infs)})
        rows[name] = {k: None if r is None else (
            ids[r["id"]], r.get("app_version"), r.get("user_id") == user["id"])
            for k, r in got.items()}
    assert rows["torch"] == rows["jax"]
    assert rows["torch"]["latest"] == ("job2", 3, True)
    assert rows["torch"]["v2"][:2] == ("job1", 2)
    assert rows["torch"]["inf"][0] == "inf1"


def test_the_tour_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "rafiki_torch.parallelism_tour"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "TOUR OK" not in out.stdout
