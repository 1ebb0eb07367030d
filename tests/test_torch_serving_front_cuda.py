"""The serving front over replicas on the card: two ``BusInferenceWorker``
replicas of one FeedForward bin behind one ``PredictorService`` both
take shards of the coalesced batches, and the answers equal those of
one replica within one bf16 ulp of a logit below 4 (3.9e-3).

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_front_cuda.py
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import threading

import numpy as np
import pytest
import torch

from rafiki_torch.bus import MemoryBus
from rafiki_torch.cache import Cache
from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.models import TorchFeedForward
from rafiki_torch.predictor import PredictorService
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.worker.inference import BusInferenceWorker

pytestmark = pytest.mark.cuda

TOL_PROB = 3.9e-3
SHAPE = (28, 28, 1)
KNOBS = {"hidden_layer_count": 2, "hidden_layer_units": 64,
         "learning_rate": 1e-3, "batch_size": 32, "max_epochs": 5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _deploy(tmp_path):
    """A one-trial FeedForward bin from seeded weights; ``(meta, params,
    bus, inference job id, trial id)``."""
    meta = MetaStore(str(tmp_path / "meta.db"))
    params = ParamStore(str(tmp_path / "params"))
    net = TorchFeedForward(device="cpu", seed=3, **KNOBS).create_module(
        10, SHAPE)
    p = dense_to_jax(net.state_dict())
    p["_meta/n_classes"] = np.asarray(10)
    p["_meta/image_shape"] = np.asarray(SHAPE)
    user = meta.create_user("u@x.c", "-", "MODEL_DEVELOPER")
    cls = "rafiki_torch.models.feedforward:TorchFeedForward"
    model = meta.create_model(user["id"], "ff", "IMAGE_CLASSIFICATION",
                              cls, {})
    job = meta.create_train_job(user["id"], "a", "IMAGE_CLASSIFICATION",
                                {}, "-", "-", "STOPPED")
    sub = meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
    t = meta.create_trial(sub["id"], model["id"], 1, "RUNNING",
                          knobs=KNOBS)
    meta.mark_trial_completed(t["id"], 0.5, params.save(p, session_id="s"))
    inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
    return meta, params, MemoryBus(), inf["id"], t["id"]


def _replica(meta, params, bus, inf, tid):
    svc = meta.create_service("INFERENCE", "DEPLOYING")
    w = BusInferenceWorker(svc["id"], inf, tid, meta, params, bus,
                           device="cuda").start()
    cache = Cache(bus)
    for _ in range(1200):
        if svc["id"] in cache.running_workers(inf):
            return w
        w._thread.join(0.05)
    raise AssertionError("the replica did not register")


def _window(client_fn, images):
    out = [None] * len(images)

    def one(i):
        out[i] = client_fn(images[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(images))]
    [t.start() for t in threads]
    [t.join(timeout=120) for t in threads]
    return np.asarray(out, np.float64)


def test_two_replicas_take_shards_and_answer_as_one(card, tmp_path):
    from rafiki_torch.client import Client

    meta, params, bus, inf, tid = _deploy(tmp_path)
    images = np.random.default_rng(0).integers(0, 256, (48, *SHAPE),
                                               dtype=np.uint8)
    first = _replica(meta, params, bus, inf, tid)
    svc = PredictorService.for_job("front", inf, None, bus).start()
    workers = [first]
    try:
        host = f"127.0.0.1:{svc.port}"
        client = Client()

        def ask(img):
            return client.predict(host, queries=[img, img[::-1]])[
                "predictions"]

        one = _window(ask, images)
        workers.append(_replica(meta, params, bus, inf, tid))
        pred = svc.predictor

        def shards_of(w):
            return pred._m_replica.count(service=pred.service,
                                         worker=w.service_id[:8])

        before = [shards_of(w) for w in workers]
        two = _window(ask, images)
        assert [shards_of(w) > n for w, n in zip(workers, before)] == \
            [True, True]
        assert one.shape == (48, 2, 10)
        assert np.abs(two - one).max() <= TOL_PROB
        assert svc.stats.snapshot()["batches"] > 0
    finally:
        svc.stop()
        for w in workers:
            w.stop()
        params.close()
        meta.close()
