"""The serving lifecycle on the card: a restack that the captured runners
read with no recapture, and a pipelined worker whose answers are its
model's own rows bit for bit.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_lifecycle_cuda.py

A restack copies the incoming member's weights into the stacked group's
storage in place, so a runner's CUDA graph, which reads that storage,
serves the new member on its next replay: no capture, and no K1 launch
through the wrapper (a replay runs the captured launches). The rows must
be those of a group stacked fresh from the new members within 1e-6. A
pipelined worker dispatches a burst before it reads the previous one
back; each runner's result is a copy of its graph's output, so a later
replay cannot overwrite an answer not yet read: the answers must equal
the model's own rows at the same bucket exactly.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from rafiki_torch.bus import MemoryBus
from rafiki_torch.cache import Cache
from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.model.stacked import stack_members
from rafiki_torch.models import TorchViT
from rafiki_torch.ops import attention as attn
from rafiki_torch.predictor import Predictor
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.worker.inference import BusInferenceWorker, sync_latency

pytestmark = pytest.mark.cuda

SHAPE = (32, 32, 3)
KNOBS = {"d_model": 128, "n_heads": 4, "patch": 4, "depth": 2}
TOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(seed):
    net = TorchViT(device="cpu", seed=seed, **KNOBS).create_module(10, SHAPE)
    p = dense_to_jax(net.state_dict())
    p["_meta/n_classes"] = np.asarray(10)
    p["_meta/image_shape"] = np.asarray(SHAPE)
    return p


def _vit(seed):
    m = TorchViT(device="cuda", **KNOBS)
    m.load_parameters(_params(seed))
    return m


def _rows(group, imgs):
    n = imgs.shape[0]
    buf = np.zeros((group.predict_bucket(n, imgs.dtype), *SHAPE), imgs.dtype)
    buf[:n] = imgs
    dev, _ = group.staged_submit(buf, n)
    return dev[:, :n].cpu().numpy()


def _imgs(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *SHAPE)).astype(np.uint8)


def test_a_restack_needs_no_recapture(card):
    imgs = _imgs(8)
    group = stack_members([_vit(0), _vit(1)])
    assert group is not None
    _rows(group, imgs)  # builds and captures the bucket's runner
    captures, k1 = group.captures, attn.flash_attention.launches
    group.update_member(1, _vit(2))
    after = _rows(group, imgs)
    assert group.captures == captures, "the restack recaptured"
    assert attn.flash_attention.launches == k1, \
        "the restacked replay launched K1 through the wrapper"
    fresh = _rows(stack_members([_vit(0), _vit(2)]), imgs)
    assert float(np.abs(after - fresh).max()) <= TOL


def test_a_pipelined_worker_answers_exactly(card):
    with tempfile.TemporaryDirectory() as tmp:
        meta = MetaStore(os.path.join(tmp, "meta.db"))
        params = ParamStore(os.path.join(tmp, "params"))
        user = meta.create_user("l@x.c", "-", "MODEL_DEVELOPER")
        model = meta.create_model(user["id"], "vit", "IMAGE_CLASSIFICATION",
                                  "rafiki_torch.models.vit:TorchViT", {})
        job = meta.create_train_job(user["id"], "vit",
                                    "IMAGE_CLASSIFICATION", {}, "-", "-",
                                    "STOPPED")
        sub = meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
        t = meta.create_trial(sub["id"], model["id"], 1, "RUNNING",
                              knobs=dict(KNOBS, batch_size=64,
                                         learning_rate=1e-3,
                                         weight_decay=1e-4, max_epochs=3,
                                         early_stop_epochs=5))
        meta.mark_trial_completed(t["id"], 0.5,
                                  params.save(_params(3), session_id="l"))
        inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
        bus = MemoryBus()
        svc = meta.create_service("INFERENCE", "DEPLOYING")
        worker = BusInferenceWorker(svc["id"], inf["id"], t["id"], meta,
                                    params, bus, device="cuda",
                                    pipeline=True).start()
        p = Predictor(inf["id"], bus, gather_timeout=60.0,
                      worker_wait_timeout=120.0)
        own = _vit(3)

        def own_rows(x, bucket):
            buf = np.zeros((bucket, *SHAPE), x.dtype)
            buf[:x.shape[0]] = x
            dev, _ = own._dispatch_bucket(buf, x.shape[0])
            return dev[:x.shape[0]].cpu().numpy().astype(np.float64)

        try:
            deadline = time.monotonic() + 300
            while svc["id"] not in Cache(bus).running_workers(inf["id"]):
                assert worker.running and time.monotonic() < deadline, \
                    "the worker did not register"
                time.sleep(0.05)
            imgs = _imgs(64, seed=1)
            # One request at a time: each burst is one request's bucket.
            for i in range(4):
                x = imgs[8 * i:8 * i + 8]
                got = np.asarray(p.predict(list(x)), np.float64)
                assert np.array_equal(got, own_rows(x, 8)), i
            info = Cache(bus).running_worker_info(inf["id"])[svc["id"]]
            assert info["pipeline"] is True
            # Eight at once: bursts overlap, and a burst may hold several
            # requests, so each answer is the rows at one of the buckets
            # a burst of them can take.
            answers = [None] * 8

            def client(i):
                answers[i] = p.predict(list(imgs[8 * i:8 * i + 8]))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            [th.start() for th in threads]
            [th.join(timeout=120) for th in threads]
            for i, got in enumerate(answers):
                x = imgs[8 * i:8 * i + 8]
                got = np.asarray(got, np.float64)
                assert any(np.array_equal(got, own_rows(x, b))
                           for b in (8, 16, 32, 64)), i
            assert sync_latency(torch.device("cuda")) > 0
        finally:
            p.close()
            worker.stop(join_timeout=60)
            meta.close()
            params.close()
