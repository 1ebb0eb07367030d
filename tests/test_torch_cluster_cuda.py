"""The fault plane and the cluster fabric built on the card: a ViT
trial's ``BusInferenceWorker`` on CUDA behind two predictor frontends of
one job with the fabric on.

This test needs a CUDA device and skips without one. On a machine with a
card and without JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cluster_cuda.py

The worker's runner builds launch K1 on its wgmma variant; a query asked
of the second frontend is a peer hit on the first's cache, bit for bit
the scatter's answer, with one query on the device; a gossiped
invalidation makes the second frontend scatter again; and an armed
``worker.crash`` kills the worker hard, counted once.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import tempfile
import time
import urllib.request

import numpy as np
import pytest
import torch

from rafiki_torch import faults
from rafiki_torch.bus import MemoryBus
from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.models import TorchViT
from rafiki_torch.observe.metrics import registry
from rafiki_torch.store import MetaStore, ParamStore

pytestmark = pytest.mark.cuda

SHAPE = (32, 32, 3)
KNOBS = {"d_model": 128, "n_heads": 4, "patch": 4, "depth": 2}
WAIT_S = 120.0


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


def _post(svc, path, body):
    req = urllib.request.Request(
        f"{svc.url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def test_the_fabric_and_the_fault_plane_on_the_card(card, monkeypatch):
    from rafiki_torch.ops import _build
    from rafiki_torch.ops import attention as attn
    from rafiki_torch.predictor.app import PredictorService
    from rafiki_torch.worker.inference import BusInferenceWorker

    _build.build_all()
    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_FABRIC", "1")
    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S", "2.0")
    faults.reset()
    faults.set_plan("")  # armed quietly before the stack is built
    with tempfile.TemporaryDirectory() as tmp:
        meta = MetaStore(f"{tmp}/meta.db")
        params = ParamStore(f"{tmp}/params")
        user = meta.create_user("c@x.c", "-", "MODEL_DEVELOPER")
        model = meta.create_model(user["id"], "vit", "IMAGE_CLASSIFICATION",
                                  "rafiki_torch.models.vit:TorchViT", {})
        job = meta.create_train_job(user["id"], "vit",
                                    "IMAGE_CLASSIFICATION", {}, "-", "-",
                                    "STOPPED")
        sub = meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
        knobs = dict(KNOBS, batch_size=64, learning_rate=1e-3,
                     weight_decay=1e-4, max_epochs=3, early_stop_epochs=5)
        t = meta.create_trial(sub["id"], model["id"], 1, "RUNNING",
                              knobs=knobs)
        meta.mark_trial_completed(t["id"], 0.5,
                                  params.save(_params(3), session_id="c"))
        inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
        svc = meta.create_service("INFERENCE", "DEPLOYING", node_id="card")
        bus = MemoryBus()
        k1 = attn.flash_attention
        k1_0, wg_0 = k1.launches, k1.variant_launches["wgmma"]
        worker = BusInferenceWorker(svc["id"], inf["id"], t["id"], meta,
                                    params, bus, device="cuda",
                                    node="card")
        fronts = []
        try:
            worker.start()
            deadline = time.monotonic() + WAIT_S
            while svc["id"] not in Cache(bus).running_workers(inf["id"]):
                assert worker.running and time.monotonic() < deadline
                time.sleep(0.05)
            assert Cache(bus).running_worker_info(inf["id"])[
                svc["id"]]["node"] == "card"
            launched = k1.launches - k1_0
            assert launched > 0
            assert k1.variant_launches["wgmma"] - wg_0 == launched
            for i in range(2):
                f = PredictorService.for_job(
                    f"cf{i}", inf["id"], None, bus, cache_bytes=1 << 20,
                    cache_admit_after=1, microbatch=False).start()
                f.predictor.gather_timeout = 5.0
                fronts.append(f)
            fa, fb = fronts
            assert fa._fabric and fb._fabric
            imgs = np.random.default_rng(0).integers(
                0, 256, (2, *SHAPE)).astype(np.uint8)
            q = encode_payload(imgs[0])
            a = _post(fa, "/predict", {"query": q})["prediction"]
            b = _post(fb, "/predict", {"query": q})["prediction"]
            assert a == b and worker.queries_served == 1
            c = registry().find("rafiki_tpu_serving_fabric_total")
            assert c.value(service=fb.stats.service, event="peer_hit") == 1
            _post(fa, "/cache/invalidate", {})
            assert c.value(service=fa.stats.service,
                           event="gossip_sent") == 1
            _post(fb, "/predict", {"query": q})
            assert worker.queries_served == 2
            before = registry().find(
                "rafiki_tpu_fault_injections_total")
            before = 0.0 if before is None else before.value(
                site="worker", kind="crash")
            faults.set_plan("worker.crash:n=1")
            _post(fa, "/predict", {"query": encode_payload(imgs[1])})
            deadline = time.monotonic() + WAIT_S
            while worker.running:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            assert registry().find("rafiki_tpu_fault_injections_total") \
                .value(site="worker", kind="crash") - before == 1
            # A hard death: the registration stays for supervise.
            assert svc["id"] in Cache(bus).running_workers(inf["id"])
        finally:
            faults.set_plan(None)
            for f in fronts:
                f.stop()
            worker.stop()
            meta.close()
            params.close()
