"""The serving control loop armed on the card: a ViT bin of one replica
served from a ``LocalPlatform`` on CUDA, scaled up once by the
autoscaler.

This test needs a CUDA device and skips without one. On a machine with a
card and without JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_autoscale_cuda.py

The platform is built through ``NodeConfig`` with the autoscaler on and a
small admission queue; clients beyond the queue draw 429s, the next
supervise sweep records ``scale_up`` for ``backpressure``, and the new
replica's runner builds launch K1 on its wgmma variant before it
registers.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.models import TorchViT

pytestmark = pytest.mark.cuda

SHAPE = (32, 32, 3)
KNOBS = {"d_model": 128, "n_heads": 4, "patch": 4, "depth": 2,
         "batch_size": 64, "learning_rate": 1e-3, "weight_decay": 1e-4,
         "max_epochs": 3, "early_stop_epochs": 5}
QUEUE_CAP = 4
CLIENTS = 16
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


def _ask(host, image):
    req = urllib.request.Request(
        f"http://{host}/predict",
        data=json.dumps({"query": encode_payload(image)}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def _wait(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_backpressure_scales_a_vit_bin_up_on_the_card(card):
    from rafiki_torch.config import NodeConfig
    from rafiki_torch.ops import _build
    from rafiki_torch.ops import attention as attn
    from rafiki_torch.platform import LocalPlatform

    _build.build_all()
    saved = dict(os.environ)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = NodeConfig(workdir=tmp, port=0, supervise_interval=0,
                         autoscale=True, autoscale_max_replicas=2,
                         autoscale_up_cooldown_s=0.0,
                         autoscale_queue_high=1.0, autoscale_queue_low=0.25,
                         autoscale_mfu_floor=0.0,
                         serving_queue_cap=QUEUE_CAP).validate()
        cfg.apply_env()
        plat = LocalPlatform.from_config(cfg, http=True)
        stop = threading.Event()
        pool = None
        try:
            scaler = plat.services.autoscaler
            assert scaler is not None and plat.services.slo_engine is None
            root = plat.meta.get_user_by_email("superadmin@rafiki")
            model = plat.admin.create_model(
                root["id"], "vit", "IMAGE_CLASSIFICATION",
                "rafiki_torch.models.vit:TorchViT")
            job = plat.meta.create_train_job(
                root["id"], "vit", "IMAGE_CLASSIFICATION", {}, "-", "-",
                "STOPPED")
            sub = plat.meta.create_sub_train_job(job["id"], model["id"],
                                                 "STOPPED")
            t = plat.meta.create_trial(sub["id"], model["id"], 1,
                                       "RUNNING", knobs=KNOBS)
            plat.meta.mark_trial_completed(
                t["id"], 0.5, plat.params.save(_params(5), session_id="a"))
            inf = plat.admin.create_inference_job(root["id"], job["id"],
                                                  max_models=1)
            cache = Cache(plat.bus)
            _wait(lambda: len(cache.running_workers(inf["id"])) == 1,
                  "the bin's worker did not register")
            host = plat.admin.get_inference_job(inf["id"])["predictor_host"]
            imgs = np.random.default_rng(0).integers(
                0, 256, (8, *SHAPE)).astype(np.uint8)
            assert _ask(host, imgs[0]) == 200
            plat.services.supervise()  # the autoscaler's basis
            k1 = attn.flash_attention
            k1_0, wg_0 = k1.launches, k1.variant_launches["wgmma"]
            statuses = []

            def client(k):
                while not stop.is_set():
                    statuses.append(_ask(host, imgs[k % len(imgs)]))

            pool = ThreadPoolExecutor(CLIENTS)
            futs = [pool.submit(client, k) for k in range(CLIENTS)]
            _wait(lambda: 429 in statuses, "no 429 under the burst")
            up = []
            deadline = time.monotonic() + WAIT_S
            while not up:
                assert time.monotonic() < deadline, scaler.snapshot()
                plat.services.supervise()
                up = [d for d in scaler.snapshot()["decisions"]
                      if d["action"] == "scale_up"]
                time.sleep(0.1)
            stop.set()
            for f in futs:
                f.result(timeout=WAIT_S)
            assert up[0]["reason"] == "backpressure" and up[0]["applied"]
            _wait(lambda: len(cache.running_workers(inf["id"])) == 2,
                  "the new replica did not register")
            launched = k1.launches - k1_0
            assert launched > 0
            assert k1.variant_launches["wgmma"] - wg_0 == launched
            assert set(statuses) <= {200, 429}
        finally:
            stop.set()
            if pool is not None:
                pool.shutdown(wait=True)
            plat.shutdown()
            os.environ.clear()
            os.environ.update(saved)
