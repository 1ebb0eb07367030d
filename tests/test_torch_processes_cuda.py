"""A service process on the card: ``python -m
rafiki_torch.container.services`` serving one ViT trial, launched by a
``ServicesManager`` on ``ProcessContainerManager`` over a TCP broker.

This test needs a CUDA device and skips without one. On a machine with a
card and without JAX, run it without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_processes_cuda.py

The child runs with jax made unimportable and loads the kernel libraries
this process built (it must not build them). It must launch K1 on its
wgmma variant (the count it prints at exit), and its answers, over the
bus and through its predictor, must equal this process's own forward of
the same parameters bit for bit.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import tempfile
import time
import urllib.request

import numpy as np
import pytest
import torch

from rafiki_torch.bus import BusClient, BusServer
from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.model.bridge import dense_to_jax
from rafiki_torch.models import TorchViT
from rafiki_torch.store import MetaStore, ParamStore

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 3)
KNOBS = {"d_model": 128, "n_heads": 4, "patch": 4, "depth": 2}
CHILD_S = 300.0

# The child's sitecustomize: jax blocked; at exit, its K1 launches and
# how it came by each kernel library, written where REPORT names.
SITE = """import atexit, importlib.abc, json, os, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'rafiki_tpu'):
            raise ImportError(name + ' is blocked in this process')
        return None
sys.meta_path.insert(0, _Block())
def _report():
    attn = sys.modules.get('rafiki_torch.ops.attention')
    build = sys.modules.get('rafiki_torch.ops._build')
    if attn is None:
        return
    f = attn.flash_attention
    with open(os.path.join(os.environ['REPORT'], '%d.json' % os.getpid()),
              'w') as out:
        json.dump({'k1': f.launches, 'wgmma': f.variant_launches['wgmma'],
                   'kernels': build.kernel_origins()}, out)
atexit.register(_report)
"""


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


def test_a_service_process_serves_a_vit_trial_exactly(card, monkeypatch):
    from rafiki_torch.admin import ServicesManager
    from rafiki_torch.container import ProcessContainerManager
    from rafiki_torch.ops import _build
    from rafiki_torch.parallel.chips import ChipAllocator

    _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        site, report = os.path.join(tmp, "site"), os.path.join(tmp, "rep")
        os.makedirs(site)
        os.makedirs(report)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(SITE)
        monkeypatch.setenv("PYTHONPATH", os.pathsep.join([site, REPO]))
        monkeypatch.setenv("REPORT", report)
        monkeypatch.delenv("RAFIKI_TPU_PLATFORM", raising=False)
        broker = BusServer().start()
        meta = MetaStore(os.path.join(tmp, "meta.db"))
        params = ParamStore(os.path.join(tmp, "params"))
        user = meta.create_user("p@x.c", "-", "MODEL_DEVELOPER")
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
                                  params.save(_params(3), session_id="p"))
        inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
        services = ServicesManager(
            meta, ProcessContainerManager(), ChipAllocator(1), "card/test",
            meta_uri=os.path.join(tmp, "meta.db"),
            params_dir=os.path.join(tmp, "params"), bus_uri=broker.uri)
        procs = {}
        try:
            services.create_inference_services(inf["id"], [t["id"]])
            procs = dict(services.container._procs)
            cache = Cache(BusClient(broker.host, broker.port))
            deadline = time.monotonic() + CHILD_S
            while not (cache.running_workers(inf["id"]) and meta.
                       get_inference_job(inf["id"])["predictor_host"]):
                assert all(p.poll() is None for p in procs.values()) \
                    and time.monotonic() < deadline, \
                    "the service processes did not come up"
                time.sleep(0.1)
            (wid,) = cache.running_workers(inf["id"])
            host = meta.get_inference_job(inf["id"])["predictor_host"]
            own = TorchViT(device="cuda", **knobs)
            own.load_parameters(_params(3))
            imgs = np.random.default_rng(0).integers(
                0, 256, (8, *SHAPE)).astype(np.uint8)
            for x in imgs:
                bid = cache.send_query_shards([(wid, 0, 1, "s")],
                                              [encode_payload(x)])
                (got,) = cache.gather_prediction_batches(bid, 1,
                                                         timeout=120)
                mine = np.asarray(own.predict([x])[0], np.float64)
                assert np.array_equal(
                    np.asarray(got["predictions"][0], np.float64), mine)
                req = urllib.request.Request(
                    f"http://{host}/predict",
                    data=json.dumps({"query": encode_payload(x)}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    served = json.loads(r.read())["prediction"]
                assert np.array_equal(np.asarray(served, np.float64), mine)
            services.stop_inference_services(inf["id"])
            assert all(p.poll() is not None for p in procs.values())
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
            meta.close()
            params.close()
            broker.stop()
        reps = []
        for name in os.listdir(report):
            with open(os.path.join(report, name)) as f:
                reps.append(json.load(f))
    (rep,) = reps  # the worker; the predictor never imports attention
    assert rep["k1"] > 0 and rep["wgmma"] == rep["k1"], rep
    assert set(rep["kernels"].values()) == {"loaded"}, rep
