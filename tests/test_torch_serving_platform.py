"""The serving front on the port's platform, on the CPU: a
``TorchFeedForward`` job served micro-batched answers as the direct path
does within 1e-6; a replica attached to every bin
(``Admin.attach_inference_workers``) takes shards; and the admin's
``GET /metrics``, ``GET /inference_jobs/<id>/stats`` and ``GET
/trace/<id>`` read the serving front."""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import threading
import urllib.request

import numpy as np
import pytest

from rafiki_torch.cache import Cache
from rafiki_torch.client import Client
from rafiki_torch.constants import BudgetOption, TaskType, UserType
from rafiki_torch.observe.metrics import parse_exposition
from rafiki_torch.predictor import PredictorService

PORT_FF = "rafiki_torch.models.feedforward:TorchFeedForward"
TOL_MEAN = 1e-6
TRACE_ID = "5e" * 16
SERVING_FAMILIES = ("rafiki_tpu_serving_requests_total",
                    "rafiki_tpu_serving_batches_total",
                    "rafiki_tpu_serving_batched_queries_total",
                    "rafiki_tpu_serving_stage_seconds_bucket",
                    "rafiki_tpu_serving_shards_total",
                    "rafiki_tpu_http_request_seconds_bucket")


@pytest.fixture(scope="module")
def served(tmp_path_factory, synth_image_data):
    """A port platform on 4 CPU chips serving a 2-trial FeedForward job
    (one worker a trial bin), with a developer's ``Client``."""
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.platform import LocalPlatform

    p = LocalPlatform(workdir=str(tmp_path_factory.mktemp("front")),
                      device="cpu", supervise_interval=0, n_chips=4,
                      http=True)
    try:
        train_path, val_path = synth_image_data
        root = Client(admin_port=p.admin_port)
        root.login("superadmin@rafiki", "rafiki")
        root.create_user("dev@x.c", "pw", UserType.MODEL_DEVELOPER)
        dev = Client(admin_port=p.admin_port)
        token = dev.login("dev@x.c", "pw")["token"]
        model = dev.create_model("ff", TaskType.IMAGE_CLASSIFICATION,
                                 PORT_FF)
        job = dev.create_train_job(
            "front", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 2}, train_path, val_path,
            advisor_type="random")
        dev.wait_until_train_job_done(job["id"], timeout=600, poll=0.2)
        inf = dev.create_inference_job(job["id"], max_models=2)
        host = dev.get_inference_job(inf["id"])["predictor_host"]
        # Both bins' workers registered: a request that comes earlier is
        # answered by the bins that are there.
        cache = Cache(p.bus)
        for _ in range(1200):
            if len(cache.running_workers(inf["id"])) == 2:
                break
            threading.Event().wait(0.05)
        assert len(cache.running_workers(inf["id"])) == 2
        val = load_image_dataset(val_path)
        yield {"p": p, "dev": dev, "token": token, "inf": inf,
               "host": host, "images": [val.images[i] for i in range(24)]}
    finally:
        p.shutdown()


def _admin_get(served, path, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{served['p'].admin_port}{path}",
        headers={"Authorization": f"Bearer {served['token']}",
                 **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read().decode()


def _concurrent(client, host, images):
    out = [None] * len(images)

    def one(i):
        out[i] = client.predict(host, query=images[i])["prediction"]

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(images))]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    return np.asarray(out, np.float64)


def test_microbatched_predict_equals_the_direct_path(served):
    p, dev, inf = served["p"], served["dev"], served["inf"]
    svc = p.container.get([w["service_id"] for w in
                           p.meta.get_inference_job_workers(inf["id"])
                           if w["trial_id"] == "__predictor__"][0])
    assert svc.batcher is not None and svc.microbatch
    batched = _concurrent(dev, served["host"], served["images"])
    direct_svc = PredictorService.for_job("direct", inf["id"], None, p.bus,
                                          microbatch=False).start()
    try:
        assert direct_svc.batcher is None
        direct = _concurrent(dev, f"127.0.0.1:{direct_svc.port}",
                             served["images"])
        whole = np.asarray(dev.predict(served["host"],
                                       queries=served["images"])
                           ["predictions"], np.float64)
    finally:
        direct_svc.stop()
    assert batched.shape == (24, 4)
    assert np.abs(batched - direct).max() <= TOL_MEAN
    assert np.abs(whole - direct).max() <= TOL_MEAN
    stats = json.loads(_admin_get(
        served, f"/inference_jobs/{inf['id']}/stats"))
    assert stats["inference_job_id"] == inf["id"]
    assert stats["microbatch"] is True and stats["requests"] >= 25
    assert stats["batches"] >= 1 and stats["shard_replicas"] is True


def test_attached_replicas_take_shards_and_the_admin_reads_the_front(
        served):
    p, dev, inf = served["p"], served["dev"], served["inf"]
    before = Cache(p.bus).running_worker_info(inf["id"])
    assert len(before) == 2  # one worker a trial bin
    attached = p.admin.attach_inference_workers(inf["id"])
    assert len(attached) == 2
    cache = Cache(p.bus)
    for _ in range(600):
        if len(cache.running_workers(inf["id"])) == 4:
            break
        threading.Event().wait(0.1)
    info = cache.running_worker_info(inf["id"])
    assert len(info) == 4
    assert sorted(i["trial_id"] for i in info.values()) == sorted(
        2 * [i["trial_id"] for i in before.values()])
    alone = np.asarray(dev.predict(served["host"], queries=served["images"])
                       ["predictions"], np.float64)
    direct = []
    for img in served["images"]:
        direct.append(dev.predict(served["host"], query=img)["prediction"])
    assert np.abs(alone - np.asarray(direct)).max() <= TOL_MEAN
    # A traced request: its edge, batcher and worker spans, stitched.
    req = urllib.request.Request(
        f"http://{served['host']}/predict",
        data=json.dumps({"queries": [served["images"][0].tolist()]})
        .encode(), headers={"Content-Type": "application/json",
                            "X-Trace-Id": TRACE_ID})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["X-Trace-Id"].startswith(TRACE_ID)
    trace = json.loads(_admin_get(served, f"/trace/{TRACE_ID}"))
    names = [s["name"] for s in trace["spans"]]
    for name in ("http POST /predict", "predictor.scatter",
                 "predictor.gather", "worker.predict"):
        assert name in names, names
    assert names.count("worker.predict") == 2  # one a bin
    # /metrics, on the admin's server (no token) and the predictor's.
    for text in (_admin_get(served, "/metrics"),
                 urllib.request.urlopen(f"http://{served['host']}/metrics",
                                        timeout=30).read().decode()):
        families = parse_exposition(text)
        for fam in SERVING_FAMILIES:
            assert fam in families, fam
    replicas = {labels["worker"]
                for labels, v in families[
                    "rafiki_tpu_serving_replica_gather_seconds_count"]
                if v > 0}
    assert {w[:8] for w in info} <= replicas
