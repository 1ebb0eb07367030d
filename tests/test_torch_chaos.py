"""Injected faults driving the port's recovery loop, on the CPU (after
``tests/test_chaos.py`` and the reference's ``node.kill`` test in
``tests/test_cluster.py``), on a small ``TorchFeedForward``.

The fault plane injures the real stack and the checks are on recovery:
a replica crashed hard under load is respawned by ``supervise`` and
planned again while every request is answered; a broker restarted
between scatters heals within one request; a respawn without capacity
or of a stopped job degrades without crashing the sweep; and a
``node.kill`` of a secondary node leaves the bin answering from the
primary's replica until the secondary's next sweep respawns its own.
Every wait has a deadline.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from rafiki_torch import faults
from rafiki_torch.bus import serve_broker
from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.constants import (BudgetOption, InferenceJobStatus,
                                    ServiceStatus, ServiceType, TaskType,
                                    UserType)
from rafiki_torch.observe.metrics import registry

WAIT_S = 60.0
SMALL_FF = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models.feedforward import TorchFeedForward


class SmallFF(TorchFeedForward):
    # One small layer, one epoch.
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg.update(hidden_layer_count=FixedKnob(1),
                   hidden_layer_units=FixedKnob(16),
                   batch_size=FixedKnob(32), max_epochs=FixedKnob(1))
        return cfg
"""


@pytest.fixture(autouse=True)
def _clean_fault_plane(monkeypatch):
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    monkeypatch.delenv("RAFIKI_TPU_CLUSTER_FABRIC", raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from rafiki_torch.datasets import make_synthetic_image_dataset

    out = tmp_path_factory.mktemp("data")
    return make_synthetic_image_dataset(str(out), n_train=128, n_val=32,
                                        image_shape=(8, 8, 1), n_classes=4)


def _platform(path, **kw):
    from rafiki_torch.platform import LocalPlatform

    return LocalPlatform(workdir=str(path), supervise_interval=0,
                         device="cpu", **kw)


def _trained_job(platform, data, name):
    admin = platform.admin
    user = admin.create_user(f"{name}@x.c", "pw", UserType.MODEL_DEVELOPER)
    model = admin.create_model(user["id"], name,
                               TaskType.IMAGE_CLASSIFICATION, "SmallFF",
                               model_source=SMALL_FF)
    job = admin.create_train_job(
        user["id"], name, TaskType.IMAGE_CLASSIFICATION, [model["id"]],
        {BudgetOption.MODEL_TRIAL_COUNT: 1}, *data, advisor_type="random")
    assert admin.wait_until_train_job_done(job["id"], timeout=WAIT_S)
    return user, job


def _batch(data, n=3):
    from rafiki_torch.model.dataset import load_image_dataset

    ds = load_image_dataset(data[1])
    return [encode_payload(ds.images[i]) for i in range(n)]


def _predict(host, batch, timeout=60):
    """(status, predictions); a transport failure is status 0."""
    req = urllib.request.Request(
        f"http://{host}/predict", data=json.dumps({"queries": batch})
        .encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())["predictions"]
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, None
    except OSError:
        return 0, None


def _full(answer, n):
    status, preds = answer
    return status == 200 and len(preds) == n and \
        all(p is not None for p in preds)


def _wait(cond, what, secs=WAIT_S):
    deadline = time.monotonic() + secs
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _predictor(platform):
    row = next(s for s in platform.meta.get_services()
               if s["service_type"] == ServiceType.PREDICT
               and s["status"] == ServiceStatus.RUNNING)
    return platform.container.get(row["id"]).predictor


def _replicas_in_plan(predictor):
    groups, _, _ = predictor._group_replicas()
    return sum(len(members) for members in groups.values())


def _injections(site, kind):
    c = registry().find("rafiki_tpu_fault_injections_total")
    return 0.0 if c is None else c.value(site=site, kind=kind)


def test_a_replica_crashed_under_load_respawns_and_is_planned_again(
        tmp_path, data):
    platform = _platform(tmp_path / "p", http=True, n_chips=2)
    stop = threading.Event()
    answers = []
    clients = []
    try:
        user, job = _trained_job(platform, data, "ffcrash")
        # Armed quietly before the serving stack is built: its sites
        # hold hooks, nothing fires yet.
        faults.set_plan("")
        inf = platform.admin.create_inference_job(user["id"], job["id"],
                                                  max_models=1)
        host = platform.admin.get_inference_job(inf["id"])["predictor_host"]
        trial_id = platform.services.active_inference_workers(
            inf["id"])[0]["trial_id"]
        assert platform.services.add_inference_worker(inf["id"], trial_id)
        cache = Cache(platform.bus)
        _wait(lambda: len(cache.running_workers(inf["id"])) == 2,
              "the two replicas did not register")
        predictor = _predictor(platform)
        # The dead replica's shard is resubmitted at the straggler
        # deadline; a short gather keeps the test's window small.
        predictor.gather_timeout = 4.0
        batch = _batch(data)
        _wait(lambda: _full(_predict(host, batch), 3)
              and _replicas_in_plan(predictor) == 2,
              "the bin of two replicas did not serve")
        workers0 = set(cache.running_workers(inf["id"]))

        def load():
            while not stop.is_set():
                answers.append(_predict(host, batch))

        clients = [threading.Thread(target=load, daemon=True)
                   for _ in range(4)]
        for t in clients:
            t.start()
        before = _injections("worker", "crash")
        faults.set_plan("worker.crash:n=1")
        dead = []
        _wait(lambda: dead.extend(
            sid for sid in workers0
            if not platform.container.get(sid).running) or dead,
            "the injected crash never fired")
        (dead_id,) = dead
        assert _injections("worker", "crash") - before == 1
        # A hard death: the row RUNNING, the registration stale.
        assert platform.meta.get_service(dead_id)["status"] == \
            ServiceStatus.RUNNING
        assert dead_id in cache.running_workers(inf["id"])
        restarted = platform.services.supervise()
        assert len(restarted) == 1
        assert platform.meta.get_service(dead_id)["status"] == \
            ServiceStatus.ERRORED
        bins = {w["service_id"]: w["trial_id"] for w in
                platform.meta.get_inference_job_workers(inf["id"])}
        assert bins[restarted[0]] == bins[dead_id] == trial_id
        assert dead_id not in cache.running_workers(inf["id"])
        _wait(lambda: restarted[0] in cache.running_workers(inf["id"])
              and _replicas_in_plan(predictor) == 2,
              "the respawned replica was not planned again")
        assert _full(_predict(host, batch), 3)
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=WAIT_S)
        faults.set_plan(None)
        platform.shutdown()
    # Every request sent under the crash was answered in full.
    assert answers and all(_full(a, 3) for a in answers), \
        sorted({a[0] for a in answers})


def test_a_broker_restart_between_scatters_heals_in_one_request(
        tmp_path, data, monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_WORKER_REREGISTER", "1.0")
    broker = serve_broker("127.0.0.1", 0, native=False)
    port = broker.port
    platform = _platform(tmp_path / "p", http=True, bus_uri=broker.uri)
    try:
        user, job = _trained_job(platform, data, "ffbroker")
        inf = platform.admin.create_inference_job(user["id"], job["id"],
                                                  max_models=1)
        host = platform.admin.get_inference_job(inf["id"])["predictor_host"]
        batch = _batch(data, 4)
        _wait(lambda: _full(_predict(host, batch), 4),
              "serving never became ready")
        broker.stop()
        time.sleep(0.5)
        broker = serve_broker("127.0.0.1", port, native=False)
        # One request, no retry: the client's reconnection and the
        # worker's 1 s re-registration carry it through, and each query
        # gets one prediction.
        status, preds = _predict(host, batch, timeout=120)
        assert status == 200 and len(preds) == 4
        assert all(p is not None for p in preds)
        platform.admin.stop_inference_job(inf["id"])
    finally:
        platform.shutdown()
        broker.stop()


def test_supervise_without_capacity_and_with_a_stopped_job(tmp_path,
                                                           monkeypatch):
    platform = _platform(tmp_path / "p")
    try:
        meta = platform.meta
        node = platform.services.node_id
        job = meta.create_inference_job("u-x", "tj-x",
                                        InferenceJobStatus.RUNNING)
        svc = meta.create_service(ServiceType.INFERENCE,
                                  ServiceStatus.RUNNING, chips=[0],
                                  node_id=node)
        meta.add_inference_job_worker(svc["id"], job["id"], "trial-x")

        # No capacity: the dead replica goes ERRORED, nothing restarts,
        # the sweep survives, and the replica waits on the queue.
        monkeypatch.setattr(platform.services.allocator, "allocate",
                            lambda *a, **kw: None)
        assert platform.services.supervise() == []
        assert meta.get_service(svc["id"])["status"] == \
            ServiceStatus.ERRORED
        assert [p["id"] for p in platform.services._pending_respawns] \
            == [svc["id"]]
        # A sweep that dies mid-scan keeps the queue.
        monkeypatch.setattr(
            platform.services.meta, "get_services",
            lambda **kw: (_ for _ in ()).throw(RuntimeError("db busy")))
        with pytest.raises(RuntimeError, match="db busy"):
            platform.services.supervise()
        assert [p["id"] for p in platform.services._pending_respawns] \
            == [svc["id"]]
        # Capacity frees: the next sweep retries the queued replica.
        monkeypatch.undo()
        admitted = []
        monkeypatch.setattr(
            platform.services, "add_inference_worker",
            lambda job_id, trial_id, **kw: (
                admitted.append((job_id, trial_id)) or {"id": "svc-new"}))
        assert platform.services.supervise() == ["svc-new"]
        assert admitted == [(job["id"], "trial-x")]
        assert platform.services._pending_respawns == []

        # A stopped job's dead replica is never resurrected.
        monkeypatch.undo()
        meta.update_inference_job(job["id"],
                                  status=InferenceJobStatus.STOPPED)
        svc2 = meta.create_service(ServiceType.INFERENCE,
                                   ServiceStatus.RUNNING, chips=[0],
                                   node_id=node)
        meta.add_inference_job_worker(svc2["id"], job["id"], "trial-x")
        free_before = platform.allocator.free_chips
        assert platform.services.supervise() == []
        assert meta.get_service(svc2["id"])["status"] == \
            ServiceStatus.ERRORED
        assert platform.allocator.free_chips == free_before
        assert platform.services._pending_respawns == []
    finally:
        platform.shutdown()


def test_node_kill_leaves_the_bin_answering_and_respawns_the_replica(
        tmp_path, data):
    broker = serve_broker("127.0.0.1", 0, native=False)
    shared = tmp_path / "shared"
    faults.set_plan("")  # armed quietly before any stack exists
    node_a = _platform(shared, http=True, bus_uri=broker.uri)
    node_b = None
    try:
        user, job = _trained_job(node_a, data, "ffnodekill")
        inf = node_a.admin.create_inference_job(user["id"], job["id"],
                                                max_models=1)
        host = node_a.admin.get_inference_job(inf["id"])["predictor_host"]
        predictor = _predictor(node_a)
        predictor.gather_timeout = 4.0
        trial_id = node_a.services.active_inference_workers(
            inf["id"])[0]["trial_id"]
        # A secondary node attaches one replica of the same bin.
        node_b = _platform(shared, bus_uri=broker.uri,
                           stop_jobs_on_shutdown=False, adopt_unowned=False,
                           node_id="vm/chaos-b")
        svc_b = node_b.services.add_inference_worker(inf["id"], trial_id)
        assert svc_b is not None
        batch = _batch(data)
        _wait(lambda: _full(_predict(host, batch), 3)
              and _replicas_in_plan(predictor) == 2,
              "the secondary's replica never joined the plan")

        before = _injections("node", "kill")
        faults.set_plan("node.kill:op=vm/chaos-b,n=1")
        assert node_a.services.supervise() == []  # op= spares node a
        node_b.services.supervise()
        assert _injections("node", "kill") - before == 1
        # A hard death: the slot gone, the row still RUNNING.
        assert node_b.container.get(svc_b["id"]) is None
        assert node_a.meta.get_service(svc_b["id"])["status"] == \
            ServiceStatus.RUNNING
        # The bin answers from the primary's replica.
        assert _full(_predict(host, batch), 3)
        # The secondary's next sweep finds its wreckage and respawns it.
        respawned = []
        _wait(lambda: respawned.extend(node_b.services.supervise())
              or respawned, "the secondary never respawned its replica")
        assert len(respawned) == 1
        assert node_a.meta.get_service(respawned[0])["node_id"] == \
            "vm/chaos-b"
        _wait(lambda: _full(_predict(host, batch), 3)
              and _replicas_in_plan(predictor) == 2,
              "the respawned replica never rejoined the plan")
    finally:
        faults.set_plan(None)
        if node_b is not None:
            node_b.shutdown()
        node_a.shutdown()
        broker.stop()


class _Replica:
    """A replica over the cache protocol answering ``[q, q + 0.5]`` a
    query after ``delay`` seconds; ``dead`` swallows its frames."""

    def __init__(self, bus, cache_cls, worker_id):
        self.cache = cache_cls(bus)
        self.worker_id = worker_id
        self.delay = 0.0
        self.dead = False
        self.stop_flag = threading.Event()
        self.cache.register_worker("job", worker_id, info={"trial_id": "tA"})
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self.stop_flag.is_set():
            for it in self.cache.pop_queries(self.worker_id, timeout=0.05):
                if self.dead:
                    continue
                time.sleep(self.delay)
                self.cache.send_prediction_batch(
                    it["batch_id"], self.worker_id,
                    [[float(q), float(q) + 0.5] for q in it["queries"]],
                    shard=it.get("shard"))

    def stop(self):
        self.stop_flag.set()
        self._thread.join(timeout=5)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_a_dead_replica_s_shard_waits_for_a_slow_sibling(package):
    """One bin, two replicas: one dies while the other turns slow, so
    both miss the straggler deadline. The port resubmits the dead
    replica's shard to the sibling once that sibling answers its own,
    and every query is answered; the reference never resubmits to a
    sibling that missed the same deadline, and the dead replica's
    queries come back None."""
    if package == "port":
        from rafiki_torch.bus import MemoryBus
        from rafiki_torch.cache import Cache as cache_cls
        from rafiki_torch.predictor.predictor import Predictor
    else:
        from rafiki_tpu.bus import MemoryBus
        from rafiki_tpu.cache import Cache as cache_cls
        from rafiki_tpu.predictor.predictor import Predictor
    bus = MemoryBus()
    reps = [_Replica(bus, cache_cls, w) for w in ("wA1", "wA2")]
    p = Predictor("job", bus, gather_timeout=3.0, worker_wait_timeout=5.0,
                  shard_replicas=True)
    try:
        qs = list(range(8))
        want = [[float(q), float(q) + 0.5] for q in qs]
        for _ in range(3):  # measured: the straggler deadline ~25 ms
            assert p.predict(qs) == want
        reps[0].dead = True
        reps[1].delay = 0.3
        t0 = time.monotonic()
        got = p.predict(qs)
        took = time.monotonic() - t0
        if package == "port":
            assert got == want
            assert took < 2.5  # rescued, not the gather timeout
        else:
            assert None in got and took >= 2.5
    finally:
        p.close()
        for r in reps:
            r.stop()
