"""The port's processes: the docker and process container managers, the
service entry ``python -m rafiki_torch.container.services`` and the
``join`` CLI, over TCP brokers, on the CPU.

- ``DockerContainerManager`` with a fake CLI gives the reference's argv
  but for the module name (``tests/test_container_docker.py``'s cases).
- ``ProcessContainerManager`` runs an advisor service as a child on the
  CPU (``RAFIKI_TPU_PLATFORM=cpu``, ``jax`` unimportable there) over a
  TCP broker.
- The counterparts of ``tests/test_multinode.py`` on a small
  ``TorchFeedForward``: a ``join`` child that takes part of a 4-trial
  job, a secondary's shutdown that leaves no RUNNING rows, a restarted
  node that sweeps its rows, a foreign lease that expires, a broker
  restart mid-serving, and a persistent ``BusOpError`` that escalates.

Every wait on a child has its own timeout, and every child is killed
on the way out.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from rafiki_torch.bus import BusClient, BusOpError, BusServer, MemoryBus
from rafiki_torch.constants import (BudgetOption, EnvVars, ServiceStatus,
                                    ServiceType, TaskType, UserType)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FF = "rafiki_torch.models.feedforward:TorchFeedForward"
CHILD_S = 40.0

# A child's sitecustomize: jax and the reference raise when imported.
BLOCK = """import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'rafiki_tpu'):
            raise ImportError(name + ' is blocked in this process')
        return None
sys.meta_path.insert(0, _Block())
"""

SMALL_FF = """
import os
import time

from rafiki_torch.model import FixedKnob
from rafiki_torch.models.feedforward import TorchFeedForward

GATE = {gate!r}


class SmallFF(TorchFeedForward):
    # One small layer, one epoch; training waits for the gate file (if
    # one is named), so a second node's worker can take part.
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg.update(hidden_layer_count=FixedKnob(1),
                   hidden_layer_units=FixedKnob(16),
                   batch_size=FixedKnob(32), max_epochs=FixedKnob(1))
        return cfg

    def train(self, *args, **kwargs):
        deadline = time.monotonic() + 60
        while GATE and not os.path.exists(GATE) \\
                and time.monotonic() < deadline:
            time.sleep(0.05)
        return super().train(*args, **kwargs)
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from rafiki_torch.datasets import make_synthetic_image_dataset

    out = tmp_path_factory.mktemp("data")
    return make_synthetic_image_dataset(str(out), n_train=128, n_val=32,
                                        image_shape=(8, 8, 1), n_classes=4)


def _child_env(tmp_path):
    """The environment of a child: the repo importable, jax blocked, the
    CPU, few threads."""
    block = tmp_path / "block"
    block.mkdir(exist_ok=True)
    (block / "sitecustomize.py").write_text(BLOCK)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(block), REPO] + ([env["PYTHONPATH"]]
                              if env.get("PYTHONPATH") else []))
    env["RAFIKI_TPU_PLATFORM"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_the_block_fails_a_child_that_imports_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", "import jax"],
                         env=_child_env(tmp_path), capture_output=True,
                         text=True, timeout=CHILD_S)
    assert out.returncode != 0 and "blocked" in out.stderr


# --- DockerContainerManager (tests/test_container_docker.py) ---

class FakeDocker:
    def __init__(self):
        self.calls = []
        self.running = {}
        self.daemon_down = False

    def __call__(self, args):
        self.calls.append(list(args))
        if args[0] == "run":
            cid = f"cid{len(self.running)}"
            self.running[cid] = True
            return cid
        if args[0] == "rm":
            self.running.pop(args[-1], None)
            return ""
        if args[0] == "inspect":
            cid = args[-1]
            if self.daemon_down:
                raise subprocess.CalledProcessError(
                    1, ["docker"],
                    stderr="Cannot connect to the Docker daemon")
            if cid not in self.running:
                raise subprocess.CalledProcessError(
                    1, ["docker"], stderr=f"No such object: {cid}")
            return "true"
        raise AssertionError(args)


def _lifecycle(cls):
    fake = FakeDocker()
    mgr = cls(image="rafiki-tpu:test", runner=fake)
    cid = mgr.create_service("svc0123456789abc", {
        "RAFIKI_TPU_SERVICE_TYPE": "TRAIN", "RAFIKI_TPU_CHIPS": "0,1"})
    alive = [mgr.service_alive(cid)]
    mgr.destroy_service(cid)
    alive.append(mgr.service_alive(cid))
    return fake.calls, alive


def _mounts(cls):
    fake, fake2 = FakeDocker(), FakeDocker()
    cls(runner=fake, volumes=["/data:/data:ro"]).create_service(
        "s" * 16, {"RAFIKI_TPU_META_URI": "/var/rafiki/meta.db",
                   "RAFIKI_TPU_PARAMS_DIR": "/var/rafiki/params"})
    cls(runner=fake2).create_service("s" * 16, {
        "RAFIKI_TPU_META_URI": ":memory:",
        "RAFIKI_TPU_BUS_URI": "tcp://host:7777"})
    return fake.calls + fake2.calls, None


def _transient(cls):
    fake = FakeDocker()
    mgr = cls(runner=fake)
    cid = mgr.create_service("s" * 16, {})
    fake.daemon_down = True
    alive = [mgr.service_alive(cid)]
    fake.daemon_down = False
    alive.append(mgr.service_alive(cid))
    return fake.calls, alive


def _relative(cls):
    fake, fake2 = FakeDocker(), FakeDocker()
    cls(runner=fake).create_service("s" * 16, {
        "RAFIKI_TPU_META_URI": "/data/rafiki/meta.db",
        "RAFIKI_TPU_PARAMS_DIR": "/data/rafiki"})
    cls(runner=fake2).create_service("s" * 16, {
        "RAFIKI_TPU_META_URI": "rafiki/meta.db",
        "RAFIKI_TPU_PARAMS_DIR": "rafiki/params"})
    return fake.calls + fake2.calls, None


def _extra_args(cls):
    fake = FakeDocker()
    mgr = cls(runner=fake, extra_args=["--privileged"])
    mgr.create_service("s" * 16, {})
    alive = [mgr.service_alive("nope")]
    mgr.destroy_service("nope")  # logged, no raise
    return fake.calls, alive


@pytest.mark.parametrize("case", [_lifecycle, _mounts, _transient,
                                  _relative, _extra_args])
def test_docker_argv_is_the_references(case, tmp_path, monkeypatch):
    from rafiki_torch.container import DockerContainerManager as Port
    from rafiki_tpu.container import DockerContainerManager as Ref

    monkeypatch.chdir(tmp_path)
    port_calls, port_alive = case(Port)
    ref_calls, ref_alive = case(Ref)
    assert port_alive == ref_alive
    ref_calls = [["rafiki_torch.container.services"
                  if a == "rafiki_tpu.container.services" else a
                  for a in call] for call in ref_calls]
    assert port_calls == ref_calls
    runs = [c for c in port_calls if c[0] == "run"]
    assert runs and all(c[-3:] == ["python", "-m",
                                   "rafiki_torch.container.services"]
                        for c in runs)


# --- ProcessContainerManager: an advisor service as a child ---

def test_process_manager_runs_an_advisor_child(tmp_path, data,
                                               monkeypatch):
    from rafiki_torch.admin import ServicesManager
    from rafiki_torch.advisor.worker import RemoteAdvisor
    from rafiki_torch.container import ProcessContainerManager
    from rafiki_torch.parallel.chips import ChipAllocator
    from rafiki_torch.store import MetaStore

    for k, v in _child_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    broker = BusServer().start()
    work = tmp_path / "w"
    meta = MetaStore(str(work / "meta.db"))
    services = ServicesManager(
        meta, ProcessContainerManager(), ChipAllocator(1, device="cpu"),
        "host/test", log_dir=str(work / "logs"),
        meta_uri=str(work / "meta.db"), params_dir=str(work / "params"),
        bus_uri=broker.uri)
    svc = None
    try:
        model = meta.create_model("u", "ff", TaskType.IMAGE_CLASSIFICATION,
                                  FF, {})
        job = meta.create_train_job(
            "u", "app", TaskType.IMAGE_CLASSIFICATION,
            {BudgetOption.MODEL_TRIAL_COUNT: 3}, *data, status="RUNNING")
        sub = meta.create_sub_train_job(job["id"], model["id"], "RUNNING",
                                        advisor_type="random")
        svc = services._launch(ServiceType.ADVISOR,
                               {EnvVars.SUB_TRAIN_JOB_ID: sub["id"]})
        proc = services.container._procs[svc["id"]]
        advisor = RemoteAdvisor(BusClient(broker.host, broker.port),
                                sub["id"], timeout=CHILD_S)
        proposal = advisor.propose()
        assert proposal is not None
        assert set(proposal.knobs) >= {"hidden_layer_count",
                                       "learning_rate", "batch_size"}
        assert services.container.service_alive(svc["id"])
        services._stop_service(svc["id"])
        assert proc.wait(timeout=CHILD_S) == 0  # SIGTERM -> stop -> exit
        assert not services.container.service_alive(svc["id"])
        assert meta.get_service(svc["id"])["status"] == \
            ServiceStatus.STOPPED
        log = (work / "logs" / f"{svc['id']}.log")
        assert log.exists()
    finally:
        if svc is not None:
            services.container.destroy_service(svc["id"])
        meta.close()
        broker.stop()


# --- tests/test_multinode.py's counterparts ---

def _platform(path, broker, **kw):
    from rafiki_torch.platform import LocalPlatform

    return LocalPlatform(workdir=str(path), bus_uri=broker.uri,
                         supervise_interval=0, device="cpu", **kw)


def _small_model(admin, user_id, gate=""):
    return admin.create_model(user_id, "ff", TaskType.IMAGE_CLASSIFICATION,
                              "SmallFF",
                              model_source=SMALL_FF.format(gate=gate))


class _Lines:
    """A child's merged output, read on a thread."""

    def __init__(self, proc):
        self.lines = []
        self._t = threading.Thread(target=self._read, args=(proc,),
                                   daemon=True)
        self._t.start()

    def _read(self, proc):
        for line in proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, text, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any(text in line for line in self.lines):
                return True
            time.sleep(0.05)
        return False

    def join(self, timeout):
        self._t.join(timeout)


def test_one_job_split_across_a_join_child(tmp_path, data):
    """A ``python -m rafiki_torch join`` child shares the primary's meta
    store, params and TCP bus; the job's trials land on both nodes'
    workers, drawn from the one advisor service."""
    broker = BusServer().start()
    gate = tmp_path / "gate"
    shared = tmp_path / "shared"
    node_a = _platform(shared, broker)
    proc = None
    try:
        dev = node_a.admin.create_user("dev@x.c", "pw",
                                       UserType.MODEL_DEVELOPER)
        model = _small_model(node_a.admin, dev["id"], str(gate))
        job = node_a.admin.create_train_job(
            dev["id"], "app", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 4}, *data,
            advisor_type="random")
        proc = subprocess.Popen(
            [sys.executable, "-m", "rafiki_torch", "join", "--workdir",
             str(shared), "--bus", broker.uri, "--train-job", job["id"],
             "--timeout", "60"],
            env=_child_env(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        out = _Lines(proc)
        assert out.wait_for("attached 1 worker", CHILD_S), out.lines
        # Both nodes' workers hold a trial before the gate opens.
        sub = node_a.meta.get_sub_train_jobs(job["id"])[0]
        deadline = time.monotonic() + CHILD_S
        while len({t["worker_id"] for t in node_a.meta.get_trials(
                sub["id"])}) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        gate.write_text("")
        assert node_a.admin.wait_until_train_job_done(job["id"],
                                                      timeout=CHILD_S)
        assert proc.wait(timeout=CHILD_S) == 0, out.lines
        out.join(5)
        assert any("train job done" in line for line in out.lines)
        done = [t for t in node_a.meta.get_trials(sub["id"])
                if t["status"] == "COMPLETED"]
        assert len(done) == 4
        nodes = {node_a.meta.get_service(t["worker_id"])["node_id"]
                 for t in done}
        assert len(nodes) == 2 and node_a.services.node_id in nodes
        assert not any(r["status"] in ("RUNNING", "DEPLOYING", "STARTED")
                       for r in node_a.meta.get_services()
                       if r["node_id"] != node_a.services.node_id)
    finally:
        gate.write_text("")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=CHILD_S)
        node_a.shutdown()
        broker.stop()


def test_secondary_shutdown_leaves_no_running_rows(tmp_path, data):
    broker = BusServer().start()
    shared = tmp_path / "shared"
    node_a = _platform(shared, broker)
    node_b = None
    try:
        dev = node_a.admin.create_user("dev@x.c", "pw",
                                       UserType.MODEL_DEVELOPER)
        model = _small_model(node_a.admin, dev["id"])
        job = node_a.admin.create_train_job(
            dev["id"], "app", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 6}, *data,
            advisor_type="random")
        node_b = _platform(shared, broker, stop_jobs_on_shutdown=False,
                           node_id="vm/join-test", adopt_unowned=False)
        assert node_b.admin.attach_workers(job["id"])
        node_b.shutdown()  # leaves mid-job
        node_b = None
        rows = node_a.meta.get_services(node_id="vm/join-test")
        assert rows and all(r["status"] not in
                            ("RUNNING", "DEPLOYING", "STARTED")
                            for r in rows), rows
        # The primary completes the job on its own worker.
        assert node_a.admin.wait_until_train_job_done(job["id"],
                                                      timeout=CHILD_S)
        assert node_a.meta.get_train_job(job["id"])["status"] == "STOPPED"
    finally:
        if node_b is not None:
            node_b.shutdown()
        node_a.shutdown()
        broker.stop()


def test_restarted_node_sweeps_its_stale_rows(tmp_path):
    from rafiki_torch.platform import LocalPlatform
    from rafiki_torch.store import MetaStore

    shared = str(tmp_path / "node")
    p1 = LocalPlatform(workdir=shared, supervise_interval=0, device="cpu")
    node_id = p1.services.node_id
    p1.shutdown()
    # A crash's aftermath: a RUNNING row no restarted process knows.
    meta = MetaStore(shared + "/meta.db")
    stale = meta.create_service(ServiceType.ADVISOR, ServiceStatus.RUNNING,
                                container_id="gone", node_id=node_id)
    meta.close()
    p2 = LocalPlatform(workdir=shared, supervise_interval=0, device="cpu")
    try:
        assert p2.services.node_id == node_id  # a stable identity
        p2.services.supervise()
        assert p2.meta.get_service(stale["id"])["status"] == \
            ServiceStatus.ERRORED
        # A second primary on the workdir is refused.
        with pytest.raises(RuntimeError, match="another primary"):
            LocalPlatform(workdir=shared, supervise_interval=0,
                          device="cpu")
    finally:
        p2.shutdown()


def test_dead_foreign_node_lease_expires(tmp_path):
    from rafiki_torch.platform import LocalPlatform

    p = LocalPlatform(workdir=str(tmp_path / "n"), supervise_interval=0,
                      device="cpu")
    try:
        job = p.meta.create_train_job("u", "app", "IMAGE_CLASSIFICATION",
                                      {}, "tr", "va", status="RUNNING")
        sub = p.meta.create_sub_train_job(job["id"], "m", status="RUNNING")
        svc = p.meta.create_service(ServiceType.TRAIN,
                                    ServiceStatus.RUNNING,
                                    container_id="gone",
                                    node_id="otherhost/deadbeef")
        p.meta.add_train_job_worker(svc["id"], sub["id"])
        # A fresh lease (set at creation): trusted as live.
        assert p.services.train_services_active(job["id"])
        p.services.supervise()
        assert p.meta.get_service(svc["id"])["status"] == \
            ServiceStatus.RUNNING
        # The lease lapses: no longer live, and the sweep marks it.
        p.meta.update_service(
            svc["id"], heartbeat_at=time.time() - p.services.NODE_LEASE - 1)
        assert not p.services.train_services_active(job["id"])
        p.services.supervise()
        assert p.meta.get_service(svc["id"])["status"] == \
            ServiceStatus.ERRORED
        # A heartbeat refreshes a node's own rows.
        svc2 = p.meta.create_service(ServiceType.TRAIN,
                                     ServiceStatus.RUNNING,
                                     node_id="otherhost/deadbeef")
        p.meta.update_service(
            svc2["id"],
            heartbeat_at=time.time() - p.services.NODE_LEASE - 1)
        p.meta.touch_node_services("otherhost/deadbeef")
        assert time.time() - p.meta.get_service(
            svc2["id"])["heartbeat_at"] < 5
    finally:
        p.shutdown()


def _post(url, body, timeout):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_broker_restart_mid_serving_recovers(tmp_path, data, monkeypatch):
    """The broker keeps its queues and registry in memory: killed
    mid-serving and restarted empty on its port, the workers' 1 s
    re-registration refills it and serving answers again, with no
    supervise restart."""
    from rafiki_torch.cache import encode_payload
    from rafiki_torch.model.dataset import load_image_dataset

    monkeypatch.setenv("RAFIKI_TPU_WORKER_REREGISTER", "1.0")
    broker = BusServer().start()
    port = broker.port
    platform = _platform(tmp_path / "plat", broker, http=True)
    try:
        user = platform.admin.create_user("b@x.c", "pw",
                                          UserType.MODEL_DEVELOPER)
        model = _small_model(platform.admin, user["id"])
        job = platform.admin.create_train_job(
            user["id"], "serve", TaskType.IMAGE_CLASSIFICATION,
            [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 1}, *data,
            advisor_type="random")
        assert platform.admin.wait_until_train_job_done(job["id"],
                                                        timeout=CHILD_S)
        inf = platform.admin.create_inference_job(user["id"], job["id"],
                                                  max_models=1)
        host = platform.admin.get_inference_job(inf["id"])["predictor_host"]
        ds = load_image_dataset(data[1])
        batch = [encode_payload(ds.images[i]) for i in range(4)]

        def predict_ok(timeout):
            try:
                status, body = _post(f"http://{host}/predict",
                                     {"queries": batch}, timeout)
                return status == 200 and len(body["predictions"]) == 4 \
                    and all(p is not None for p in body["predictions"])
            except (urllib.error.URLError, OSError, ValueError):
                return False

        deadline = time.monotonic() + CHILD_S
        while not predict_ok(10) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert predict_ok(10), "serving never became ready"
        worker_ids = list(platform.services.active_inference_workers(
            inf["id"]))
        broker.stop()
        time.sleep(0.5)
        broker = BusServer(port=port).start()
        deadline = time.monotonic() + CHILD_S
        while not predict_ok(10) and time.monotonic() < deadline:
            time.sleep(0.5)
        assert predict_ok(10), "serving did not recover"
        # The same workers serve: none was restarted.
        assert platform.services.active_inference_workers(inf["id"]) == \
            worker_ids
        platform.admin.stop_inference_job(inf["id"])
    finally:
        platform.shutdown()
        broker.stop()


def test_persistent_bus_op_error_escalates_to_errored():
    """A broker that keeps REPORTING failures (``BusOpError``) makes the
    worker error out after ``max_op_errors`` laps without a good one;
    transport failures past the cap are retried until a stop."""
    from rafiki_torch.worker.inference import BusInferenceWorker

    class FakeMeta:
        def __init__(self):
            self.statuses = []

        def update_service(self, service_id, **fields):
            self.statuses.append(fields.get("status"))

    class Model:
        def predict_submit(self, queries):
            return lambda: [0] * len(queries)

        def destroy(self):
            pass

    def make_worker(exc_factory, fail_forever=True, n_failures=0):
        w = BusInferenceWorker("svc", "ij", "tr", FakeMeta(), None,
                               MemoryBus(), device="cpu", pipeline=False)
        w.max_op_errors = 3
        w._load_model = lambda: (Model(), None)
        calls = {"n": 0}

        class FlakyCache:
            def register_worker(self, *a, **k):
                pass

            def unregister_worker(self, *a, **k):
                pass

            def pop_queries(self, *a, **k):
                calls["n"] += 1
                if fail_forever or calls["n"] <= n_failures:
                    raise exc_factory()
                w.stop_flag.set()
                return []

        w.cache = FlakyCache()
        real_wait = w.stop_flag.wait
        w.stop_flag.wait = lambda t=None: real_wait(0.01)
        return w, calls

    w, calls = make_worker(lambda: BusOpError("bus error: unknown op"))
    with pytest.raises(BusOpError):
        w.run()
    assert w.meta.statuses[-1] == ServiceStatus.ERRORED
    assert calls["n"] == 4  # max_op_errors + 1 laps

    w2, calls2 = make_worker(lambda: ConnectionError("broker down"),
                             fail_forever=False, n_failures=6)
    w2.run()
    assert w2.meta.statuses[-1] == ServiceStatus.STOPPED
    assert calls2["n"] == 7


def test_kill_leaves_the_row_running_and_the_registration():
    """``kill`` is a dead node's wreckage: no STOPPED, no unregister;
    ``stop`` does both."""
    from rafiki_torch.cache import Cache
    from rafiki_torch.worker.inference import BusInferenceWorker

    class FakeMeta:
        def __init__(self):
            self.statuses = []

        def update_service(self, service_id, **fields):
            self.statuses.append(fields.get("status"))

    class Model:
        def destroy(self):
            pass

    for hard in (True, False):
        bus = MemoryBus()
        w = BusInferenceWorker("svc", "ij", "tr", FakeMeta(), None, bus,
                               device="cpu", pipeline=False)
        w._load_model = lambda: (Model(), None)
        w.start()
        deadline = time.monotonic() + CHILD_S
        while "svc" not in Cache(bus).running_workers("ij") \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        (w.kill if hard else w.stop)()
        assert not w.running
        assert ("svc" in Cache(bus).running_workers("ij")) is hard
        assert w.meta.statuses[-1] == (ServiceStatus.RUNNING if hard
                                       else ServiceStatus.STOPPED)
