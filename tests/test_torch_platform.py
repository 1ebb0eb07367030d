"""The port's platform (``rafiki_torch.platform.LocalPlatform``) held
against the reference's, on the CPU.

Each test builds both platforms on the same synthetic image set: the
reference's on JAX's CPU (8 virtual devices, ``tests/conftest.py``) and
the port's with ``device="cpu"`` and as many chips. Both train with
``advisor_type="random"`` (the reference would pick Bayes for the
feed-forward knob space; the port has only the random advisor).

The same ``Client`` call sequence runs against both, and every answer's
HTTP status and key set must match, as must the trial counts by status.
Numbers: the port's ``/predict`` answer for a two-trial bin equals the
float64 mean of the two members' own ``predict`` within 1e-6, and
``JaxFeedForward.predict`` on the same params files (read through the
reference's ``ParamStore``) within 3.9e-3, one bf16 ulp of a logit
below 4 (``tests/test_torch_feedforward.py``).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import re
import time
from urllib.parse import urlparse

import numpy as np
import pytest

from rafiki_torch.client import Client, ClientError
from rafiki_torch.constants import (BudgetOption, ServiceStatus, ServiceType,
                                    TaskType, TrialStatus, UserType)

PORT_FF = "rafiki_torch.models.feedforward:TorchFeedForward"
REF_FF = "rafiki_tpu.models.feedforward:JaxFeedForward"
N_CHIPS = 8
TOL_MEAN = 1e-6
TOL_JAX = 3.9e-3


def _port(path, **kw):
    from rafiki_torch.platform import LocalPlatform

    kw.setdefault("n_chips", N_CHIPS)
    return LocalPlatform(workdir=str(path), device="cpu",
                         supervise_interval=0, **kw)


def _ref(path, **kw):
    from rafiki_tpu.platform import LocalPlatform

    return LocalPlatform(workdir=str(path), supervise_interval=0, **kw)


@pytest.fixture()
def both(tmp_path):
    """(kind, platform, model class path) of each package, HTTP on."""
    made = []
    try:
        made.append(("port", _port(tmp_path / "port", http=True), PORT_FF))
        made.append(("ref", _ref(tmp_path / "ref", http=True), REF_FF))
        yield made
    finally:
        for _, p, _ in made:
            p.shutdown()


_ID = re.compile(r"[0-9a-f]{32}")


def _keys(payload):
    if isinstance(payload, dict):
        return ("dict", tuple(sorted(payload)))
    if isinstance(payload, list):
        return ("list", tuple(sorted({k for x in payload
                                      if isinstance(x, dict) for k in x})))
    return (type(payload).__name__,)


class Recording(Client):
    """The port's ``Client``, noting each answer's status and key set
    (ids in paths masked) while ``log`` is a list."""

    log = None

    def _send(self, method, url, body, headers):
        status, payload, hdrs = super()._send(method, url, body, headers)
        if self.log is not None:
            path = _ID.sub("<id>", urlparse(url).path)
            self.log.append((method, path, status, _keys(payload)))
        return status, payload, hdrs


def _flow(platform, ff_class, data, max_models=2):
    """The quickstart's calls, plus the listings and status reads;
    returns the answers' log and what the flow made."""
    train_path, val_path = data
    log = []
    root = Recording(admin_port=platform.admin_port)
    root.log = log
    root.login("superadmin@rafiki", "rafiki")
    root.create_user("dev@x.c", "pw", UserType.MODEL_DEVELOPER)
    dev = Recording(admin_port=platform.admin_port)
    dev.log = log
    dev.login("dev@x.c", "pw")
    model = dev.create_model("ff", TaskType.IMAGE_CLASSIFICATION, ff_class)
    dev.get_models(task=TaskType.IMAGE_CLASSIFICATION)
    job = dev.create_train_job(
        "app", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
        {BudgetOption.MODEL_TRIAL_COUNT: 2}, train_path, val_path,
        advisor_type="random")
    dev.log = None  # the polls differ in number
    done = dev.wait_until_train_job_done(job["id"], timeout=600, poll=0.2)
    dev.log = log
    dev.get_train_job(job["id"])
    dev.get_train_jobs()
    trials = dev.get_trials_of_train_job(job["id"])
    best = dev.get_best_trials_of_train_job(job["id"], max_count=2)
    dev.get_trial_logs(best[0]["id"])
    inf = dev.create_inference_job(job["id"], max_models=max_models)
    host = dev.get_inference_job(inf["id"])["predictor_host"]
    dev.get_inference_jobs()
    from rafiki_torch.model.dataset import load_image_dataset

    val = load_image_dataset(val_path)
    one = dev.predict(host, query=val.images[0])
    many = dev.predict(host, queries=[val.images[i] for i in range(6)])
    dev.get_services()
    root.get_services()
    root.get_status()
    root.get_users()
    dev.stop_inference_job(inf["id"])
    dev.stop_train_job(job["id"])
    return log, {"done": done, "trials": trials, "best": best, "inf": inf,
                 "one": one, "many": many, "val": val}


def _by_status(trials):
    out = {}
    for t in trials:
        out[t["status"]] = out.get(t["status"], 0) + 1
    return out


def test_client_sequence_matches_the_reference(both, synth_image_data):
    runs = {kind: _flow(p, ff, synth_image_data) for kind, p, ff in both}
    (plog, port), (rlog, ref) = runs["port"], runs["ref"]
    assert plog == rlog
    for out in (port, ref):
        assert out["done"]["status"] == "STOPPED"
        assert len(out["many"]["predictions"]) == 6
        assert len(out["one"]["prediction"]) == 4
    assert _by_status(port["trials"]) == _by_status(ref["trials"]) == \
        {TrialStatus.COMPLETED: 2}
    # The served classes are right on this separable set, as the
    # reference's are.
    val = port["val"]
    acc = np.mean([int(np.argmax(p)) == val.labels[i]
                   for i, p in enumerate(port["many"]["predictions"])])
    assert acc > 0.3


def _status_of(fn):
    try:
        fn()
    except ClientError as e:
        return e.status
    return 200


def test_auth_rejections_and_ownership_match_the_reference(
        both, synth_image_data):
    train_path, val_path = synth_image_data
    seen = {}
    for kind, p, ff in both:
        anon = Client(admin_port=p.admin_port)
        root = Client(admin_port=p.admin_port)
        codes = [_status_of(lambda: anon.login("superadmin@rafiki", "no")),
                 _status_of(anon.get_models),
                 _status_of(lambda: anon.get_train_job("x"))]
        root.login("superadmin@rafiki", "rafiki")
        root.create_user("mdev@x.c", "pw", UserType.MODEL_DEVELOPER)
        root.create_user("app@x.c", "pw", UserType.APP_DEVELOPER)
        app = Client(admin_port=p.admin_port)
        app.login("app@x.c", "pw")
        codes += [_status_of(lambda: app.create_user(
                      "x@y.z", "pw", UserType.ADMIN)),
                  _status_of(lambda: app.create_model(
                      "m", TaskType.IMAGE_CLASSIFICATION, ff)),
                  _status_of(app.get_users)]
        mdev = Client(admin_port=p.admin_port)
        mdev.login("mdev@x.c", "pw")
        model = mdev.create_model("ff-own", TaskType.IMAGE_CLASSIFICATION,
                                  ff)
        job = mdev.create_train_job(
            "own-app", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 1}, train_path, val_path,
            advisor_type="random")
        # Another user may not read, stop or deploy the job, nor see
        # its services; an admin may read it.
        codes += [_status_of(lambda: app.get_train_job(job["id"])),
                  _status_of(lambda: app.stop_train_job(job["id"])),
                  _status_of(lambda: app.get_best_trials_of_train_job(
                      job["id"])),
                  _status_of(lambda: app.create_inference_job(job["id"])),
                  _status_of(lambda: root.get_train_job(job["id"]))]
        codes.append(len(app.get_services()))
        mdev.wait_until_train_job_done(job["id"], timeout=600, poll=0.2)
        trial = mdev.get_trials_of_train_job(job["id"])[0]
        codes.append(_status_of(lambda: app.get_trial_logs(trial["id"])))
        # A ban revokes the session at once; the superadmin cannot be
        # banned, nor can one ban oneself.
        users = {u["email"]: u for u in root.get_users()}
        codes.append(_status_of(lambda: root.ban_user(
            users["superadmin@rafiki"]["id"])))
        root.ban_user(users["app@x.c"]["id"])
        codes.append(_status_of(app.get_models))
        codes.append(_status_of(lambda: app.login("app@x.c", "pw")))
        seen[kind] = codes
    assert seen["port"] == seen["ref"]
    assert seen["port"][:6] == [401, 401, 401, 403, 403, 403]
    assert seen["port"][6:11] == [403, 403, 403, 403, 200]


def test_unported_routes_answer_404(both):
    import urllib.error
    import urllib.request

    port = both[0][1]
    root = Client(admin_port=port.admin_port)
    root.login("superadmin@rafiki", "rafiki")
    for method, path in (("GET", "/"), ("GET", "/autoscale"),
                         ("GET", "/nodes"), ("GET", "/slo"),
                         ("GET", "/alerts"), ("GET", "/capacity"),
                         ("GET", "/datasets"), ("POST", "/datasets"),
                         ("GET", "/services/abc/logs")):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port.admin_port}{path}", method=method,
            headers={"Authorization": f"Bearer {root._token}"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404, path


def _call(port, token, method, path, body=None):
    """One admin call: (status, JSON body)."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Authorization": f"Bearer {token}",
                 "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_for_trace(path, timeout=30.0):
    import glob
    import os

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        found = glob.glob(os.path.join(path, "*.pt.trace.json"))
        if found:
            return found
        time.sleep(0.1)
    return []


def test_trial_phases_and_profile_routes_answer(tmp_path, synth_image_data):
    """The two routes ported with the observability plane answer:
    ``GET /trial_phases`` counts one propose, train, eval and persist a
    trial (and two loads and stages: train's and eval's); ``POST
    /inference_jobs/<id>/profile`` clamps its duration to [0.5, 60] s,
    refuses a bad duration and a job that is not RUNNING, and the worker
    writes its profile into the directory the answer names."""
    import json

    from rafiki_torch.observe import phases

    train_path, val_path = synth_image_data
    before = phases.phase_totals()
    p = _port(tmp_path, http=True, n_chips=1)
    try:
        root = Client(admin_port=p.admin_port)
        root.login("superadmin@rafiki", "rafiki")
        token = root._token
        model = root.create_model("ff", TaskType.IMAGE_CLASSIFICATION,
                                  PORT_FF)
        job = root.create_train_job(
            "app", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 2}, train_path, val_path,
            advisor_type="random")
        root.wait_until_train_job_done(job["id"], timeout=600, poll=0.2)
        status, body = _call(p.admin_port, token, "GET", "/trial_phases")
        assert status == 200
        assert set(body) == {"enabled", "resident", "phases", "caches"}
        assert body["resident"] and body["enabled"]
        counts = {k: v["count"] - before[k]["count"]
                  for k, v in body["phases"].items()}
        assert counts == {"propose": 2, "load": 4, "stage": 4,
                          "train": 2, "eval": 2, "persist": 2}
        assert body["caches"] == {"dataset": {}, "stage": {}}
        inf = root.create_inference_job(job["id"], max_models=1)
        path = f"/inference_jobs/{inf['id']}/profile"
        status, short = _call(p.admin_port, token, "POST", path,
                              {"duration_s": 0.01})
        assert status == 200 and short["duration_s"] == 0.5
        assert set(short) == {"inference_job_id", "service_id",
                              "duration_s", "profile_dir"}
        traces = _wait_for_trace(short["profile_dir"])
        assert len(traces) == 1
        with open(traces[0]) as f:
            meta = json.load(f)["rafiki_tpu_trace"]
        assert meta["what"] == "on-demand profile"
        status, long = _call(p.admin_port, token, "POST", path,
                             {"duration_s": 1e6})
        assert status == 200 and long["duration_s"] == 60.0
        status, bad = _call(p.admin_port, token, "POST", path,
                            {"duration_s": "soon"})
        assert status == 400
        root.stop_inference_job(inf["id"])
        # The worker stops its session when its loop ends.
        assert len(_wait_for_trace(long["profile_dir"])) == 1
        status, body = _call(p.admin_port, token, "POST", path,
                             {"duration_s": 1})
        assert status == 400 and "not RUNNING" in body["error"]
    finally:
        p.shutdown()


@pytest.mark.parametrize("budget", [
    {"GPU_COUNT": 4, "MODEL_TRIAL_COUNT": 2},
    {"GPU_COUNT": 4, "CHIP_COUNT": 2},
    {"CHIP_COUNT": 1},
    {},
    None,
])
def test_gpu_count_budget_alias(budget):
    from rafiki_torch.admin.services_manager import normalize_budget
    from rafiki_tpu.admin.services_manager import \
        normalize_budget as ref_normalize

    assert normalize_budget(budget) == ref_normalize(budget)
    if budget and "GPU_COUNT" in budget and "CHIP_COUNT" not in budget:
        assert normalize_budget(budget)["CHIP_COUNT"] == 4


FAILING = """
from {pkg}.model import BaseModel, FixedKnob
class AlwaysFails(BaseModel):
    def __init__(self, device=None, **knobs):
        super().__init__(**knobs)
    @staticmethod
    def get_knob_config():
        return {{'k': FixedKnob(1)}}
    def train(self, p, **kw): raise RuntimeError('broken')
    def evaluate(self, p): return 0.0
    def predict(self, qs): return []
    def dump_parameters(self): return {{}}
    def load_parameters(self, p): pass
"""


def test_failing_model_trips_the_circuit_breaker(tmp_path, synth_image_data):
    train_path, val_path = synth_image_data
    counts = {}
    for kind, make, pkg in (("port", _port, "rafiki_torch"),
                            ("ref", _ref, "rafiki_tpu")):
        p = make(tmp_path / kind)
        try:
            dev = p.admin.create_user("fdev@x.c", "pw",
                                      UserType.MODEL_DEVELOPER)
            model = p.admin.create_model(
                dev["id"], "boom", TaskType.IMAGE_CLASSIFICATION,
                "AlwaysFails", model_source=FAILING.format(pkg=pkg))
            job = p.admin.create_train_job(
                dev["id"], "boom-app", TaskType.IMAGE_CLASSIFICATION,
                [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 100},
                train_path, val_path, advisor_type="random")
            assert p.admin.wait_until_train_job_done(job["id"], timeout=120,
                                                     poll=0.1)
            trials = p.meta.get_trials_of_train_job(job["id"])
            assert 1 <= len(trials) <= 5  # capped, not 100
            counts[kind] = _by_status(trials)
            assert p.admin.get_train_job(job["id"])["status"] == "STOPPED"
        finally:
            p.shutdown()
    assert counts["port"] == counts["ref"]
    assert set(counts["port"]) == {TrialStatus.ERRORED}


def test_parallel_workers_keep_to_the_trial_budget(tmp_path,
                                                   synth_image_data):
    train_path, val_path = synth_image_data
    seen = {}
    for kind, make, ff in (("port", _port, PORT_FF), ("ref", _ref, REF_FF)):
        p = make(tmp_path / kind)
        try:
            dev = p.admin.create_user("d@x.c", "pw",
                                      UserType.MODEL_DEVELOPER)
            model = p.admin.create_model(dev["id"], "ff",
                                         TaskType.IMAGE_CLASSIFICATION, ff)
            job = p.admin.create_train_job(
                dev["id"], "budget-app", TaskType.IMAGE_CLASSIFICATION,
                [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 3,
                                BudgetOption.CHIP_COUNT: 3},
                train_path, val_path, advisor_type="random")
            assert p.admin.wait_until_train_job_done(job["id"], timeout=600,
                                                     poll=0.2)
            trials = p.meta.get_trials_of_train_job(job["id"])
            train_svcs = [s for s in p.meta.get_services()
                          if s["service_type"] == ServiceType.TRAIN]
            seen[kind] = (_by_status(trials), len(train_svcs),
                          len({t["worker_id"] for t in trials}) > 1)
            assert p.allocator.free_chips == p.allocator.n_chips
        finally:
            p.shutdown()
    assert seen["port"] == seen["ref"]
    assert seen["port"][:2] == ({TrialStatus.COMPLETED: 3}, 3)


def test_two_trials_on_one_chip_serve_as_one_packed_worker(
        tmp_path, synth_image_data):
    """With one chip, the 2-trial ensemble packs onto one worker serving
    the bin "a,b"; its answer is the float64 mean of its members' own
    predictions and agrees with JaxFeedForward on the same files."""
    from rafiki_torch.cache import Cache
    from rafiki_torch.model.dataset import load_image_dataset
    from rafiki_torch.models import TorchFeedForward
    from rafiki_tpu.models.feedforward import JaxFeedForward
    from rafiki_tpu.store import ParamStore as RefParamStore

    train_path, val_path = synth_image_data
    val = load_image_dataset(val_path)
    queries = [val.images[i] for i in range(8)]
    served = {}
    for kind, make, ff in (("port", _port, PORT_FF), ("ref", _ref, REF_FF)):
        p = make(tmp_path / kind, http=True, n_chips=1)
        try:
            dev = p.admin.create_user("d@x.c", "pw",
                                      UserType.MODEL_DEVELOPER)
            model = p.admin.create_model(dev["id"], "ff",
                                         TaskType.IMAGE_CLASSIFICATION, ff)
            job = p.admin.create_train_job(
                dev["id"], "pack-app", TaskType.IMAGE_CLASSIFICATION,
                [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 2},
                train_path, val_path, advisor_type="random")
            assert p.admin.wait_until_train_job_done(job["id"], timeout=600,
                                                     poll=0.2)
            inf = p.admin.create_inference_job(dev["id"], job["id"],
                                               max_models=2)
            assert len(inf["trial_ids"]) == 2
            workers = [w for w in p.meta.get_inference_job_workers(inf["id"])
                       if w["trial_id"] != "__predictor__"]
            assert len(workers) == 1
            assert set(workers[0]["trial_id"].split(",")) == \
                set(inf["trial_ids"])
            host = p.admin.get_inference_job(inf["id"])["predictor_host"]
            client = Client(admin_port=p.admin_port)
            client.login("d@x.c", "pw")
            probs = np.asarray(client.predict(host, queries=queries)
                               ["predictions"], np.float64)
            assert probs.shape == (8, 4)
            np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-3)
            if kind == "port":
                info = Cache(p.bus).running_worker_info(inf["id"])
                assert [i["trial_id"] for i in info.values()] == \
                    [workers[0]["trial_id"]]
                rows = [p.meta.get_trial(t) for t in inf["trial_ids"]]
                own, jax_own = [], []
                ref_params = RefParamStore(p.params.params_dir)
                for r in rows:
                    m = TorchFeedForward(device="cpu", **r["knobs"])
                    m.load_parameters(p.params.load(r["params_id"]))
                    own.append(m.predict(queries))
                    jm = JaxFeedForward(
                        **JaxFeedForward.validate_knobs(r["knobs"]))
                    jm.load_parameters(ref_params.load(r["params_id"]))
                    jax_own.append(jm.predict(queries))
                mean = np.mean(np.asarray(own, np.float64), axis=0)
                assert np.abs(probs - mean).max() <= TOL_MEAN
                jax_mean = np.mean(np.asarray(jax_own, np.float64), axis=0)
                assert np.abs(probs - jax_mean).max() <= TOL_JAX
                ref_params.close()
            served[kind] = probs
            p.admin.stop_inference_job(inf["id"])
            assert p.allocator.free_chips == p.allocator.n_chips
        finally:
            p.shutdown()


def _kill_train_worker(p):
    """Silence the job's one train worker and leave its row RUNNING, as
    a process killed before it could report would."""
    svc = [s for s in p.meta.get_services()
           if s["service_type"] == ServiceType.TRAIN][0]
    worker = p.container.get(svc["container_id"])
    worker.stop_flag.set()
    deadline = time.monotonic() + 120
    while worker.running and time.monotonic() < deadline:
        time.sleep(0.05)
    with p.container._lock:
        p.container._services.pop(svc["id"], None)
    p.meta.update_service(svc["id"], status=ServiceStatus.RUNNING)
    return svc


def test_supervise_restarts_a_dead_train_worker(tmp_path, synth_image_data):
    train_path, val_path = synth_image_data
    seen = {}
    for kind, make, ff in (("port", _port, PORT_FF), ("ref", _ref, REF_FF)):
        p = make(tmp_path / kind)
        try:
            dev = p.admin.create_user("d@x.c", "pw",
                                      UserType.MODEL_DEVELOPER)
            model = p.admin.create_model(dev["id"], "ff",
                                         TaskType.IMAGE_CLASSIFICATION, ff)
            job = p.admin.create_train_job(
                dev["id"], "sup-app", TaskType.IMAGE_CLASSIFICATION,
                [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 3},
                train_path, val_path, advisor_type="random")
            svc = _kill_train_worker(p)
            restarted = p.services.supervise()
            assert len(restarted) == 1
            assert p.meta.get_service(svc["id"])["status"] == \
                ServiceStatus.ERRORED
            assert p.meta.get_service(restarted[0])["service_type"] == \
                ServiceType.TRAIN
            assert p.admin.wait_until_train_job_done(job["id"], timeout=600,
                                                     poll=0.2)
            seen[kind] = len(p.meta.get_trials_of_train_job(
                job["id"], status=TrialStatus.COMPLETED))
        finally:
            p.shutdown()
    assert seen == {"port": 3, "ref": 3}


def test_supervise_restarts_a_dead_inference_worker(tmp_path,
                                                    synth_image_data):
    """A dead worker's bin gets a fresh worker while its job is live, and
    the predictor serves from it."""
    from rafiki_torch.cache import Cache

    train_path, val_path = synth_image_data
    p = _port(tmp_path / "port", http=True, n_chips=1)
    try:
        dev = p.admin.create_user("d@x.c", "pw", UserType.MODEL_DEVELOPER)
        model = p.admin.create_model(dev["id"], "ff",
                                     TaskType.IMAGE_CLASSIFICATION, PORT_FF)
        job = p.admin.create_train_job(
            dev["id"], "a", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 1}, train_path, val_path)
        assert p.admin.wait_until_train_job_done(job["id"], timeout=600,
                                                 poll=0.2)
        inf = p.admin.create_inference_job(dev["id"], job["id"])
        (row,) = [w for w in p.meta.get_inference_job_workers(inf["id"])
                  if w["trial_id"] != "__predictor__"]
        worker = p.container.get(row["service_id"])
        worker.stop_flag.set()
        while worker.running:
            time.sleep(0.05)
        with p.container._lock:
            p.container._services.pop(row["service_id"], None)
        p.meta.update_service(row["service_id"],
                              status=ServiceStatus.RUNNING)
        (new_id,) = p.services.supervise()
        assert p.meta.get_inference_job_worker(new_id)["trial_id"] == \
            row["trial_id"]
        host = p.admin.get_inference_job(inf["id"])["predictor_host"]
        client = Client(admin_port=p.admin_port)
        client.login("d@x.c", "pw")
        out = client.predict(host, queries=[np.zeros((12, 12, 1),
                                                     np.uint8)])
        assert len(out["predictions"][0]) == 4
        assert list(Cache(p.bus).running_workers(inf["id"])) == [new_id]
    finally:
        p.shutdown()


def test_a_second_primary_on_the_same_workdir_is_refused(tmp_path):
    p1 = _port(tmp_path / "w")
    try:
        with pytest.raises(RuntimeError, match="another primary"):
            _port(tmp_path / "w")
    finally:
        p1.shutdown()
    _port(tmp_path / "w").shutdown()  # a clean restart is legitimate


def test_the_quickstart_runs_on_the_cpu(capsys):
    from rafiki_torch.quickstart import main

    main(["--local", "--synthetic", "--device", "cpu", "--trials", "1"])
    assert "QUICKSTART OK" in capsys.readouterr().out


TINY_LM = """
from rafiki_torch.model import FixedKnob
from rafiki_torch.models.lm import TorchTransformerLM


class TinyLM(TorchTransformerLM):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchTransformerLM.get_knob_config())
        cfg.update(d_model=FixedKnob(256), n_layers=FixedKnob(2),
                   seq_len=FixedKnob(256), vocab_size=FixedKnob(512),
                   batch_size=FixedKnob(2), train_steps=FixedKnob(4),
                   learning_rate=FixedKnob(1e-3))
        return cfg
"""
GEN_ENV = {"RAFIKI_TPU_SERVING_GENERATE": "1",
           "RAFIKI_TPU_GENERATE_PAGE_SIZE": "4",
           "RAFIKI_TPU_GENERATE_POOL_PAGES": "64",
           "RAFIKI_TPU_GENERATE_DECODE_BATCH": "2",
           "RAFIKI_TPU_GENERATE_MAX_NEW": "16"}


def _stream(url, body):
    import json
    import urllib.request

    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in resp.read().splitlines()]


def test_an_uploaded_lm_trains_serves_and_generates_over_the_bus(
        tmp_path, monkeypatch):
    """A ``TorchTransformerLM`` subclass uploaded as ``model_source``
    trains one LANGUAGE_MODELING trial on a token stream; its served
    scores equal a directly built model's ``predict`` on the same params
    file exactly, and ``POST /generate`` over the bus streams the greedy
    tokens an in-process worker on the same parameters streams."""
    from rafiki_torch.datasets import make_synthetic_token_dataset
    from rafiki_torch.models import TorchTransformerLM
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.worker import InferenceWorker

    for k, v in GEN_ENV.items():
        monkeypatch.setenv(k, v)
    train, val = make_synthetic_token_dataset(
        str(tmp_path / "tok"), n_train=4096, n_val=1024, vocab_size=512)
    p = _port(tmp_path / "port", http=True, n_chips=1)
    try:
        root = Client(admin_port=p.admin_port)
        root.login("superadmin@rafiki", "rafiki")
        root.create_user("lm@x.c", "pw", UserType.MODEL_DEVELOPER)
        dev = Client(admin_port=p.admin_port)
        dev.login("lm@x.c", "pw")
        model = dev.create_model("tiny-lm", TaskType.LANGUAGE_MODELING,
                                 "TinyLM", model_source=TINY_LM)
        job = dev.create_train_job("lm", TaskType.LANGUAGE_MODELING,
                                   [model["id"]],
                                   {BudgetOption.MODEL_TRIAL_COUNT: 1},
                                   train, val)
        assert dev.wait_until_train_job_done(job["id"], timeout=600,
                                             poll=0.2)["status"] == "STOPPED"
        (best,) = dev.get_best_trials_of_train_job(job["id"], max_count=1)
        assert best["knobs"]["d_model"] == 256
        inf = dev.create_inference_job(job["id"], max_models=1)
        host = dev.get_inference_job(inf["id"])["predictor_host"]
        rng = np.random.default_rng(0)
        queries = [rng.integers(0, 512, n).tolist() for n in (257, 17, 2)]
        served = dev.predict(host, queries=queries)["predictions"]
        params = p.params.load(best["params_id"])
        direct = TorchTransformerLM(device="cpu", **best["knobs"])
        direct.load_parameters(params)
        assert served == direct.predict(queries)

        prompt = rng.integers(0, 512, 9).tolist()
        frames = _stream(f"http://{host}", {"tokens": prompt,
                                            "max_new": 6})
        assert frames[-1]["done"] and frames[-1]["finish"] == "length"
        engine = {"page_size": 4, "n_pages": 64, "decode_batch": 2,
                  "max_new_cap": 16}
        from rafiki_torch.utils.model_loader import load_model_class

        tiny = load_model_class("TinyLM", TINY_LM)
        worker = InferenceWorker(tiny, best["knobs"], params,
                                 device="cpu", generate=engine).start()
        app = PredictorService([worker], device="cpu").start()
        try:
            local = _stream(app.url, {"tokens": prompt, "max_new": 6})
        finally:
            app.stop()
            worker.stop()
        assert [t for f in frames for t in f["tok"]] == \
            [t for f in local for t in f["tok"]]
        assert len([t for f in frames for t in f["tok"]]) == 6
        dev.stop_inference_job(inf["id"])
    finally:
        p.shutdown()


def test_a_worker_answers_corrupt_shards_and_honours_the_drain_marker(
        tmp_path, synth_image_data):
    """A worker answers a corrupt packed shard with one error a query,
    and a drain marker ends its serve loop cleanly: its row STOPPED and
    its registration gone. The reference's worker answers alike."""
    from rafiki_torch import cache as pc
    from rafiki_tpu import cache as rc

    train_path, val_path = synth_image_data
    seen = {}
    for kind, make, ff, mod in (("port", _port, PORT_FF, pc),
                                ("ref", _ref, REF_FF, rc)):
        p = make(tmp_path / kind, n_chips=1)
        try:
            dev = p.admin.create_user("d@x.c", "pw",
                                      UserType.MODEL_DEVELOPER)
            model = p.admin.create_model(dev["id"], "ff",
                                         TaskType.IMAGE_CLASSIFICATION, ff)
            job = p.admin.create_train_job(
                dev["id"], "a", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
                {BudgetOption.MODEL_TRIAL_COUNT: 1}, train_path, val_path,
                advisor_type="random")
            assert p.admin.wait_until_train_job_done(job["id"], timeout=600,
                                                     poll=0.2)
            inf = p.admin.create_inference_job(dev["id"], job["id"])
            (row,) = [w for w in p.meta.get_inference_job_workers(inf["id"])
                      if w["trial_id"] != "__predictor__"]
            wid = row["service_id"]
            cache = mod.Cache(p.bus)
            deadline = time.monotonic() + 120
            while wid not in cache.running_workers(inf["id"]):
                assert time.monotonic() < deadline
                time.sleep(0.05)
            frame = mod.PackedBatch.from_arrays(
                [np.zeros((12, 12, 1), np.uint8)] * 3).slice(0, 3)
            frame["__ndbatch__"] = frame["__ndbatch__"][:-8]
            p.bus.push(f"q:{wid}", {"batch_id": "bad", "shard": "s",
                                    "batch": frame})
            (reply,) = cache.gather_prediction_batches("bad", 1,
                                                       timeout=30)
            cache.send_drain(wid)
            deadline = time.monotonic() + 60
            while p.meta.get_service(wid)["status"] != \
                    ServiceStatus.STOPPED:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            seen[kind] = ([str(x.get("error", ""))[:11]
                           for x in reply["predictions"]], reply["shard"],
                          wid in cache.running_workers(inf["id"]))
        finally:
            p.shutdown()
    assert seen["port"] == seen["ref"] == (["ValueError:"] * 3, "s", False)
