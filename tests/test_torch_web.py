"""The port's operator and data surface held against the reference's, on
the CPU: the HTTP server's request bodies and upload limit, dataset
uploads (``POST``/``GET /datasets``), service logs
(``GET /services/<id>/logs``), the dashboard at ``GET /``,
``ServicesManager.chip_utilization`` and ``ModelLogger.define_loss_plot``.

Each check builds both packages' objects on the same inputs: the same
requests go to both servers (the reference's on JAX's CPU), and the
statuses, handler inputs, rows and errors must be equal. A row's
``id``, ``user_id``, ``created_at`` and the random part of its stored
file name differ by construction and are compared by shape only.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import http.client
import json
import logging
import os
import re
import socket
import threading

import pytest

from rafiki_torch.client import Client, ClientError
from rafiki_torch.constants import BudgetOption, TaskType, UserType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- The request body and the upload limit ---

def _echo_server(mod, **kw):
    """A server of package ``mod`` whose ``POST /echo`` answers what its
    handler was given: the JSON body and the raw body."""
    seen = []

    def echo(params, body, ctx):
        raw = ctx.raw_body
        seen.append(1)
        return 200, {"body": body,
                     "raw": None if raw is None else raw.decode("latin-1")}

    return mod.JsonHttpServer([("POST", "/echo", echo)], host="127.0.0.1",
                              name="echo", **kw).start(), seen


def _post(port, body, ctype):
    """One POST /echo with exactly these headers: (status, JSON reply)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.putrequest("POST", "/echo", skip_accept_encoding=True)
        if ctype is not None:
            conn.putheader("Content-Type", ctype)
        conn.putheader("Content-Length", str(len(body)))
        conn.endheaders(body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


BODIES = [
    (b'{"a": [1, 2.5, "x"]}', "application/json"),
    (b'{"a": 1}', None),                                # no type: JSON
    (b'{"email": "x"}', "application/x-www-form-urlencoded"),  # sniffed
    (b"name=x&task=y", "application/x-www-form-urlencoded"),   # raw
    (b"[1, 2, 3]", "application/octet-stream"),         # never sniffed
    (b"\x00\xffPK\x03\x04", "application/zip"),
    (b"{not json", "application/json"),                 # 400
    (b"a,b\n1,2\n", "text/csv; charset=utf-8"),
]


@pytest.mark.parametrize("body,ctype", BODIES)
def test_bodies_reach_the_handler_as_the_reference(body, ctype):
    from rafiki_torch.utils import service as ps
    from rafiki_tpu.utils import service as rs

    got = []
    for mod in (ps, rs):
        srv, _ = _echo_server(mod)
        try:
            got.append(_post(srv.port, body, ctype))
        finally:
            srv.stop()
    assert got[0] == got[1]
    assert got[0][0] == (400 if body == b"{not json" else 200)


def _forged(port, length):
    """A request that claims ``length`` body bytes and sends none: the
    first line of the reply."""
    conn = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        conn.sendall((f"POST /echo HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                      f"Content-Type: application/octet-stream\r\n"
                      f"Content-Length: {length}\r\n\r\n").encode())
        return conn.recv(4096).decode().splitlines()[0]
    finally:
        conn.close()


def test_the_upload_limit_answers_413_before_the_body(monkeypatch):
    """The limit is read from ``RAFIKI_TPU_MAX_UPLOAD_MB`` when a server
    is built (256 MiB by default): a forged Content-Length over it gets
    413 without the server waiting for the body, and the handler never
    runs; a body within it is served."""
    from rafiki_torch.utils import service as ps
    from rafiki_tpu.utils import service as rs

    limits, lines, calls = [], [], []
    for mod in (ps, rs):
        monkeypatch.delenv("RAFIKI_TPU_MAX_UPLOAD_MB", raising=False)
        srv, _ = _echo_server(mod)
        limits.append(srv.max_body)
        srv.stop()
        monkeypatch.setenv("RAFIKI_TPU_MAX_UPLOAD_MB", "1")
        srv, seen = _echo_server(mod)
        try:
            limits.append(srv.max_body)
            lines.append(_forged(srv.port, (1 << 20) + 1))
            lines.append(_forged(srv.port, 99999999999))
            calls.append(len(seen))
            status, _ = _post(srv.port, b"z" * (1 << 20),
                              "application/octet-stream")
            lines.append(status)
        finally:
            srv.stop()
    assert limits == [256 << 20, 1 << 20] * 2
    assert calls == [0, 0]
    assert lines[:3] == lines[3:]
    assert " 413 " in lines[0] and " 413 " in lines[1] and lines[2] == 200


# --- Datasets ---

def _platforms(tmp_path):
    from rafiki_torch.platform import LocalPlatform as PortPlatform
    from rafiki_tpu.platform import LocalPlatform as RefPlatform

    port = PortPlatform(workdir=str(tmp_path / "port"), device="cpu",
                        supervise_interval=0, http=True)
    try:
        ref = RefPlatform(workdir=str(tmp_path / "ref"),
                          supervise_interval=0, http=True)
    except BaseException:
        port.shutdown()
        raise
    return [("port", port), ("ref", ref)]


@pytest.fixture()
def both(tmp_path):
    made = _platforms(tmp_path)
    try:
        yield made
    finally:
        for _, p in made:
            p.shutdown()


_STORED = re.compile(r"^[0-9a-f]{12}-(.*)$")


def _row(plat, row):
    """A dataset row with what differs by construction masked: the
    stored file's place relative to the node's datasets dir, its random
    prefix dropped."""
    rel = os.path.relpath(row["path"], os.path.join(plat.workdir,
                                                    "datasets"))
    m = _STORED.match(rel)
    with open(row["path"], "rb") as f:
        data = f.read()
    return {"keys": sorted(row), "name": row["name"], "task": row["task"],
            "size_bytes": row["size_bytes"],
            "stored": m.group(1) if m else rel, "bytes": data}


def _raw_upload(port, token, query, body):
    """One ``POST /datasets?<query>`` of raw bytes: (status, JSON)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", f"/datasets?{query}", body=body, headers={
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _outcome(fn):
    try:
        return ("ok", fn())
    except ClientError as e:
        return ("error", e.status, str(e))


def _upload_script(plat, files):
    client = Client(admin_port=plat.admin_port)
    token = client.login("superadmin@rafiki", "rafiki")["token"]
    out = []
    for name, task, path in (
            ("train", TaskType.IMAGE_CLASSIFICATION, files["train"]),
            ("val", TaskType.IMAGE_CLASSIFICATION, files["val"]),
            ("table", TaskType.TABULAR_CLASSIFICATION, files["csv"]),
            ("../../x", TaskType.IMAGE_CLASSIFICATION, files["evil"]),
            ("train", TaskType.IMAGE_CLASSIFICATION, files["val"])):
        got = _outcome(lambda: client.create_dataset(name, task, path))
        if got[0] == "ok":
            got = ("ok", _row(plat, got[1]))
        out.append(got)
    # A file name that tries to leave the datasets dir keeps only its
    # extension.
    status, row = _raw_upload(plat.admin_port, token,
                              "name=evil&task=T&filename=..%2F..%2Fpwn.npz",
                              b"zz")
    out.append((status, _row(plat, row) if status == 201 else row))
    for task in (None, TaskType.IMAGE_CLASSIFICATION,
                 TaskType.POS_TAGGING):
        rows = client.get_datasets(task=task)
        out.append(sorted((r["name"], r["task"], r["size_bytes"])
                          for r in rows))
    # An empty body and no name are refused before anything is stored.
    out.append(_outcome(lambda: client.create_dataset(
        "empty", TaskType.IMAGE_CLASSIFICATION, files["empty"])))
    out.append(_outcome(lambda: client.create_dataset(
        "", TaskType.IMAGE_CLASSIFICATION, files["val"])))
    # A second user sees only their own datasets.
    client.create_user("dev@x.c", "pw", UserType.MODEL_DEVELOPER)
    other = Client(admin_port=plat.admin_port)
    other.login("dev@x.c", "pw")
    out.append(other.get_datasets())
    anon = Client(admin_port=plat.admin_port)
    out.append(_outcome(lambda: anon.get_datasets()))
    out.append(len(os.listdir(os.path.join(plat.workdir, "datasets"))))
    return out


@pytest.fixture()
def upload_files(tmp_path):
    from rafiki_torch.datasets import make_synthetic_image_dataset

    d = tmp_path / "files"
    d.mkdir()
    train, val = make_synthetic_image_dataset(
        str(d), n_train=64, n_val=16, image_shape=(8, 8, 1), n_classes=3)
    csv = d / "t.csv"
    csv.write_text("a,b,label\n1,2,0\n3,4,1\n")
    evil = d / "pwn.zip"
    evil.write_bytes(b"PK\x03\x04zz")
    empty = d / "empty.npz"
    empty.write_bytes(b"")
    return {"train": train, "val": val, "csv": str(csv), "evil": str(evil),
            "empty": str(empty)}


def test_dataset_uploads_answer_as_the_reference(both, upload_files):
    """Upload, list with and without a task, a duplicate name, a name
    that tries to leave the datasets dir, an empty body, a missing
    name, another user's view and no token: the same rows, stored
    bytes and errors from both admins."""
    got = [_upload_script(p, upload_files) for _, p in both]
    assert got[0] == got[1]
    rows = got[0]
    assert [r[0] for r in rows[:5]] == ["ok"] * 4 + ["error"]
    assert rows[4][1] == 400 and "already have a dataset" in rows[4][2]
    # Hostile names stay inside the datasets dir, their files renamed.
    assert rows[3][1]["stored"] == ".._.._x.zip"
    assert rows[5][0] == 201 and rows[5][1]["stored"] == "evil.npz"
    assert [n for n, _, _ in rows[6]] == ["../../x", "evil", "table",
                                          "train", "val"]
    assert [n for n, _, _ in rows[7]] == ["../../x", "train", "val"]
    assert rows[8] == []
    assert rows[9][:2] == ("error", 400) and rows[10][:2] == ("error", 400)
    assert rows[11] == [] and rows[12][:2] == ("error", 401)
    assert rows[13] == 5  # the duplicate's file was removed


def test_an_uploaded_set_trains_a_job(tmp_path, upload_files):
    """The uploaded files' paths drive a train job to its end on the
    port, as the reference's browser flow does."""
    from rafiki_torch.platform import LocalPlatform

    plat = LocalPlatform(workdir=str(tmp_path / "n"), device="cpu",
                         supervise_interval=0, http=True)
    try:
        client = Client(admin_port=plat.admin_port)
        client.login("superadmin@rafiki", "rafiki")
        up = [client.create_dataset(n, TaskType.IMAGE_CLASSIFICATION,
                                    upload_files[n])
              for n in ("train", "val")]
        assert all(os.path.getsize(u["path"]) ==
                   os.path.getsize(upload_files[n])
                   for u, n in zip(up, ("train", "val")))
        model = client.create_model(
            "ff", TaskType.IMAGE_CLASSIFICATION,
            "rafiki_torch.models.feedforward:TorchFeedForward")
        job = client.create_train_job(
            "up", TaskType.IMAGE_CLASSIFICATION, [model["id"]],
            {BudgetOption.MODEL_TRIAL_COUNT: 1}, up[0]["path"],
            up[1]["path"], advisor_type="random")
        done = client.wait_until_train_job_done(job["id"], timeout=600)
        assert done["status"] == "STOPPED"
        best = client.get_best_trials_of_train_job(job["id"], max_count=1)
        assert best and best[0]["score"] is not None
        # The train worker's log holds its trial's records.
        (svc,) = [s for s in client.get_services()
                  if s["service_type"] == "TRAIN"]
        logs = client.get_service_logs(svc["id"])
        assert logs["captured"] and "trial" in logs["log"]
        assert client.get_service_logs(svc["id"], max_bytes=8)["log"] \
            in logs["log"]
    finally:
        plat.shutdown()


def test_the_datasets_table_is_shared_by_both_stores(tmp_path):
    """A ``datasets`` row one package's ``MetaStore`` writes, the other's
    reads, both ways."""
    from rafiki_torch.store import MetaStore as PortMeta
    from rafiki_tpu.store import MetaStore as RefMeta

    for write, read in ((RefMeta, PortMeta), (PortMeta, RefMeta)):
        uri = str(tmp_path / f"{write.__module__.split('.')[0]}.db")
        w = write(uri)
        a = w.create_dataset("u1", "a", "IMAGE_CLASSIFICATION", "/d/a.npz",
                             10)
        w.create_dataset("u1", "b", "POS_TAGGING", "/d/b.zip", 20)
        w.create_dataset("u2", "a", "IMAGE_CLASSIFICATION", "/d/c.npz", 30)
        w.close()
        r = read(uri)
        try:
            assert r.get_dataset(a["id"]) == a
            assert [d["name"] for d in r.get_datasets("u1")] == ["a", "b"]
            assert [d["path"] for d in r.get_datasets(
                "u1", task="POS_TAGGING")] == ["/d/b.zip"]
            assert [d["size_bytes"] for d in r.get_datasets("u2")] == [30]
            with pytest.raises(Exception) as e:
                r.create_dataset("u1", "a", "X", "/d/z", 1)
            assert type(e.value).__name__ == "IntegrityError"
        finally:
            r.close()


def test_create_dataset_refuses_as_the_reference(tmp_path):
    """Without a datasets dir, or with no bytes, ``Admin.create_dataset``
    raises the reference's ``ValueError``."""
    from rafiki_torch.admin import Admin as PortAdmin
    from rafiki_tpu.admin.admin import Admin as RefAdmin

    msgs = []
    for cls in (PortAdmin, RefAdmin):
        for ddir, data in (("", b"x"), (str(tmp_path / "d"), b"")):
            adm = cls.__new__(cls)
            adm.datasets_dir = ddir
            with pytest.raises(ValueError) as e:
                adm.create_dataset("u", "n", "T", data, "f.npz")
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


# --- Service logs ---

def _logged_services(plat):
    """Four service rows: a train worker of the superadmin's job, an
    inference worker of a developer's job, each with a log file, one of
    the developer's without a file, and one no job maps."""
    meta = plat.meta
    root = meta.get_user_by_email("superadmin@rafiki")
    dev = meta.get_user_by_email("dev@x.c")
    out = {}
    model = meta.create_model(root["id"], "m", "IMAGE_CLASSIFICATION", "M",
                              {})
    job = meta.create_train_job(root["id"], "a", "IMAGE_CLASSIFICATION",
                                {}, "-", "-", "STOPPED")
    sub = meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
    svc = meta.create_service("TRAIN", "STOPPED")
    meta.add_train_job_worker(svc["id"], sub["id"])
    out["train"] = svc["id"]
    djob = meta.create_train_job(dev["id"], "b", "IMAGE_CLASSIFICATION",
                                 {}, "-", "-", "STOPPED")
    inf = meta.create_inference_job(dev["id"], djob["id"], "STOPPED")
    for name in ("infer", "silent"):
        svc = meta.create_service("INFERENCE", "STOPPED")
        meta.add_inference_job_worker(svc["id"], inf["id"], "t")
        out[name] = svc["id"]
    out["orphan"] = meta.create_service("ADVISOR", "STOPPED")["id"]
    logs = plat.services.log_dir
    os.makedirs(logs, exist_ok=True)
    for name in ("train", "infer", "orphan"):
        with open(os.path.join(logs, f"{out[name]}.log"), "w") as f:
            for i in range(40):
                f.write(f"line {i} of the {name} service\n")
    return out


def _log_script(plat):
    plat.admin.create_user("dev@x.c", "pw", UserType.MODEL_DEVELOPER)
    plat.admin.create_user("ops@x.c", "pw", UserType.ADMIN)
    ids = _logged_services(plat)
    out = []
    for email, pw in (("superadmin@rafiki", "rafiki"), ("dev@x.c", "pw"),
                      ("ops@x.c", "pw")):
        c = Client(admin_port=plat.admin_port)
        c.login(email, pw)
        out.append(sorted(s["service_type"] for s in c.get_services()))
        for name in ("train", "infer", "silent", "orphan"):
            got = _outcome(lambda: c.get_service_logs(ids[name]))
            if got[0] == "ok":
                got = ("ok", {k: v for k, v in got[1].items()
                              if k != "service_id"})
            out.append((name, got))
        out.append(_outcome(lambda: c.get_service_logs(
            ids["train"], max_bytes=64))[1]["log"]
            if email != "dev@x.c" else None)
        out.append(_outcome(lambda: c.get_service_logs("nope"))[:2])
    return out


def test_service_logs_answer_as_the_reference(both):
    """The owner, another user, an admin, a service that never logged
    and one no job maps: the same tails, flags and refusals."""
    got = [_log_script(p) for _, p in both]
    assert got[0] == got[1]
    root, dev = got[0][:7], got[0][7:14]
    assert root[1][1][1]["captured"] and \
        root[1][1][1]["log"].startswith("line 0 of the train")
    assert root[3] == ("silent", ("ok", {"status": "STOPPED", "log": None,
                                         "captured": False}))
    assert root[5].startswith("line ") and \
        root[5].endswith("line 39 of the train service\n") and \
        len(root[5].encode()) <= 64
    assert root[6] == ("error", 400)
    assert dev[0] == ["INFERENCE", "INFERENCE"]
    assert dev[1][1][:2] == ("error", 403) and dev[2][1][0] == "ok"
    assert dev[4][1][:2] == ("error", 403)


def test_a_worker_thread_logs_to_its_own_file(tmp_path):
    """Two threads bound to two service files: each record reaches the
    file of the thread that emitted it, and no other; a thread that is
    not bound writes to neither."""
    from rafiki_torch.utils.service_logs import (bind_service_log,
                                                 service_log_path, tail_log)

    log = logging.getLogger("rafiki_torch.worker.test")
    paths = {n: service_log_path(str(tmp_path), n) for n in ("a", "b")}
    ready = threading.Barrier(2)

    def service(name):
        bind_service_log(paths[name])
        ready.wait(timeout=30)
        for i in range(50):
            log.info("record %d of %s", i, name)

    threads = [threading.Thread(target=service, args=(n,))
               for n in ("a", "b")]
    for t in threads:
        t.start()
    log.warning("from the unbound thread")
    for t in threads:
        t.join(timeout=30)
    for name, other in (("a", "b"), ("b", "a")):
        text = tail_log(paths[name], max_bytes=1 << 20)
        lines = text.splitlines()
        assert len(lines) == 50 and all(f"of {name}" in x for x in lines)
        assert f"of {other}" not in text and "unbound" not in text
    assert tail_log(service_log_path(str(tmp_path), "c")) is None


# --- The dashboard ---

DASHBOARD_IDS = ("nm-create", "nm-source", "nj-create", "job-stop",
                 "inf-create", "nu-create", "cmp-go", "cmp-knobs",
                 "cmp-chart", "nd-upload", "nd-file", "nd-name", "nd-task",
                 "nm-src-file", "services", "svclog", "infstats",
                 "infstats-summary", "phases", "phases-caches",
                 "autoscale-card", "trace-id", "trace-go", "trace-spans")
_FETCH = re.compile(r'api\("(GET|POST)",\s*["`]([^"`]*)["`]'
                    r'|fetch\(`([^`?]*)[^`]*`,\s*\{method:\s*"(\w+)"')


def dashboard_fetches(html):
    """(method, path) of every request the page makes, each ``${...}``
    as ``<x>``."""
    out = set()
    for m in _FETCH.finditer(html):
        method, path = (m.group(1), m.group(2)) if m.group(1) \
            else (m.group(4), m.group(3))
        out.add((method, re.sub(r"\$\{[^}]*\}", "<x>", path)))
    return sorted(out)


def test_the_dashboard_is_served_without_auth(tmp_path):
    from rafiki_torch.platform import LocalPlatform
    from rafiki_torch.web import dashboard_html

    plat = LocalPlatform(workdir=str(tmp_path / "n"), device="cpu",
                         supervise_interval=0, http=True)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", plat.admin_port,
                                          timeout=30)
        conn.request("GET", "/")
        r = conn.getresponse()
        text = r.read().decode()
        conn.close()
        assert r.status == 200
        assert r.getheader("Content-Type").startswith("text/html")
        assert text == dashboard_html()
        assert "Train jobs" in text
        for el in DASHBOARD_IDS:
            assert f'id="{el}"' in text, el
        for needle in ("/stats", "refreshInfStats", "/trial_phases",
                       "refreshTrialPhases", "/autoscale",
                       "refreshAutoscale", "/trace/"):
            assert needle in text, needle
    finally:
        plat.shutdown()


def test_every_path_the_dashboard_fetches_is_routed(tmp_path):
    """Each request of the page matches a route of the port's admin,
    the uploads, the logs and the control loop's panels among them; the
    page differs from the reference's only where the port does."""
    from rafiki_torch.admin.app import AdminApp
    from rafiki_torch.web import dashboard_html

    html = dashboard_html()
    fetches = dashboard_fetches(html)
    app = AdminApp(_NoAdmin())
    table = [(m, pattern) for m, _, pattern, _ in app._http._routes]
    app.stop()
    for method, path in fetches:
        concrete = path.split("?")[0].replace("<x>", "abc")
        assert any(m == method and p.match(concrete)
                   for m, p in table), (method, path)
    for want in (("POST", "/datasets"), ("GET", "/datasets"),
                 ("GET", "/services/<x>/logs"), ("GET", "/autoscale"),
                 ("GET", "/slo"), ("GET", "/alerts"), ("GET", "/capacity"),
                 ("GET", "/trace/<x>"), ("GET", "/trial_phases"),
                 ("GET", "/status"), ("POST", "/tokens")):
        assert want in fetches, want
    with open(os.path.join(ROOT, "rafiki_tpu", "web", "dashboard.html"),
              encoding="utf-8") as f:
        ref = f.read()
    # The one difference: the capacity CLI the page names is the port's.
    assert html != ref and html == ref.replace(
        "python -m rafiki_tpu.capacity", "python -m rafiki_torch.capacity")


class _NoAdmin:
    """Stands in for ``Admin`` where only the route table is read."""


# --- chip_utilization and define_loss_plot ---

def test_chip_utilization_follows_the_allocator_as_the_reference():
    """Before, during and after allocations (a time-sliced share
    included), the port's ``chip_utilization`` reads what the
    reference's does over the same allocator calls."""
    from rafiki_torch.admin.services_manager import \
        ServicesManager as PortManager
    from rafiki_torch.parallel.chips import ChipAllocator as PortAlloc
    from rafiki_tpu.admin.services_manager import \
        ServicesManager as RefManager
    from rafiki_tpu.parallel.chips import ChipAllocator as RefAlloc

    readings = []
    for alloc, cls in ((PortAlloc(4, device="cpu"), PortManager),
                       (RefAlloc(4, topology=[(i, 0, 0) for i in range(4)]),
                        RefManager)):
        mgr = cls.__new__(cls)
        mgr.allocator = alloc
        seen = [mgr.chip_utilization()]
        alloc.allocate(2, name="a")
        seen.append(mgr.chip_utilization())
        alloc.allocate(1, name="b")
        alloc.allocate(1, name="c", shared_ok=True)
        seen.append(mgr.chip_utilization())
        alloc.release("a")
        seen.append(mgr.chip_utilization())
        alloc.release("b")
        alloc.release("c")
        seen.append(mgr.chip_utilization())
        readings.append(seen)
    assert readings[0] == readings[1]
    assert readings[0][0] == 0.0 and readings[0][1] > 0 \
        and readings[0][-1] == 0.0


def test_define_loss_plot_records_as_the_reference():
    from rafiki_torch.model.logger import logger as plog
    from rafiki_tpu.model.logger import logger as rlog

    records = []
    for lg in (plog, rlog):
        got = []
        prior = lg.current_sink() if hasattr(lg, "current_sink") else None
        lg.set_sink(got.append)
        try:
            lg.define_loss_plot()
        finally:
            lg.set_sink(prior)
        (rec,) = got
        assert isinstance(rec.pop("time"), float)
        records.append(rec)
    assert records[0] == records[1] == {
        "type": "plot", "plot": {"title": "Loss over epochs",
                                 "metrics": ["loss"], "x_axis": "epoch"}}


def _seeded_deployment(plat):
    """A running inference job of one feed-forward trial with seeded
    weights, its worker registered."""
    import time

    import numpy as np

    from rafiki_torch.cache import Cache

    rng = np.random.default_rng(3)
    widths = [64, 128, 128, 128, 4]
    p = {}
    for i in range(4):
        p[f"params/Dense_{i}/kernel"] = (rng.standard_normal(
            (widths[i], widths[i + 1])) / 8).astype(np.float32)
        p[f"params/Dense_{i}/bias"] = np.zeros(widths[i + 1], np.float32)
    p["_meta/n_classes"] = np.asarray(4)
    p["_meta/image_shape"] = np.asarray((8, 8, 1))
    root = plat.meta.get_user_by_email("superadmin@rafiki")
    model = plat.admin.create_model(
        root["id"], "ff", TaskType.IMAGE_CLASSIFICATION,
        "rafiki_torch.models.feedforward:TorchFeedForward")
    job = plat.meta.create_train_job(root["id"], "ff",
                                     TaskType.IMAGE_CLASSIFICATION, {}, "-",
                                     "-", "STOPPED")
    sub = plat.meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
    t = plat.meta.create_trial(sub["id"], model["id"], 1, "RUNNING",
                               knobs={"hidden_layer_count": 2,
                                      "hidden_layer_units": 32,
                                      "learning_rate": 1e-3,
                                      "batch_size": 32})
    plat.meta.mark_trial_completed(t["id"], 0.5,
                                   plat.params.save(p, session_id="s"))
    inf = plat.admin.create_inference_job(root["id"], job["id"],
                                          max_models=1)
    cache = Cache(plat.bus)
    deadline = time.monotonic() + 60
    while not cache.running_workers(inf["id"]):
        assert time.monotonic() < deadline, "the worker did not register"
        time.sleep(0.02)
    return inf


def test_stopping_a_deployment_leaves_no_worker_behind(tmp_path,
                                                       monkeypatch):
    """A supervise sweep that runs while ``stop_inference_job`` stops the
    job's worker, at the moment its thread is gone and its row still
    reads RUNNING, finds the job stopped and starts no fresh worker for
    its bin."""
    from rafiki_torch.platform import LocalPlatform

    plat = LocalPlatform(workdir=str(tmp_path / "n"), device="cpu",
                         supervise_interval=0)
    try:
        inf = _seeded_deployment(plat)
        (wid,) = [w["service_id"] for w in
                  plat.services.active_inference_workers(inf["id"])]
        destroy = plat.container.destroy_service
        alive = plat.container.service_alive
        swept = []

        def sweep_then_destroy(cid):
            if cid == wid:
                monkeypatch.setattr(plat.container, "service_alive",
                                    lambda c: c != wid and alive(c))
                swept.append(plat.services.supervise())
                monkeypatch.setattr(plat.container, "service_alive", alive)
            destroy(cid)

        monkeypatch.setattr(plat.container, "destroy_service",
                            sweep_then_destroy)
        plat.admin.stop_inference_job(inf["id"])
        assert swept == [[]]
        assert plat.services.active_inference_workers(inf["id"]) == []
        assert plat.meta.get_inference_job(inf["id"])["status"] == "STOPPED"
        assert plat.services.chip_utilization() == 0.0
    finally:
        plat.shutdown()


def test_stopping_a_train_job_restarts_no_worker(tmp_path, monkeypatch,
                                                 upload_files):
    """As for a deployment: a supervise sweep that runs while
    ``stop_train_job`` stops the job's train worker, at the moment its
    thread is gone and its row still reads RUNNING, restarts nothing."""
    import time

    from rafiki_torch.platform import LocalPlatform

    plat = LocalPlatform(workdir=str(tmp_path / "n"), device="cpu",
                         supervise_interval=0)
    try:
        root = plat.meta.get_user_by_email("superadmin@rafiki")
        model = plat.admin.create_model(
            root["id"], "ff", TaskType.IMAGE_CLASSIFICATION,
            "rafiki_torch.models.feedforward:TorchFeedForward")
        job = plat.admin.create_train_job(
            root["id"], "long", TaskType.IMAGE_CLASSIFICATION,
            [model["id"]], {BudgetOption.MODEL_TRIAL_COUNT: 1000},
            upload_files["train"], upload_files["val"],
            advisor_type="random")
        deadline = time.monotonic() + 60
        while True:
            running = [s for s in plat.meta.get_services(status="RUNNING")
                       if s["service_type"] == "TRAIN"]
            if running:
                break
            assert time.monotonic() < deadline, "no train worker ran"
            time.sleep(0.02)
        (wid,) = [s["id"] for s in running]
        destroy = plat.container.destroy_service
        alive = plat.container.service_alive
        swept = []

        def sweep_then_destroy(cid):
            if cid == wid:
                monkeypatch.setattr(plat.container, "service_alive",
                                    lambda c: c != wid and alive(c))
                swept.append(plat.services.supervise())
                monkeypatch.setattr(plat.container, "service_alive", alive)
            destroy(cid)

        monkeypatch.setattr(plat.container, "destroy_service",
                            sweep_then_destroy)
        plat.admin.stop_train_job(job["id"])
        assert swept == [[]]
        assert [s for s in plat.meta.get_services()
                if s["service_type"] == "TRAIN"
                and s["status"] in ("STARTED", "DEPLOYING", "RUNNING")] == []
        assert plat.services.chip_utilization() == 0.0
    finally:
        plat.shutdown()
