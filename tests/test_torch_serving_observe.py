"""The port's serving records against the reference's, on the CPU: the
workload records (``observe.workload``), the attribution ledger
(``observe.attribution``) and the serving wire series
(``observe.wire``).

Each package serves the same two ``FeedForward`` trials (the same
seeded parameters), stacked in one bus worker, behind its predictor with
attribution and workload records on and a client header. The same
script of requests goes through both fronts. Compared: every workload
record's keys, query count, ``size`` class, status, hashed tenant and
bin count; each attribution family's label names, its tenant labels
and its served request counts; each wire family's label sets.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import time
import urllib.request

import numpy as np
import pytest

SHAPE = (8, 8, 1)
N_CLASSES = 4
KNOBS = [{"hidden_layer_count": 2, "hidden_layer_units": 32,
          "learning_rate": 1e-3, "batch_size": 32},
         {"hidden_layer_count": 1, "hidden_layer_units": 16,
          "learning_rate": 1e-3, "batch_size": 32}]
#: (tenant header or None, number of queries) a request, in order.
SCRIPT = [("alice", 1), ("bob", 3), (None, 2), ("alice", 5), ("carol", 1),
          ("bob", 8), (None, 1), ("alice", 2)]
HEADER = "X-Client"
ENV = {"RAFIKI_TPU_SERVING_ATTRIBUTION": "1",
       "RAFIKI_TPU_WORKLOAD_RECORD": "1",
       "RAFIKI_TPU_SERVING_CLIENT_HEADER": HEADER,
       "RAFIKI_TPU_SERVING_STACKED": "on"}
ATTR_PREFIXES = ("rafiki_tpu_serving_bin_", "rafiki_tpu_serving_tenant_")
WIRE_FAMILIES = ("rafiki_tpu_serving_wire_bytes_total",
                 "rafiki_tpu_serving_host_copies_total",
                 "rafiki_tpu_serving_stacked_dispatch_total",
                 "rafiki_tpu_serving_dispatches_per_query_ratio")


def _params(seed):
    rng = np.random.default_rng(seed)
    widths = [int(np.prod(SHAPE)), 128, 128, 128, N_CLASSES]
    p = {}
    for i in range(4):
        p[f"params/Dense_{i}/kernel"] = (
            rng.standard_normal((widths[i], widths[i + 1]))
            / np.sqrt(widths[i])).astype(np.float32)
        p[f"params/Dense_{i}/bias"] = (
            0.1 * rng.standard_normal(widths[i + 1])).astype(np.float32)
    p["_meta/n_classes"] = np.asarray(N_CLASSES)
    p["_meta/image_shape"] = np.asarray(SHAPE)
    return p


def _package(kind):
    """The modules one package serves with."""
    if kind == "port":
        import rafiki_torch as pkg
        from rafiki_torch.observe import attribution, metrics, wire, workload
        from rafiki_torch.predictor import PredictorService
        from rafiki_torch.worker.inference import BusInferenceWorker

        def worker(sid, inf, tids, meta, params, bus):
            return BusInferenceWorker(sid, inf, tids, meta, params, bus,
                                      device="cpu")

        def front(sid, inf, meta, bus):
            return PredictorService.for_job(sid, inf, meta, bus)

        ff = "rafiki_torch.models.feedforward:TorchFeedForward"
    else:
        import rafiki_tpu as pkg
        from rafiki_tpu.observe import attribution, metrics, wire, workload
        from rafiki_tpu.predictor.app import PredictorService
        from rafiki_tpu.worker.inference import InferenceWorker

        def worker(sid, inf, tids, meta, params, bus):
            return InferenceWorker(sid, inf, tids, meta, params, bus)

        def front(sid, inf, meta, bus):
            return PredictorService(sid, inf, meta, bus, host="127.0.0.1")

        ff = "rafiki_tpu.models.feedforward:JaxFeedForward"
    return (pkg, attribution, metrics, wire, workload, worker, front, ff)


def _reset(attribution, wire, workload):
    attribution.reset_for_tests()
    wire.reset_for_tests()
    workload.reset_for_tests()


def _serve_script(kind, tmp):
    import importlib

    (pkg, attribution, metrics, wire, workload, make_worker, make_front,
     ff) = _package(kind)
    bus_mod = importlib.import_module(pkg.__name__ + ".bus")
    store = importlib.import_module(pkg.__name__ + ".store")
    cache_mod = importlib.import_module(pkg.__name__ + ".cache")
    logs = os.path.join(tmp, "logs")
    _reset(attribution, wire, workload)
    workload.configure(logs)
    meta = store.MetaStore(os.path.join(tmp, "meta.db"))
    params = store.ParamStore(os.path.join(tmp, "params"))
    bus = bus_mod.MemoryBus()
    user = meta.create_user("obs@x.c", "-", "MODEL_DEVELOPER")
    model = meta.create_model(user["id"], "ff", "IMAGE_CLASSIFICATION", ff,
                              {})
    job = meta.create_train_job(user["id"], "ff", "IMAGE_CLASSIFICATION",
                                {}, "-", "-", "STOPPED")
    sub = meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
    tids = []
    for i, knobs in enumerate(KNOBS):
        t = meta.create_trial(sub["id"], model["id"], i + 1, "RUNNING",
                              knobs=knobs)
        meta.mark_trial_completed(t["id"], 0.9 - 0.1 * i, params.save(
            _params(i), session_id="obs"))
        tids.append(t["id"])
    inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
    wsvc = meta.create_service("INFERENCE", "DEPLOYING")
    worker = make_worker(wsvc["id"], inf["id"], ",".join(tids), meta,
                         params, bus).start()
    psvc = meta.create_service("PREDICT", "DEPLOYING")
    front = make_front(psvc["id"], inf["id"], meta, bus).start()
    cache = cache_mod.Cache(bus)
    rng = np.random.default_rng(5)
    statuses = []
    # The wire series live as long as the process: what this script
    # added is what grew past this reading.
    before = metrics.parse_exposition(metrics.registry().expose())
    try:
        deadline = time.monotonic() + 60
        while not cache.running_workers(inf["id"]):
            assert worker.running and time.monotonic() < deadline, \
                "the worker did not register"
            time.sleep(0.05)
        for tenant, n in SCRIPT:
            qs = [cache_mod.encode_payload(
                rng.integers(0, 256, SHAPE).astype(np.uint8))
                for _ in range(n)]
            headers = {"Content-Type": "application/json"}
            if tenant:
                headers[HEADER] = tenant
            req = urllib.request.Request(
                f"http://127.0.0.1:{front.port}/predict", method="POST",
                data=json.dumps({"queries": qs}).encode(), headers=headers)
            with urllib.request.urlopen(req, timeout=60) as r:
                statuses.append(r.status)
                assert len(json.loads(r.read())["predictions"]) == n
        samples = metrics.parse_exposition(metrics.registry().expose())
        records = workload.load(logs)
    finally:
        front.stop()
        worker.stop()
        meta.close()
        params.close()
        _reset(attribution, wire, workload)
    return statuses, records, samples, inf["id"], before


def _grown(after, before, name, drop=()):
    """The label sets of ``name`` (less the labels ``drop``) whose value
    rose from ``before`` to ``after``."""
    old = {tuple(sorted(labels.items())): v
           for labels, v in before.get(name, ())}
    return sorted({tuple(sorted((k, v) for k, v in labels.items()
                                if k not in drop))
                   for labels, v in after.get(name, ())
                   if v > old.get(tuple(sorted(labels.items())), 0.0)})


def _label_names(samples, name):
    return sorted({tuple(sorted(labels)) for labels, _ in
                   samples.get(name, ())})


def _values(samples, name, key, before=None):
    """``{label value: sum}`` of one family, less what ``before`` held."""
    old = {tuple(sorted(labels.items())): v
           for labels, v in (before or {}).get(name, ())}
    out = {}
    for labels, v in samples.get(name, ()):
        v -= old.get(tuple(sorted(labels.items())), 0.0)
        if key in labels and v > 0:
            out[labels[key]] = out.get(labels[key], 0.0) + v
    return out


def _served(kind, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        return _serve_script(kind, str(tmp_path_factory.mktemp(kind)))


@pytest.fixture(scope="module")
def port_served(tmp_path_factory):
    return _served("port", tmp_path_factory)


@pytest.fixture(scope="module")
def served(port_served, tmp_path_factory):
    return {"port": port_served, "ref": _served("ref", tmp_path_factory)}


def test_the_port_records_every_request_under_its_tenant(port_served):
    statuses, records, samples, inf_id, _ = port_served
    assert statuses == [200] * len(SCRIPT)
    assert [(r["n"], r["status"]) for r in records] == \
        [(n, 200) for _, n in SCRIPT]
    from rafiki_torch.observe.attribution import tenant_key

    assert [r["tenant"] for r in records] == \
        [tenant_key(t) for t, _ in SCRIPT]
    assert all(r["job"] == inf_id[:12] and len(r["bins"]) == 1
               for r in records)


def test_workload_records_equal_the_reference(served):
    rows = {}
    for kind, (statuses, records, _, inf_id, _) in served.items():
        assert statuses == [200] * len(SCRIPT)
        assert len(records) == len(SCRIPT)
        rows[kind] = [(sorted(r), r["n"], r["size"], r["status"],
                       r["tenant"], len(r.get("bins", ())),
                       r["job"] == inf_id[:12]) for r in records]
    assert rows["port"] == rows["ref"]
    assert [r[1] for r in rows["port"]] == [n for _, n in SCRIPT]
    assert [r[2] for r in rows["port"]] == [1, 4, 2, 8, 1, 8, 1, 2]


def test_attribution_families_equal_the_reference(served):
    (_, _, port, _, port0), (_, _, ref, _, ref0) = (served["port"],
                                                    served["ref"])
    names = sorted(n for n in port if n.startswith(ATTR_PREFIXES))
    assert names == sorted(n for n in ref if n.startswith(ATTR_PREFIXES))
    assert "rafiki_tpu_serving_tenant_device_seconds_total" in names
    for name in names:
        assert _label_names(port, name) == _label_names(ref, name), name
    tenant_req = "rafiki_tpu_serving_tenant_requests_total"
    tenants = _values(port, tenant_req, "tenant", port0)
    assert tenants == _values(ref, tenant_req, "tenant", ref0)
    assert sorted(tenants.values()) == [1.0, 2.0, 3.0]
    for name in ("rafiki_tpu_serving_bin_requests_total",
                 "rafiki_tpu_serving_bin_queries_total"):
        # The bin labels are each package's own trial ids.
        assert sorted(_values(port, name, "bin", port0).values()) == \
            sorted(_values(ref, name, "bin", ref0).values()), name
    # The buckets are each package's own ladder (the reference's starts
    # at its 8-device CPU mesh), so they are compared only as labels.
    dev = "rafiki_tpu_serving_bin_device_seconds_count"
    drop = ("service", "job", "bin", "le", "bucket")
    assert _grown(port, port0, dev, drop) == _grown(ref, ref0, dev, drop) \
        == [(("dtype", "uint8"), ("mode", "stacked"), ("quant", "-"))]
    device = _values(port, "rafiki_tpu_serving_tenant_device_seconds_total",
                     "tenant", port0)
    assert set(device) == set(tenants) and min(device.values()) > 0


def test_wire_series_equal_the_reference(served):
    (_, _, port, _, port0), (_, _, ref, _, ref0) = (served["port"],
                                                    served["ref"])
    for name in WIRE_FAMILIES[:3]:
        assert _grown(port, port0, name), name
        assert _grown(port, port0, name) == _grown(ref, ref0, name), name
    gauge = WIRE_FAMILIES[3]
    assert _label_names(port, gauge) == _label_names(ref, gauge) == [()]
