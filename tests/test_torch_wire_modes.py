"""The port's packed-wire switch and its per-query cache calls held
against the reference's, on the CPU.

``RAFIKI_TPU_SERVING_PACKED_WIRE`` (``on``, ``off``, ``compat``) reads
as the reference's for every spelling. Under ``off`` and ``compat`` the
same calls put the reference's frames on the bus (keys, ``rw`` and
payloads, compared as JSON with sorted keys). Under ``on`` (the
default) the frames are byte for byte what the port sent before the
switch existed. ``off`` registers no wire series (a fresh process each).
A query sent with ``Cache.send_query`` to a CPU bus worker comes back
through ``gather_predictions`` with the same prediction, bit for bit,
as the batch path gives it, and a worker built under ``off`` offers no
packed wire and gets per-query frames from its predictor.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from rafiki_torch import cache as pc
from rafiki_torch.bus import MemoryBus as PortBus
from rafiki_torch.observe import wire as pwire
from rafiki_tpu import cache as rc
from rafiki_tpu.bus import MemoryBus as RefBus
from rafiki_tpu.observe import wire as rwire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "RAFIKI_TPU_SERVING_PACKED_WIRE"
SPELLINGS = list(pwire.PACKED_WIRE_SPELLINGS) + [
    "ON", " Off ", "Compat", "offf", "maybe", "2"]


@pytest.mark.parametrize("raw", SPELLINGS)
def test_packed_wire_mode_reads_as_the_reference(raw, monkeypatch):
    assert pwire.PACKED_WIRE_SPELLINGS == rwire.PACKED_WIRE_SPELLINGS
    assert pwire.PACKED_WIRE_ENV == rwire.PACKED_WIRE_ENV == ENV
    assert pwire.packed_wire_mode(raw) == rwire.packed_wire_mode(raw)
    assert pwire.known_packed_wire_spelling(raw) == \
        rwire.known_packed_wire_spelling(raw)
    monkeypatch.setenv(ENV, raw)
    assert pwire.packed_wire_mode() == rwire.packed_wire_mode()
    monkeypatch.delenv(ENV)
    assert pwire.packed_wire_mode() == "on"


def test_an_unknown_spelling_fails_safe_to_compat(caplog):
    with caplog.at_level("WARNING"):
        assert pwire.packed_wire_mode("offf") == "compat"
    assert "failing safe to 'compat'" in caplog.text


def _inputs():
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (4, 4, 1), dtype=np.uint8)
            for _ in range(3)]
    probs = [rng.random(4).astype(np.float32) for _ in range(3)]
    return imgs, probs


def _script(mod, bus):
    """Every sending call of a ``Cache`` on fixed ids; the frames each
    queue holds afterwards, in order."""
    imgs, probs = _inputs()
    enc = [mod.encode_payload(x) for x in imgs]
    c = mod.Cache(bus)
    c.send_query("w1", imgs[0], query_id="q1")
    c.send_query_batch("w1", imgs, batch_id="b1")
    c.send_query_batch("w2", enc, batch_id="b2", pre_encoded=True)
    c.send_query_batch_fanout(["w1", "w2"], enc, batch_id="b3",
                              packed=mod.PackedBatch.from_encoded(enc),
                              packed_ok={"w1"})
    c.send_query_shards([("w1", 0, 2, "s0"), ("w2", 2, 1, "s1")], enc,
                        batch_id="b4",
                        packed=mod.PackedBatch.from_arrays(imgs),
                        packed_ok={"w2"})
    c.send_prediction_batch("b4", "w1", probs[:2], weight=2, shard="s0",
                            packed_ok=True)
    c.send_prediction_batch("b4", "w2", [p.tolist() for p in probs[2:]],
                            shard="s1", packed_ok=False)
    c.send_prediction("q1", "w1", probs[0].tolist(), weight=3)
    return {q: bus.pop_all(q) for q in ("q:w1", "q:w2", "r:b4", "r:q1")}


@pytest.mark.parametrize("mode", ["off", "compat"])
def test_frames_equal_the_reference_with_the_wire_off(mode, monkeypatch):
    monkeypatch.setenv(ENV, mode)
    port = _script(pc, PortBus())
    ref = _script(rc, RefBus())
    assert json.dumps(port, sort_keys=True) == \
        json.dumps(ref, sort_keys=True)
    frames = [f for q in port.values() for f in q]
    assert all("rw" not in f for f in frames)
    # A reply is packed only when the reply side's wire is on.
    assert all("batch" not in f for f in port["r:b4"])
    # Payloads decode to the arrays sent.
    imgs, probs = _inputs()
    single = port["q:w1"][0]
    assert single["query_id"] == "q1" and set(single) == {"query_id",
                                                         "query"}
    got = pc.decode_payload(single["query"])
    assert got.dtype == np.uint8 and np.array_equal(got, imgs[0])
    for p, want in zip(port["r:b4"][0]["predictions"], probs[:2]):
        got = pc.decode_payload(p)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_frames_with_the_wire_on_are_the_ports_earlier_bytes(monkeypatch):
    """The default: each frame of the calls the port had before the
    switch, serialised, is what it was: ``rw`` right after ``shard``,
    a packed reply where the query asked for one."""
    monkeypatch.delenv(ENV, raising=False)
    imgs, probs = _inputs()
    enc = [pc.encode_payload(x) for x in imgs]
    bus = PortBus()
    c = pc.Cache(bus)
    packed = pc.PackedBatch.from_arrays(imgs)
    c.send_query_shards([("w1", 0, 2, "s0"), ("w2", 2, 1, "s1")], enc,
                        batch_id="b4", packed=packed, packed_ok={"w2"})
    c.send_prediction_batch("b4", "w1", probs[:2], weight=2, shard="s0",
                            packed_ok=True, compute_s=0.5)
    c.send_prediction_batch("b4", "w2", [p.tolist() for p in probs[2:]],
                            shard="s1", packed_ok=False)
    want = {
        "q:w1": [{"batch_id": "b4", "shard": "s0", "rw": ["ndbatch1"],
                  "queries": enc[:2]}],
        "q:w2": [{"batch_id": "b4", "shard": "s1", "rw": ["ndbatch1"],
                  "batch": packed.slice(2, 1)}],
        "r:b4": [{"worker_id": "w1", "weight": 2,
                  "batch": pc.pack_prediction_rows(probs[:2]),
                  "shard": "s0", "compute_s": 0.5},
                 {"worker_id": "w2", "weight": 1,
                  "predictions": [pc.encode_payload(p.tolist())
                                  for p in probs[2:]], "shard": "s1"}]}
    for q, frames in want.items():
        assert json.dumps(bus.pop_all(q)) == json.dumps(frames), q


def test_the_other_package_pops_a_single_query():
    """A ``send_query`` frame of either package is popped and decoded by
    the other's ``pop_queries``, and its ``send_prediction`` gathered
    back, bit for bit."""
    imgs, probs = _inputs()
    for send, recv in ((pc, rc), (rc, pc)):
        bus = PortBus()
        s, r = send.Cache(bus), recv.Cache(bus)
        qid = s.send_query("w", imgs[1])
        (item,) = r.pop_queries("w", timeout=0.1)
        assert item["query_id"] == qid
        assert np.array_equal(item["query"], imgs[1])
        r.send_prediction(qid, "w", probs[1], weight=2)
        (got,) = s.gather_predictions(qid, 1, timeout=1.0)
        assert got["weight"] == 2 and got["worker_id"] == "w"
        assert np.array_equal(np.asarray(got["prediction"]), probs[1])


_FRESH = """
import os, sys
import numpy as np
from rafiki_torch import cache
from rafiki_torch.bus import MemoryBus
from rafiki_torch.observe import metrics, wire
bus = MemoryBus()
c = cache.Cache(bus)
imgs = [np.zeros((2, 2), np.uint8)] * 3
enc = [cache.encode_payload(x) for x in imgs]
c.send_query_shards([("w", 0, 3, "s")], enc, batch_id="b",
                    packed=cache.PackedBatch.from_arrays(imgs),
                    packed_ok={"w"})
c.pop_queries("w", timeout=0.1)
c.send_prediction_batch("b", "w", [[0.5, 0.5]] * 3, packed_ok=True)
c.gather_prediction_batches("b", 1, timeout=1.0)
text = metrics.registry().expose()
print(wire.counting(),
      "rafiki_tpu_serving_wire_bytes_total" in text,
      "rafiki_tpu_serving_host_copies_total" in text)
"""


@pytest.mark.parametrize("mode,want", [("off", "False False False"),
                                       ("compat", "True True True"),
                                       ("on", "True True True")])
def test_off_registers_no_wire_series(mode, want):
    env = dict(os.environ, **{ENV: mode})
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("RAFIKI_TPU_METRICS", None)
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


# --- Through a CPU bus worker ---

SHAPE = (8, 8, 1)
N_CLASSES = 4
KNOBS = {"hidden_layer_count": 2, "hidden_layer_units": 32,
         "learning_rate": 1e-3, "batch_size": 32}


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


def _serve(tmp, mode, monkeypatch):
    """A CPU bus worker for one feed-forward trial and its predictor
    front, built under ``mode``; each ``pop_queries`` item's keys are
    recorded. Returns (stop, cache, worker, front, keys)."""
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.store import MetaStore, ParamStore
    from rafiki_torch.worker.inference import BusInferenceWorker

    monkeypatch.setenv(ENV, mode)
    pwire.reset_for_tests()
    meta = MetaStore(os.path.join(tmp, "meta.db"))
    params = ParamStore(os.path.join(tmp, "params"))
    bus = PortBus()
    user = meta.create_user("w@x.c", "-", "MODEL_DEVELOPER")
    model = meta.create_model(
        user["id"], "ff", "IMAGE_CLASSIFICATION",
        "rafiki_torch.models.feedforward:TorchFeedForward", {})
    job = meta.create_train_job(user["id"], "ff", "IMAGE_CLASSIFICATION",
                                {}, "-", "-", "STOPPED")
    sub = meta.create_sub_train_job(job["id"], model["id"], "STOPPED")
    t = meta.create_trial(sub["id"], model["id"], 1, "RUNNING", knobs=KNOBS)
    meta.mark_trial_completed(t["id"], 0.9, params.save(_params(1),
                                                        session_id="w"))
    inf = meta.create_inference_job(user["id"], job["id"], "RUNNING")
    wsvc = meta.create_service("INFERENCE", "DEPLOYING")
    worker = BusInferenceWorker(wsvc["id"], inf["id"], t["id"], meta,
                                params, bus, device="cpu")
    keys = []
    pop = worker.cache.pop_queries

    def recording(*a, **kw):
        items = pop(*a, **kw)
        keys.extend(sorted(k for k in it if not k.startswith("_"))
                    for it in items)
        return items

    worker.cache.pop_queries = recording
    worker.start()
    psvc = meta.create_service("PREDICT", "DEPLOYING")
    front = PredictorService.for_job(psvc["id"], inf["id"], meta,
                                     bus).start()
    cache = pc.Cache(bus)
    deadline = time.monotonic() + 60
    while not cache.running_workers(inf["id"]):
        assert worker.running and time.monotonic() < deadline
        time.sleep(0.02)

    def stop():
        front.stop()
        worker.stop()
        meta.close()
        params.close()
        pwire.reset_for_tests()

    return stop, cache, worker, front, keys, inf["id"]


def _predict(front, imgs):
    req = urllib.request.Request(
        f"http://127.0.0.1:{front.port}/predict", method="POST",
        data=json.dumps({"queries": [pc.encode_payload(x)
                                     for x in imgs]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["predictions"]


@pytest.mark.parametrize("mode", ["on", "off"])
def test_a_single_query_is_answered_as_the_batch_path(mode, tmp_path,
                                                      monkeypatch):
    """``send_query`` to the worker, then ``gather_predictions``: the
    same prediction as ``POST /predict`` gives for the image. Under
    ``on`` the worker offers the packed wire and its shards arrive
    packed with ``rw``; under ``off`` it offers none and every frame is
    per-query, without ``rw``."""
    stop, cache, worker, front, keys, inf = _serve(str(tmp_path), mode,
                                                   monkeypatch)
    try:
        info = cache.running_worker_info(inf)[worker.service_id]
        assert info["wire"] == (["ndbatch1"] if mode == "on" else [])
        rng = np.random.default_rng(2)
        img = rng.integers(0, 256, SHAPE, dtype=np.uint8)
        (via_front,) = _predict(front, [img])
        shard_keys = list(keys)
        qid = cache.send_query(worker.service_id, img)
        (reply,) = cache.gather_predictions(qid, 1, timeout=30.0)
        assert reply["worker_id"] == worker.service_id
        assert reply["weight"] == 1
        assert np.array_equal(np.asarray(reply["prediction"], np.float64),
                              np.asarray(via_front, np.float64))
        assert keys[len(shard_keys):] == [["query", "query_id"]]
        if mode == "on":
            assert shard_keys == [["batch", "batch_id", "rw", "shard"]]
        else:
            assert shard_keys == [["batch_id", "queries", "shard"]]
    finally:
        stop()
