"""The port's edge cache and confidence tiering on the CPU, against the
reference's.

The scenarios of the reference's ``tests/test_edge_cache.py``, run on
the port's ``EdgeCache``, ``Predictor`` and ``PredictorService`` over a
``MemoryBus`` with stand-in workers that speak the cache protocol.
Where the two packages can be compared directly, the same inputs go
through both: one script of cache operations on both ``EdgeCache``s
(events, epochs and ``info()`` equal), ``query_key`` and
``prediction_confidence`` on seeded vectors (equal), and tiered
prediction over workers with fixed rows, confidences and scores (tier
outcomes and answers equal, exactly).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from rafiki_torch.bus import MemoryBus
from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.observe import metrics as obs_metrics
from rafiki_torch.predictor import (EdgeCache, Predictor, PredictorService,
                                    query_key)
from rafiki_torch.worker.inference import prediction_confidence
from rafiki_tpu import cache as ref_cache
from rafiki_tpu.bus import MemoryBus as RefMemoryBus
from rafiki_tpu.predictor import EdgeCache as RefEdgeCache
from rafiki_tpu.predictor import Predictor as RefPredictor
from rafiki_tpu.predictor import query_key as ref_query_key
from rafiki_tpu.worker.inference import \
    prediction_confidence as ref_prediction_confidence

CACHE_FAMILIES = ("rafiki_tpu_serving_cache_total",
                  "rafiki_tpu_serving_cache_bytes",
                  "rafiki_tpu_serving_tier_total",
                  "rafiki_tpu_serving_chip_seconds_avoided_total")


class ConfWorker:
    """A worker stand-in answering a fixed vector a query, with a fixed
    confidence (None: a model without probabilities) and registration
    score (None: no score), over either package's ``Cache``."""

    def __init__(self, bus, worker_id, job_id="job", trial_id="t1",
                 vector=(0.8, 0.2), confidence=0.5, score=0.9, delay=0.0,
                 cache_cls=Cache):
        self.cache = cache_cls(bus)
        self.worker_id = worker_id
        self.vector = list(vector)
        self.confidence = confidence
        self.delay = delay
        self.served_queries = 0
        self.stop_flag = threading.Event()
        info = {"trial_id": trial_id}
        if score is not None:
            info["score"] = score
        self.cache.register_worker(job_id, worker_id, info=info)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self.stop_flag.is_set():
            for it in self.cache.pop_queries(self.worker_id, timeout=0.1):
                if self.delay:
                    time.sleep(self.delay)
                n = len(it["queries"])
                self.served_queries += n
                self.cache.send_prediction_batch(
                    it["batch_id"], self.worker_id,
                    [list(self.vector) for _ in range(n)],
                    shard=it.get("shard"),
                    confidence=[self.confidence] * n,
                    compute_s=0.004 * n)

    def stop(self):
        self.stop_flag.set()
        self._thread.join(timeout=5)


@pytest.fixture()
def bus():
    return MemoryBus()


def _service(bus, **kw):
    svc = PredictorService.for_job("svc", "job", None, bus, **kw)
    svc.predictor.worker_wait_timeout = 5.0
    svc.predictor.gather_timeout = 5.0
    return svc.start()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _series_for(service):
    out = []
    for name in CACHE_FAMILIES:
        m = obs_metrics.registry().find(name)
        if m is None:
            continue
        out.extend((name, labels) for labels, _ in m.samples()
                   if labels.get("service") == service)
    return out


def _tier_mix(p):
    return {labels["outcome"]: int(v) for labels, v in p._m_tier.samples()
            if labels.get("service") == p.service}


# --- EdgeCache unit semantics ----------------------------------------

def test_query_key_is_content_addressed():
    a = encode_payload(np.arange(12, dtype=np.uint8).reshape(3, 4))
    b = encode_payload(np.arange(12, dtype=np.uint8).reshape(3, 4))
    c = encode_payload(np.zeros((3, 4), dtype=np.uint8))
    assert query_key(a) == query_key(b)
    assert query_key(a) != query_key(c)


def test_second_touch_admission_and_hits():
    c = EdgeCache(1 << 20, ttl_s=60, admit_after=2, service="u1")
    try:
        assert c.begin("k")[0] == "lead"
        c.resolve("k", "v", c.epoch)  # first miss: not admitted
        assert c.begin("k")[0] == "lead"
        c.resolve("k", "v", c.epoch)  # second miss: admitted
        assert c.begin("k") == ("hit", "v")
        ev = c.info()["events"]
        assert ev["miss"] == 2 and ev["hit"] == 1
    finally:
        c.close()


def test_first_touch_mode_and_ttl_expiry():
    c = EdgeCache(1 << 20, ttl_s=0.15, admit_after=1, service="u2")
    try:
        assert c.begin("k")[0] == "lead"
        c.resolve("k", "v", c.epoch)
        assert c.begin("k")[0] == "hit"
        time.sleep(0.2)
        assert c.begin("k")[0] == "lead", "a lapsed entry was served"
    finally:
        c.close()


def test_byte_budget_lru_eviction():
    c = EdgeCache(220, ttl_s=60, admit_after=1, service="u3")
    try:
        for i in range(4):
            key = f"k{i}"
            assert c.begin(key)[0] == "lead"
            c.resolve(key, "x" * 60, c.epoch)
        info = c.info()
        assert info["bytes"] <= 220
        assert info["events"]["evict"] >= 1
        assert c.begin("k3")[0] == "hit"
        assert c.begin("k0")[0] == "lead"
    finally:
        c.close()


def test_promote_midflight_race_unit():
    """A promotion while a leader is in flight: the waiter already on it
    gets the old answer, the leader's insert is dropped, the next
    request misses."""
    c = EdgeCache(1 << 20, ttl_s=60, admit_after=1, service="u4")
    try:
        kind, lead = c.begin("k")
        assert kind == "lead"
        epoch0 = c.epoch
        kind, flight = c.begin("k")
        assert kind == "wait"
        got = {}
        waiter = threading.Thread(
            target=lambda: got.setdefault("v", flight.wait(5)))
        waiter.start()
        assert c.invalidate() == epoch0 + 1
        c.resolve("k", "old-ensemble", epoch0, flight=lead)
        waiter.join(timeout=5)
        assert got["v"] == "old-ensemble"
        assert c.begin("k")[0] == "lead"
        assert c.info()["events"]["invalidate"] == 1
    finally:
        c.close()


def test_post_promotion_request_never_joins_stale_flight():
    c = EdgeCache(1 << 20, ttl_s=60, admit_after=1, service="u7")
    try:
        kind, stale_lead = c.begin("k")
        assert kind == "lead"
        epoch0 = c.epoch
        c.invalidate()
        kind, fresh_lead = c.begin("k")
        assert kind == "lead" and fresh_lead is not stale_lead
        c.resolve("k", "old-ensemble", epoch0, flight=stale_lead)
        kind, w = c.begin("k")
        assert kind == "wait" and w is fresh_lead
        c.resolve("k", "new-ensemble", c.epoch, flight=fresh_lead)
        assert c.begin("k") == ("hit", "new-ensemble")
    finally:
        c.close()


def test_failed_none_answer_is_never_cached():
    c = EdgeCache(1 << 20, ttl_s=60, admit_after=1, service="u8")
    try:
        kind, lead = c.begin("k")
        c.resolve("k", None, c.epoch, flight=lead)
        kind, lead = c.begin("k")
        assert kind == "lead", "a failed answer was served from the cache"
        c.resolve("k", [0.9, 0.1], c.epoch, flight=lead)
        assert c.begin("k") == ("hit", [0.9, 0.1])
    finally:
        c.close()


def test_vector_change_invalidates():
    c = EdgeCache(1 << 20, ttl_s=60, admit_after=1, service="u5")
    try:
        c.note_vector(("t1", "t2"))
        assert c.begin("k")[0] == "lead"
        c.resolve("k", "v", c.epoch)
        c.note_vector(("t1", "t2"))
        assert c.begin("k")[0] == "hit"
        c.note_vector(("t2", "t3"))
        assert c.begin("k")[0] == "lead"
    finally:
        c.close()


def test_leader_failure_propagates_to_waiters():
    c = EdgeCache(1 << 20, ttl_s=60, admit_after=1, service="u6")
    try:
        assert c.begin("k")[0] == "lead"
        kind, flight = c.begin("k")
        assert kind == "wait"
        c.fail("k", RuntimeError("scatter blew up"))
        with pytest.raises(RuntimeError, match="scatter blew up"):
            flight.wait(5)
        assert c.begin("k")[0] == "lead"
    finally:
        c.close()


# --- The cache in the service ----------------------------------------

def test_service_cache_serves_repeats_without_scatter(bus):
    worker = ConfWorker(bus, "w1")
    svc = _service(bus, cache_bytes=1 << 20, cache_admit_after=2)
    url = f"{svc.url}/predict"
    q = encode_payload([1.0, 2.0])
    try:
        for _ in range(2):
            _post(url, {"query": q})
        before = worker.served_queries
        assert _post(url, {"query": q})["prediction"] == [0.8, 0.2]
        assert worker.served_queries == before, "a hit reached a worker"
        ev = svc.edge_cache.info()["events"]
        assert ev["hit"] == 1 and ev["miss"] == 2
    finally:
        svc.stop()
        worker.stop()


def test_service_cache_coalesces_concurrent_identical(bus):
    worker = ConfWorker(bus, "w1", delay=0.3)
    svc = _service(bus, cache_bytes=1 << 20, cache_admit_after=1)
    url = f"{svc.url}/predict"
    q = encode_payload([3.0, 4.0])
    results, errors = [], []

    def client():
        try:
            results.append(_post(url, {"query": q})["prediction"])
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(6)]
    try:
        [t.start() for t in threads]
        [t.join(timeout=30) for t in threads]
        assert not errors, errors
        assert results == [[0.8, 0.2]] * 6
        assert worker.served_queries == 1
        ev = svc.edge_cache.info()["events"]
        assert ev["miss"] == 1 and ev["coalesce"] == 5
    finally:
        svc.stop()
        worker.stop()


def test_mixed_request_partial_hits(bus):
    worker = ConfWorker(bus, "w1")
    svc = _service(bus, cache_bytes=1 << 20, cache_admit_after=1)
    url = f"{svc.url}/predict"
    qa, qb = encode_payload([1.0]), encode_payload([2.0])
    try:
        _post(url, {"query": qa})
        before = worker.served_queries
        out = _post(url, {"queries": [qa, qb, qa]})["predictions"]
        assert out == [[0.8, 0.2]] * 3
        assert worker.served_queries == before + 1, \
            "a hit or a duplicate was scattered again"
        assert svc.edge_cache.info()["events"]["hit"] >= 1
    finally:
        svc.stop()
        worker.stop()


def test_cache_invalidate_route_and_stats(bus):
    worker = ConfWorker(bus, "w1")
    svc = _service(bus, cache_bytes=1 << 20, cache_admit_after=1)
    q = encode_payload([5.0])
    try:
        _post(f"{svc.url}/predict", {"query": q})
        assert _post(f"{svc.url}/cache/invalidate", {}) == \
            {"enabled": True, "epoch": 1}
        _post(f"{svc.url}/predict", {"query": q})
        ev = svc.edge_cache.info()["events"]
        assert ev["miss"] == 2 and ev.get("hit", 0) == 0
        assert ev["invalidate"] == 1
        assert _get(f"{svc.url}/stats")["cache"]["epoch"] == 1
        peek = _get(f"{svc.url}/cache/peek?key={query_key(q)}")
        assert peek == {"enabled": True, "found": True,
                        "value": [0.8, 0.2]}
    finally:
        svc.stop()
        worker.stop()


def test_disabled_cache_and_tier_register_zero_series(bus, monkeypatch):
    for field in ("SERVING_CACHE_BYTES", "SERVING_CACHE_TTL_S",
                  "SERVING_CACHE_ADMIT_AFTER", "SERVING_TIER_THRESHOLD"):
        monkeypatch.delenv(f"RAFIKI_TPU_{field}", raising=False)
    worker = ConfWorker(bus, "w1")
    svc = _service(bus)
    try:
        assert svc.edge_cache is None
        assert svc.predictor.tier_threshold is None
        _post(f"{svc.url}/predict", {"query": encode_payload([1.0])})
        assert _post(f"{svc.url}/cache/invalidate", {}) == \
            {"enabled": False}
        assert _series_for(svc.stats.service) == []
    finally:
        svc.stop()
        worker.stop()


def test_cache_series_removed_on_stop(bus):
    worker = ConfWorker(bus, "w1")
    svc = _service(bus, cache_bytes=1 << 20, cache_admit_after=1,
                   tier_threshold=0.3)
    try:
        _post(f"{svc.url}/predict", {"query": encode_payload([2.0])})
        assert _series_for(svc.stats.service)
    finally:
        svc.stop()
        worker.stop()
    assert _series_for(svc.stats.service) == [], \
        "stop() left cache or tier series"


# --- Confidence tiering ----------------------------------------------

def _tiered(bus, threshold=0.3):
    return Predictor("job", bus, gather_timeout=5.0,
                     worker_wait_timeout=5.0, tier_threshold=threshold)


def test_tier_short_circuits_confident_queries(bus):
    a = ConfWorker(bus, "wa", trial_id="t-best", vector=(0.9, 0.1),
                   confidence=0.8, score=0.9)
    b = ConfWorker(bus, "wb", trial_id="t-other", vector=(0.4, 0.6),
                   confidence=0.8, score=0.5)
    p = _tiered(bus)
    try:
        assert p.predict([[1.0], [2.0]]) == [[0.9, 0.1], [0.9, 0.1]]
        assert a.served_queries == 2 and b.served_queries == 0
        assert _tier_mix(p) == {"short_circuit": 2}
    finally:
        p.close()
        a.stop()
        b.stop()


def test_tier_escalates_low_confidence_to_full_vote(bus):
    a = ConfWorker(bus, "wa", trial_id="t-best", vector=(0.6, 0.4),
                   confidence=0.05, score=0.9)
    b = ConfWorker(bus, "wb", trial_id="t-other", vector=(0.2, 0.8),
                   confidence=0.9, score=0.5)
    p = _tiered(bus, threshold=0.3)
    try:
        assert p.predict([[1.0]]) == [[pytest.approx(0.4),
                                       pytest.approx(0.6)]]
        assert a.served_queries == 1 and b.served_queries == 1
        assert _tier_mix(p) == {"escalate": 1}
    finally:
        p.close()
        a.stop()
        b.stop()


def test_tier_escalates_when_model_has_no_confidence(bus):
    a = ConfWorker(bus, "wa", trial_id="t-best", vector=(0.9, 0.1),
                   confidence=None, score=0.9)
    b = ConfWorker(bus, "wb", trial_id="t-other", vector=(0.3, 0.7),
                   confidence=0.9, score=0.5)
    p = _tiered(bus)
    try:
        assert p.predict([[1.0]]) == [[pytest.approx(0.6),
                                       pytest.approx(0.4)]]
        assert b.served_queries == 1
    finally:
        p.close()
        a.stop()
        b.stop()


def test_tier_falls_back_to_full_scatter_without_scores(bus):
    a = ConfWorker(bus, "wa", trial_id="t1", vector=(0.9, 0.1),
                   confidence=0.8, score=None)
    b = ConfWorker(bus, "wb", trial_id="t2", vector=(0.5, 0.5),
                   confidence=0.8, score=0.5)
    p = _tiered(bus)
    try:
        assert p.predict([[1.0]]) == [[pytest.approx(0.7),
                                       pytest.approx(0.3)]]
        assert a.served_queries == 1 and b.served_queries == 1
        assert _tier_mix(p) == {"full": 1}
    finally:
        p.close()
        a.stop()
        b.stop()


def test_tier_disabled_predictor_has_no_tier_metrics(bus):
    a = ConfWorker(bus, "wa", trial_id="t1", score=0.9)
    p = Predictor("job", bus, gather_timeout=5.0, worker_wait_timeout=5.0,
                  tier_threshold=0)
    try:
        assert p.tier_threshold is None
        assert p._m_tier is None and p._m_avoided is None
        assert p.predict([[1.0]]) == [[0.8, 0.2]]
    finally:
        p.close()
        a.stop()


def test_prediction_confidence_margins():
    assert prediction_confidence([0.7, 0.2, 0.1]) == pytest.approx(0.5)
    assert prediction_confidence([0.5, 0.5]) == pytest.approx(0.0)
    assert prediction_confidence("label") is None
    assert prediction_confidence({"error": "x"}) is None
    assert prediction_confidence({"__members__": [1, 2]}) is None
    assert prediction_confidence([0.9]) is None
    assert prediction_confidence([[0.1], [0.9]]) is None
    assert prediction_confidence(None) is None


def test_chip_seconds_avoided_accrues_from_cost_ewma(bus):
    a = ConfWorker(bus, "wa", trial_id="t-best", vector=(0.9, 0.1),
                   confidence=0.8, score=0.9)
    b = ConfWorker(bus, "wb", trial_id="t-other", vector=(0.4, 0.6),
                   confidence=0.8, score=0.5)
    p = _tiered(bus, threshold=0.9)
    try:
        p.predict([[1.0]])  # escalates: both bins' costs seeded
        assert p.estimate_query_cost() == pytest.approx(0.008, rel=0.3)
        p.tier_threshold = 0.3
        p.predict([[2.0]])
        avoided = {labels["source"]: v for labels, v
                   in p._m_avoided.samples()
                   if labels.get("service") == p.service}
        assert avoided["tier"] == pytest.approx(0.004, rel=0.3)
    finally:
        p.close()
        a.stop()
        b.stop()


def test_cost_estimates_ignore_retired_bins_and_price_tiered_hits(bus):
    a = ConfWorker(bus, "wa", trial_id="t-best", vector=(0.9, 0.1),
                   confidence=0.8, score=0.9)
    b = ConfWorker(bus, "wb", trial_id="t-other", vector=(0.4, 0.6),
                   confidence=0.8, score=0.5)
    p = _tiered(bus, threshold=0.9)
    try:
        p.predict([[1.0]])
        assert p.estimate_query_cost() == pytest.approx(0.008, rel=0.3)
        assert p.estimate_hit_cost() == pytest.approx(0.004, rel=0.3)
        with p._state_lock:
            p._bin_cost["t-retired"] = 5.0
        assert p.estimate_query_cost() == pytest.approx(0.008, rel=0.3)
        assert p.estimate_hit_cost() == pytest.approx(0.004, rel=0.3)
    finally:
        p.close()
        a.stop()
        b.stop()


# --- The port against the reference, same inputs ---------------------

def _op_script(seed, n_ops=200, n_keys=12):
    """A seeded script of cache operations: begin (and resolve or fail
    the lead it opened), invalidate, note_vector."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        key = f"k{int(rng.integers(n_keys))}"
        if r < 0.7:
            size = int(rng.integers(1, 80))
            ops.append(("begin", key, "x" * size,
                        "fail" if rng.random() < 0.1 else "resolve"))
        elif r < 0.8:
            ops.append(("invalidate",))
        else:
            ops.append(("vector", tuple(sorted(
                {f"t{int(v)}" for v in rng.integers(3, size=2)}))))
    return ops


def _run_script(cache_cls, ops, max_bytes, admit_after):
    c = cache_cls(max_bytes, ttl_s=60, admit_after=admit_after,
                  service=f"script-{max_bytes}-{admit_after}")
    trail = []
    try:
        for op in ops:
            if op[0] == "begin":
                _, key, value, end = op
                kind, payload = c.begin(key)
                trail.append((kind, payload if kind == "hit" else None))
                if kind == "lead":
                    if end == "fail":
                        c.fail(key, RuntimeError("x"), flight=payload)
                    else:
                        c.resolve(key, value, c.epoch, flight=payload)
            elif op[0] == "invalidate":
                trail.append(("epoch", c.invalidate()))
            else:
                c.note_vector(op[1])
                trail.append(("epoch", c.epoch))
        return trail, c.info()
    finally:
        c.close()


@pytest.mark.parametrize("seed,max_bytes,admit_after",
                         [(0, 1 << 20, 2), (1, 300, 1), (2, 500, 2),
                          (3, 1 << 20, 3)])
def test_one_op_script_gives_the_reference_events_and_epochs(
        seed, max_bytes, admit_after):
    ops = _op_script(seed)
    port = _run_script(EdgeCache, ops, max_bytes, admit_after)
    ref = _run_script(RefEdgeCache, ops, max_bytes, admit_after)
    assert port == ref
    assert port[1]["events"].get("miss", 0) > 0


@pytest.mark.parametrize("seed", range(4))
def test_query_key_and_confidence_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for shape, dtype in (((3, 4), np.uint8), ((16,), np.float32),
                         ((2, 2, 3), np.float64)):
        x = (rng.random(shape) * 255).astype(dtype)
        frame = encode_payload(x)
        assert frame == ref_cache.encode_payload(x)
        assert query_key(frame) == ref_query_key(frame)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        p = rng.dirichlet(np.ones(n))
        for cand in (p, p.tolist(), p.astype(np.float32),
                     [float("nan")] * n, [[v] for v in p.tolist()]):
            assert prediction_confidence(cand) == \
                ref_prediction_confidence(cand)


def _tier_run(pkg, workers, threshold, queries):
    if pkg == "port":
        bus, cache_cls, pred_cls = MemoryBus(), Cache, Predictor
    else:
        bus, cache_cls = RefMemoryBus(), ref_cache.Cache
        pred_cls = RefPredictor
    ws = [ConfWorker(bus, f"w{i}", trial_id=tid, vector=vec,
                     confidence=conf, score=score, cache_cls=cache_cls)
          for i, (tid, vec, conf, score) in enumerate(workers)]
    p = pred_cls("job", bus, gather_timeout=5.0, worker_wait_timeout=5.0,
                 tier_threshold=threshold)
    try:
        out = p.predict(queries)
        mix = ({labels["outcome"]: int(v) for labels, v
                in p._m_tier.samples() if labels.get("service") == p.service}
               if p._m_tier is not None else None)
        return out, mix, [w.served_queries for w in ws]
    finally:
        p.close()
        for w in ws:
            w.stop()


@pytest.mark.parametrize("workers,threshold", [
    ([("t-best", (0.9, 0.1), 0.8, 0.9), ("t-other", (0.4, 0.6), 0.8, 0.5)],
     0.3),
    ([("t-best", (0.6, 0.4), 0.05, 0.9), ("t-other", (0.2, 0.8), 0.9, 0.5)],
     0.3),
    ([("t-best", (0.7, 0.3), None, 0.9), ("t-mid", (0.1, 0.9), 0.9, 0.6),
      ("t-low", (0.35, 0.65), 0.9, 0.2)], 0.3),
    ([("t1", (0.9, 0.1), 0.8, None), ("t2", (0.5, 0.5), 0.8, 0.5)], 0.3),
    ([("t1", (0.25, 0.75), 0.5, 0.7), ("t2", (0.5, 0.5), 0.8, 0.9)], 0.0)])
def test_tier_outcomes_and_answers_equal_the_reference(workers, threshold):
    queries = [[float(i)] for i in range(5)]
    port = _tier_run("port", workers, threshold, queries)
    ref = _tier_run("ref", workers, threshold, queries)
    assert port == ref
