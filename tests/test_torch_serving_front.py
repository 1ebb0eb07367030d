"""The port's serving front on the CPU: the micro-batcher, replica
sharding with resubmits and quarantine, 429 backpressure and the client
share, over the port's ``MemoryBus`` with echo workers that speak the
cache protocol, behind the port's ``PredictorService``. The scenarios
are those of the reference's ``tests/test_predictor_batcher.py``."""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from rafiki_torch.bus import MemoryBus
from rafiki_torch.cache import Cache
from rafiki_torch.predictor import (Backpressure, MicroBatcher, Predictor,
                                    PredictorService)


class EchoWorker:
    """Pops query shards and answers ``[q, q + 0.5]`` a query, so each
    answer names its query. ``delay`` is a model's latency a shard,
    ``dead`` swallows frames (a replica that stopped serving but is
    still registered), ``echo_shard=False`` is a worker that does not
    echo the shard id."""

    def __init__(self, bus, worker_id="w1", job_id="job", delay=0.0,
                 trial_id="t1", dead=False, echo_shard=True):
        self.cache = Cache(bus)
        self.worker_id = worker_id
        self.delay = delay
        self.dead = dead
        self.echo_shard = echo_shard
        self.stop_flag = threading.Event()
        self.served_sizes = []
        self.cache.register_worker(job_id, worker_id,
                                   info={"trial_id": trial_id})
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self.stop_flag.is_set():
            for it in self.cache.pop_queries(self.worker_id, timeout=0.1):
                if self.dead:
                    continue
                if self.delay:
                    time.sleep(self.delay)
                self.served_sizes.append(len(it["queries"]))
                self.cache.send_prediction_batch(
                    it["batch_id"], self.worker_id, _expected(it["queries"]),
                    shard=it.get("shard") if self.echo_shard else None)

    def stop(self):
        self.stop_flag.set()
        self._thread.join(timeout=5)


def _expected(qs):
    return [[float(q), float(q) + 0.5] for q in qs]


@pytest.fixture()
def bus():
    return MemoryBus()


@pytest.fixture()
def workers(bus):
    made = []

    def make(*args, **kw):
        w = EchoWorker(bus, *args, **kw)
        made.append(w)
        return w

    yield make
    for w in made:
        w.stop()


def _predictor(bus, **kw):
    kw.setdefault("worker_wait_timeout", 5.0)
    kw.setdefault("gather_timeout", 5.0)
    return Predictor("job", bus, **kw)


@pytest.fixture()
def service(bus):
    made = []

    def make(**kw):
        svc = PredictorService.for_job("svc", "job", None, bus, **kw)
        svc.predictor.worker_wait_timeout = 5.0
        svc.predictor.gather_timeout = 5.0
        made.append(svc.start())
        return svc

    yield make
    for svc in made:
        svc.stop()


@pytest.fixture()
def batcher():
    made = []

    def make(p, **kw):
        mb = MicroBatcher(p, **kw).start()
        made.append(mb)
        return mb

    yield make
    for mb in made:
        mb.stop()


def _post(url, body, headers=None):
    """``(status, headers, payload)`` of one POST; an error status is an
    answer."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _run(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]


@pytest.mark.parametrize("microbatch", [True, False])
def test_concurrent_predict_no_cross_request_bleed(workers, service,
                                                   microbatch):
    workers()
    svc = service(microbatch=microbatch)
    results, errors = {}, []

    def client(i):
        qs = [i * 100 + j for j in range(1 + i % 4)]  # ragged sizes
        status, _, body = _post(svc.url + "/predict", {"queries": qs})
        if status != 200:
            errors.append((status, body))
        results[i] = (qs, body.get("predictions"))

    _run(client, 16)
    assert not errors, errors
    assert len(results) == 16
    for i, (qs, preds) in results.items():
        assert preds == _expected(qs), f"client {i} got another's slice"
    stats = _get(svc.url + "/stats")
    assert stats["requests"] == 16 and stats["microbatch"] is microbatch
    assert (stats["batches"] > 0) is microbatch


def test_microbatcher_coalesces_concurrent_requests(bus, workers, batcher):
    w = workers()
    mb = batcher(_predictor(bus), fill_window=0.05, max_batch=256,
                 max_inflight=2, queue_cap=1024)
    out = {}
    barrier = threading.Barrier(12)

    def client(i):
        barrier.wait()
        out[i] = mb.submit([i, i + 1000], timeout=15)

    _run(client, 12)
    assert out == {i: _expected([i, i + 1000]) for i in range(12)}
    snap = mb.stats.snapshot()
    assert snap["requests"] == 12
    assert snap["batches"] < 12, "no coalescing happened"
    assert snap["coalescing_factor"] > 1.5
    # One frame a super-batch reached the worker, not one a request.
    assert len(w.served_sizes) == snap["batches"]


def test_keep_n_in_flight_overlaps_gather_with_next_scatter(bus, workers,
                                                            batcher):
    workers(delay=0.15)
    mb = batcher(_predictor(bus), fill_window=0.01, max_batch=2,
                 max_inflight=2, queue_cap=1024)
    _run(lambda i: mb.submit([i], timeout=30), 8)
    assert mb.stats.snapshot()["inflight_peak"] == 2


def test_backpressure_returns_429_with_retry_after(workers, service):
    workers(delay=0.25)  # each super-batch is slow
    svc = service(queue_cap=6, max_inflight=1, fill_window=0.01,
                  max_batch=4)
    codes, lock = [], threading.Lock()

    def client(i):
        status, headers, body = _post(svc.url + "/predict",
                                      {"queries": [i, i, i]})
        with lock:
            codes.append((status, headers.get("Retry-After"), body))

    _run(client, 24)
    assert len(codes) == 24
    rejected = [c for c in codes if c[0] == 429]
    served = [c for c in codes if c[0] == 200]
    assert rejected, "overload never produced a 429"
    assert served and len(rejected) + len(served) == 24
    for _, retry_after, body in rejected:
        assert retry_after is not None and int(retry_after) >= 1
        assert body["queue_cap"] == 6 and body["reason"] == "queue_full"
        assert set(body) == {"error", "queue_depth", "queue_cap", "reason",
                             "retry_after"}
    assert svc.stats.queue_depth_peak <= 6
    assert svc.stats.rejected == len(rejected)
    assert _get(svc.url + "/stats")["rejected"] == len(rejected)


def test_microbatch_off_restores_the_direct_path(workers, service):
    w = workers()
    svc = service(microbatch=False)
    assert svc.batcher is None
    status, _, body = _post(svc.url + "/predict", {"queries": [1, 2]})
    assert status == 200 and body["predictions"] == _expected([1, 2])
    stats = _get(svc.url + "/stats")
    assert stats["microbatch"] is False
    assert stats["batches"] == 0 and stats["requests"] == 1
    assert "knobs" not in stats and w.served_sizes == [2]
    health = _get(svc.url + "/")
    assert health["n_workers"] == 1 and health["microbatch"] is False


ENV = "RAFIKI_TPU_SERVING_"


@pytest.mark.parametrize("env,kw,want", [
    ({}, {}, {"microbatch": True, "shard": True, "fill_window": 0.005,
              "fill_window_min": 0.0, "fill_window_max": 0.005,
              "max_batch": 1024, "max_inflight": 2, "queue_cap": 4096,
              "client_header": "", "client_share": 0.0}),
    ({"MICROBATCH": "0", "SHARD_REPLICAS": "off"}, {},
     {"microbatch": False, "shard": False}),
    ({"MICROBATCH": "0", "SHARD_REPLICAS": "0"},
     {"microbatch": True, "shard_replicas": True},
     {"microbatch": True, "shard": True}),
    ({"FILL_WINDOW": "0.02", "QUEUE_CAP": "99", "MAX_BATCH": "7",
      "MAX_INFLIGHT": "3"}, {},
     {"fill_window": 0.02, "fill_window_max": 0.02, "queue_cap": 99,
      "max_batch": 7, "max_inflight": 3}),
    ({"FILL_WINDOW_MIN": "0.001", "FILL_WINDOW_MAX": "0.03"}, {},
     {"fill_window_min": 0.001, "fill_window_max": 0.03}),
    ({"FILL_WINDOW_MAX": "0.03"}, {"fill_window_max": 0.04,
                                   "queue_cap": 5},
     {"fill_window_max": 0.04, "queue_cap": 5}),
    ({"CLIENT_HEADER": "X-Client-Id", "CLIENT_SHARE": "0.5"}, {},
     {"client_header": "X-Client-Id", "client_share": 0.5}),
    ({"CLIENT_SHARE": "0.5"}, {}, {"client_header": "",
                                   "client_share": 0.0}),
])
def test_knobs_resolve_argument_then_env_then_default(bus, monkeypatch,
                                                      env, kw, want):
    for k in ("MICROBATCH", "SHARD_REPLICAS", "FILL_WINDOW",
              "FILL_WINDOW_MIN", "FILL_WINDOW_MAX", "MAX_BATCH",
              "MAX_INFLIGHT", "QUEUE_CAP", "CLIENT_HEADER", "CLIENT_SHARE"):
        monkeypatch.delenv(ENV + k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(ENV + k, v)
    svc = PredictorService.for_job("s", "job", None, bus, **kw)
    try:
        b = svc.batcher
        got = {"microbatch": b is not None,
               "shard": svc.predictor.shard_replicas,
               "client_header": svc.client_header}
        if b is not None:
            got.update(fill_window=b.fill_window,
                       fill_window_min=b.fill_window_min,
                       fill_window_max=b.fill_window_max,
                       max_batch=b.max_batch, max_inflight=b.max_inflight,
                       queue_cap=b.queue_cap, client_share=b.client_share)
        assert {k: got[k] for k in want} == want
    finally:
        svc.stop()


def test_stop_fails_waiters_fast_and_rejects_late_submits(bus):
    Cache(bus).register_worker("job", "w1", info={"trial_id": "t1"})
    # No worker: scattered batches never get replies.
    mb = MicroBatcher(_predictor(bus, gather_timeout=3.0), fill_window=0.01,
                      max_batch=2, max_inflight=1, queue_cap=64).start()
    outcomes = []

    def client(i):
        t0 = time.monotonic()
        try:
            mb.submit([i], timeout=60)
            outcomes.append(("ok", time.monotonic() - t0))
        except RuntimeError as e:
            outcomes.append((str(e), time.monotonic() - t0))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    [t.start() for t in threads]
    time.sleep(0.5)  # the first batch in flight, the rest queued
    mb.stop()
    [t.join(timeout=10) for t in threads]
    assert len(outcomes) == 4
    for msg, elapsed in outcomes:
        assert "micro-batcher stopped" in msg
        assert elapsed < 15, "a waiter hung past stop()"
    assert mb.stats.snapshot()["batches"] >= 1  # one was in flight
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit([1], timeout=5)


def test_service_stop_answers_waiting_requests(bus):
    """``PredictorService.stop`` stops the batcher before the HTTP
    server: a request waiting on a dead replica is answered at once
    (500, the batcher stopped), not left to its timeout."""
    Cache(bus).register_worker("job", "w1", info={"trial_id": "t1"})
    svc = PredictorService.for_job("svc", "job", None, bus).start()
    svc.predictor.gather_timeout = 3.0
    out = []
    t = threading.Thread(target=lambda: out.append(
        _post(svc.url + "/predict", {"query": 1})))
    t.start()
    time.sleep(0.5)
    t0 = time.monotonic()
    svc.stop()
    t.join(timeout=15)
    assert out and out[0][0] == 500 and "stopped" in out[0][2]["error"]
    assert time.monotonic() - t0 < 10
    assert not svc.running


def test_empty_and_oversized_requests(bus, workers, batcher):
    workers()
    mb = batcher(_predictor(bus), fill_window=0.01, max_batch=4,
                 max_inflight=1, queue_cap=4)
    assert mb.submit([], timeout=5) == []
    big = list(range(10))  # past queue_cap and max_batch
    assert mb.submit(big, timeout=15) == _expected(big)


def test_choose_workers_race_free(bus):
    cache = Cache(bus)
    for w, t in (("wA1", "tA"), ("wA2", "tA"), ("wB", "tB")):
        cache.register_worker("job", w, info={"trial_id": t})
    p = _predictor(bus)
    bad = []

    def spin(_):
        for _ in range(50):
            pick = p._choose_workers()
            if len(pick) != 2 or "wB" not in pick or \
                    (("wA1" in pick) == ("wA2" in pick)):
                bad.append(pick)

    _run(spin, 8)
    assert not bad, bad[:3]
    assert p._rr == 8 * 50


# --- Replica sharding ---


@pytest.mark.parametrize("shard", [True, False])
def test_shard_split_and_its_switch(bus, workers, shard):
    wa = workers("wA1", trial_id="tA")
    wb = workers("wA2", trial_id="tA")
    p = _predictor(bus, shard_replicas=shard)
    qs = list(range(10))
    assert p.predict(qs) == _expected(qs)
    sizes = wa.served_sizes + wb.served_sizes
    if shard:
        assert wa.served_sizes and wb.served_sizes
        assert max(sizes) < 10 and sum(sizes) == 10
    else:
        assert sizes == [10], sizes  # one rotating replica, whole batch


def test_shard_uneven_replica_counts_and_order(bus, workers):
    reps = [workers(f"wA{i}", trial_id="tA") for i in range(3)]
    single = workers("wB", trial_id="tB")
    p = _predictor(bus)
    for n in (1, 2, 7):  # fewer queries than replicas, uneven splits
        qs = list(range(100, 100 + n))
        assert p.predict(qs) == _expected(qs), n
    assert single.served_sizes == [1, 2, 7]
    assert sum(sum(w.served_sizes) for w in reps) == 10


@pytest.mark.parametrize("n_dead", [1, 2])
def test_a_dead_replica_is_resubmitted_to_a_live_sibling(bus, workers,
                                                         n_dead):
    """A replica that stopped serving but is still registered: its shard
    goes to a live sibling at the partial deadline (never to a sibling
    that missed the same deadline), well before the gather timeout, and
    it is quarantined out of the next plan."""
    dead = [workers(f"wA{i}", trial_id="tA", dead=True)
            for i in range(n_dead)]
    live = workers("wA9", trial_id="tA")
    p = _predictor(bus, gather_timeout=4.0)
    qs = list(range(9))
    t0 = time.monotonic()
    assert p.predict(qs) == _expected(qs)
    assert time.monotonic() - t0 < 3.5
    assert sum(live.served_sizes) == 9
    assert p._m_resubmits.value(service=p.service) == n_dead
    assert p._m_quarantines.value(service=p.service) == n_dead
    live.served_sizes.clear()
    assert p.predict(qs) == _expected(qs)
    assert live.served_sizes == [9]
    assert all(not w.served_sizes for w in dead)
    p.close()


def test_quarantine_expires_doubles_and_resets(bus, workers):
    """A penalty expires after its quarantine and the replica is probed
    again; a missed probe doubles the next quarantine; a reply resets
    the ladder."""
    flaky = workers("wA1", trial_id="tA", dead=True)
    workers("wA2", trial_id="tA")
    p = _predictor(bus, gather_timeout=0.6)
    qs = list(range(8))
    assert p.predict(qs) == _expected(qs)  # the resubmit covered it
    assert "wA1" in p._penalized and p._strikes["wA1"] == 1
    with p._state_lock:
        assert p._quarantine_s("wA1") == 0.6
    time.sleep(0.7)  # one quarantine: the next plan probes wA1 again
    assert p.predict(qs) == _expected(qs)
    assert p._strikes["wA1"] == 2  # still dead: a second strike
    with p._state_lock:
        assert p._quarantine_s("wA1") == 1.2
    flaky.dead = False  # it comes back
    time.sleep(1.3)
    assert p.predict(qs) == _expected(qs)
    assert flaky.served_sizes, "the recovered replica never rejoined"
    assert "wA1" not in p._strikes


def test_a_partial_bin_degrades_not_stalls(bus, workers):
    """A dead bin with no sibling costs only its own vote."""
    workers("wA", trial_id="tA", dead=True)
    workers("wB", trial_id="tB")
    p = _predictor(bus, gather_timeout=1.0)
    assert p.predict([1, 2, 3]) == _expected([1, 2, 3])
    assert p._m_resubmits.value(service=p.service) == 0


def test_old_worker_without_shard_echo_still_matches(bus, workers):
    workers("wA1", trial_id="tA", echo_shard=False)
    workers("wA2", trial_id="tA", echo_shard=False)
    p = _predictor(bus)
    assert p.predict(list(range(6))) == _expected(range(6))


def test_latency_weighted_split_prefers_fast_replica(bus, workers):
    slow = workers("wA1", trial_id="tA", delay=0.20)
    fast = workers("wA2", trial_id="tA")
    p = _predictor(bus)
    qs = list(range(12))
    for _ in range(4):
        assert p.predict(qs) == _expected(qs)
    assert sum(fast.served_sizes) > sum(slow.served_sizes), \
        (fast.served_sizes, slow.served_sizes)


def test_sharded_scatter_through_microbatcher(bus, workers, batcher):
    wa = workers("wA1", trial_id="tA")
    wb = workers("wA2", trial_id="tA")
    mb = batcher(_predictor(bus), fill_window=0.05, max_batch=256,
                 max_inflight=2, queue_cap=1024)
    out, errors = {}, []
    barrier = threading.Barrier(10)

    def client(i):
        try:
            barrier.wait()
            qs = [i * 100 + j for j in range(1 + i % 5)]
            out[i] = (qs, mb.submit(qs, timeout=15))
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    _run(client, 10)
    assert not errors and len(out) == 10
    for i, (qs, preds) in out.items():
        assert preds == _expected(qs), f"client {i} got another's slice"
    assert wa.served_sizes and wb.served_sizes


# --- Per-client fairness ---


def test_client_share_caps_one_client_not_others(bus, workers, batcher):
    workers(delay=0.3)  # slow: the queue backs up
    mb = batcher(_predictor(bus), fill_window_min=0.0, fill_window_max=0.01,
                 max_batch=4, max_inflight=1, queue_cap=40,
                 client_share=0.25)  # 10 queries a client
    results = {"hog_429": 0, "hog_ok": 0, "other_ok": 0, "other_429": 0}
    lock = threading.Lock()

    def hog(i):
        try:
            mb.submit([i] * 5, timeout=30, client="hog")
            key = "hog_ok"
        except Backpressure as e:
            assert e.reason == "client_share", e.reason
            key = "hog_429"
        with lock:
            results[key] += 1

    def other(i):
        try:
            mb.submit([i], timeout=30, client=f"c{i}")
            key = "other_ok"
        except Backpressure:
            key = "other_429"
        with lock:
            results[key] += 1

    hogs = [threading.Thread(target=hog, args=(i,)) for i in range(8)]
    [t.start() for t in hogs]
    time.sleep(0.15)  # the hog floods first
    others = [threading.Thread(target=other, args=(i,)) for i in range(6)]
    [t.start() for t in others]
    [t.join(timeout=60) for t in hogs + others]
    assert results["hog_429"] > 0, results
    assert results["other_ok"] == 6, results
    assert mb.stats.snapshot()["rejected_by_reason"].get(
        "client_share", 0) == results["hog_429"]


def test_client_share_off_by_default(bus, workers, batcher):
    workers()
    mb = batcher(_predictor(bus), fill_window=0.01, max_batch=64,
                 queue_cap=64)
    assert mb.submit([1, 2, 3], timeout=10, client="x") == \
        _expected([1, 2, 3])
    assert mb._client_pending == {}


@pytest.mark.parametrize("header", ["X-Client-Id", ""])
def test_direct_path_client_share_caps_inflight(workers, service, header):
    """Micro-batching off: the same share caps one client's queries in
    flight, and only with a client header configured."""
    workers(delay=0.4)  # slow: requests stay in flight
    svc = service(microbatch=False, client_header=header,
                  client_share=0.25, queue_cap=16)  # 4 queries a client
    results = {"hog_ok": 0, "hog_429": 0, "other_ok": 0}
    lock = threading.Lock()

    def post(n, client, key):
        status, headers, body = _post(svc.url + "/predict",
                                      {"queries": list(range(n))},
                                      headers={"X-Client-Id": client})
        if status == 429:
            assert body["reason"] == "client_share", body
            assert headers.get("Retry-After") == "1"
            key = key.replace("ok", "429")
        else:
            assert status == 200, body
        with lock:
            results[key] += 1

    assert svc.batcher is None and svc._direct_cap == (4 if header else 0)
    hogs = [threading.Thread(target=post, args=(3, "hog", "hog_ok"))
            for _ in range(6)]
    [t.start() for t in hogs]
    time.sleep(0.1)  # the hog's slices are in flight
    others = [threading.Thread(target=post, args=(1, f"c{i}", "other_ok"))
              for i in range(4)]
    [t.start() for t in others]
    [t.join(timeout=30) for t in hogs + others]
    assert results["other_ok"] == 4, results
    assert (results["hog_429"] > 0) is bool(header), results
    assert svc.stats.snapshot()["rejected_by_reason"].get(
        "client_share", 0) == results["hog_429"]
    assert svc._direct_pending == {}


def test_a_quarantined_replica_takes_no_single_query_batch(bus, workers):
    """While a replica sits out its quarantine, every batch of its bin,
    a single query included, goes to a sibling; the reference's rotating
    pick still sends it every other single query, each of which then
    waits out the fixed straggler deadline (half the gather timeout)."""
    from rafiki_tpu.bus import MemoryBus as RefBus
    from rafiki_tpu.predictor import Predictor as RefPredictor

    dead = workers("wA1", trial_id="tA", dead=True)
    live = workers("wA2", trial_id="tA")
    p = _predictor(bus, gather_timeout=4.0)
    assert p.predict(list(range(4))) == _expected(range(4))
    assert "wA1" in p._penalized
    live.served_sizes.clear()
    t0 = time.monotonic()
    for q in range(6):
        assert p.predict([q]) == _expected([q])
    assert time.monotonic() - t0 < 1.5  # no straggler deadline waited
    assert live.served_sizes == [1] * 6 and not dead.served_sizes
    ref = RefPredictor("job", RefBus(), gather_timeout=4.0)
    ref._penalize("wA1")
    picks = {ref._plan_for(1, {"tA": ["wA1", "wA2"]}, rr, {})[0].worker
             for rr in range(2)}
    assert picks == {"wA1", "wA2"}
    assert {s.worker for rr in range(2)
            for s in p._plan_for(1, {"tA": ["wA1", "wA2"]}, rr, {})} == \
        {"wA2"}
    ref.close()
    p.close()
