"""The port's cluster serving fabric held against the reference's (after
``tests/test_cluster.py``): the node registry and its spread vote,
``GET /nodes`` and the ``/status`` fold, the broker relay (one hop a
leg, a dead peer's fallback), the edge-cache fabric (a peer hit, a
gossiped invalidation, the epoch race), per-node scrape targets, the
admin's invalidation fan-out, and no cluster surface with the fabric
off.

Where a scenario runs on both packages in one process, the port's relay
counters and fabric events are held equal to the reference's. Each
package counts in its own registry; a counter is read as the change
over the scenario, polled to a deadline, never while a hop may still be
in flight. The registry-wide form of the "off" contract (no series, no
thread) runs in a fresh process of its own.
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
from pathlib import Path

import numpy as np
import pytest

from rafiki_torch import faults
from rafiki_torch.admin.nodes import NodeRegistry, node_key
from rafiki_torch.admin.scrape import (ScrapeCache, merge_worker_expositions,
                                       worker_metrics_addrs,
                                       worker_scrape_targets)
from rafiki_torch.bus import BusServer, MemoryBus
from rafiki_torch.observe.metrics import registry as port_registry
from rafiki_torch.predictor.edge_cache import EdgeCache
from rafiki_torch.utils.service import JsonHttpServer

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 10.0


@pytest.fixture(autouse=True)
def _clean_fault_plane(monkeypatch):
    monkeypatch.delenv("RAFIKI_TPU_CLUSTER_FABRIC", raising=False)
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def _pkg(name):
    """The modules one scenario uses, from the port or the reference."""
    if name == "port":
        from rafiki_torch import bus, cache
        from rafiki_torch.admin import nodes
        from rafiki_torch.observe import metrics
        from rafiki_torch.predictor.app import PredictorService
    else:
        from rafiki_tpu import bus, cache
        from rafiki_tpu.admin import nodes
        from rafiki_tpu.observe import metrics
        from rafiki_tpu.predictor.app import PredictorService
    return {"bus": bus, "cache": cache, "nodes": nodes,
            "registry": metrics.registry, "PredictorService":
            PredictorService}


def _poll(fn, want, what):
    """``fn()`` once it equals ``want``, or fail at the deadline."""
    deadline = time.monotonic() + DEADLINE_S
    while True:
        got = fn()
        if got == want or time.monotonic() > deadline:
            assert got == want, (what, got)
            return got
        time.sleep(0.02)


# --- The node registry ---


def _registry_run(name):
    mods = _pkg(name)
    bus = mods["bus"].MemoryBus()
    make = mods["nodes"].NodeRegistry
    ra = make(lambda: bus, "vm/a", n_chips=2, bus_uri="tcp://127.0.0.1:1",
              lease_s=5.0)
    rb = make(lambda: bus, "vm/b", n_chips=2, bus_uri="tcp://127.0.0.1:2",
              lease_s=5.0)
    out = []
    try:
        ra.announce()
        rb.announce()
        nodes = ra.nodes()
        out.append(sorted((n, r["chips"], r["bus"], r["live"])
                          for n, r in nodes.items()))
        out.append((ra.live_nodes(), ra.relay_peers()))
        rec = bus.get(mods["nodes"].node_key("vm/b"))
        rec["hb"] = time.time() - 60.0
        bus.set(mods["nodes"].node_key("vm/b"), rec)
        out.append((ra.live_nodes(), ra.relay_peers(), ra.health()))
        rb.withdraw()
        snap = ra.snapshot()
        out.append((sorted(ra.nodes()), ra.health(), snap["enabled"],
                     snap["node_id"], snap["lease_s"]))
    finally:
        ra.close()
        rb.close()
    return out


def test_registry_announce_live_withdraw_as_the_reference():
    port = _registry_run("port")
    assert port == _registry_run("ref")
    assert port[0] == [("vm/a", 2, "tcp://127.0.0.1:1", True),
                       ("vm/b", 2, "tcp://127.0.0.1:2", True)]
    assert port[1] == (["vm/a", "vm/b"], {"vm/b": "tcp://127.0.0.1:2"})
    assert port[2][:2] == (["vm/a"], {})
    assert port[3][:2] == (["vm/a"], {"fabric": True,
                                      "nodes_registered": 1,
                                      "nodes_live": 1})
    # close() dropped the registry's gauge.
    g = port_registry().find("rafiki_tpu_node_peers")
    assert g is None or not g.samples()


def test_node_key_and_a_record_without_a_heartbeat():
    bus = MemoryBus()
    assert node_key("vm/x") == "n:vm/x"
    bus.set("n:vm/x", {"node": "vm/x", "hb": "soon"})
    bus.set("n:vm/y", "not a record")
    reg = NodeRegistry(lambda: bus, "vm/a", lease_s=5.0)
    try:
        nodes = reg.nodes()
        assert list(nodes) == ["vm/x"] and not nodes["vm/x"]["live"]
        assert reg.live_nodes() == []
    finally:
        reg.close()


@pytest.mark.parametrize("counts", [
    {"vm/a": 1}, {"vm/a": 1, "vm/b": 1, "vm/c": 1}, {},
    {"vm/b": 2, "vm/c": 1}, {"vm/a": 3, "vm/b": 0, "vm/c": 0},
    {"vm/ghost": 4}])
def test_spread_vote_as_the_reference(counts):
    votes = {}
    for name in ("port", "ref"):
        mods = _pkg(name)
        bus = mods["bus"].MemoryBus()
        regs = {n: mods["nodes"].NodeRegistry(lambda b=bus: b, n,
                                              lease_s=5.0)
                for n in ("vm/a", "vm/b", "vm/c")}
        lone = mods["nodes"].NodeRegistry(lambda b=bus: b, "vm/lone")
        try:
            for r in regs.values():
                r.announce()
            votes[name] = ({n: r.spread_ok(counts)
                            for n, r in regs.items()},
                           lone.spread_ok(counts))
        finally:
            for r in (*regs.values(), lone):
                r.close()
    assert votes["port"] == votes["ref"]
    by_node, lone_vote = votes["port"]
    assert sum(by_node.values()) == 1  # exactly one node acts a round
    assert lone_vote is True  # a node the registry cannot see votes yes


# --- GET /nodes and the /status fold ---


def _get(port, path, token):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Authorization":
                                          f"Bearer {token}"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_get_nodes_off_and_on(tmp_path, monkeypatch):
    from rafiki_torch.client import Client
    from rafiki_torch.platform import LocalPlatform

    p = LocalPlatform(workdir=str(tmp_path / "off"), supervise_interval=0,
                      device="cpu", http=True)
    try:
        assert p.node_registry is None
        assert p.services.node_registry is None
        c = Client(admin_port=p.admin_port)
        token = c.login("superadmin@rafiki", "rafiki")["token"]
        assert _get(p.admin_port, "/nodes", token) == {"enabled": False}
        assert "cluster" not in _get(p.admin_port, "/status", token)
    finally:
        p.shutdown()
    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_FABRIC", "1")
    p = LocalPlatform(workdir=str(tmp_path / "on"), supervise_interval=0,
                      device="cpu", http=True, node_id="vm/reg")
    try:
        assert p.services.node_registry is p.node_registry
        c = Client(admin_port=p.admin_port)
        token = c.login("superadmin@rafiki", "rafiki")["token"]
        body = _get(p.admin_port, "/nodes", token)
        assert body["enabled"] and body["node_id"] == "vm/reg"
        assert body["nodes"]["vm/reg"]["live"]
        assert body["nodes"]["vm/reg"]["chips"] == 1
        assert _get(p.admin_port, "/status", token)["cluster"] == {
            "fabric": True, "nodes_registered": 1, "nodes_live": 1}
        p.services.heartbeat()  # the announce rides the heartbeat
        assert p.bus.get(node_key("vm/reg"))["node"] == "vm/reg"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{p.admin_port}/nodes", timeout=30)
        assert e.value.code == 401
    finally:
        p.shutdown()
    g = port_registry().find("rafiki_tpu_node_peers")
    assert g is None or not g.samples()


def test_two_nodes_on_one_workdir_list_each_other(tmp_path, monkeypatch):
    from rafiki_torch.platform import LocalPlatform

    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_FABRIC", "1")
    broker = BusServer().start()
    a = b = None
    try:
        a = LocalPlatform(workdir=str(tmp_path / "w"), device="cpu",
                          supervise_interval=0, bus_uri=broker.uri)
        b = LocalPlatform(workdir=str(tmp_path / "w"), device="cpu",
                          supervise_interval=0, bus_uri=broker.uri,
                          node_id="vm/join", stop_jobs_on_shutdown=False,
                          adopt_unowned=False)
        nodes = a.admin.get_nodes()["nodes"]
        assert sorted(nodes) == sorted([a.services.node_id, "vm/join"])
        assert all(r["live"] for r in nodes.values())
        assert a.admin.get_status()["cluster"]["nodes_live"] == 2
        assert a.node_registry.relay_peers() == {"vm/join": broker.uri}
        b.shutdown()
        b = None
        assert list(a.admin.get_nodes()["nodes"]) == [a.services.node_id]
    finally:
        if b is not None:
            b.shutdown()
        if a is not None:
            a.shutdown()
        broker.stop()


# --- The broker relay ---


def _relay_counts(registry):
    c = registry().find("rafiki_tpu_bus_relay_total")
    if c is None:
        return {}
    return {lab["direction"]: int(v) for lab, v in c.samples()}


def _delta(registry, base):
    after = _relay_counts(registry)
    return {k: after.get(k, 0) - base.get(k, 0)
            for k in ("out", "in", "fallback")}


def _remote_scatter(name):
    """A shard from node a to a worker on node b, and its reply: the
    relay counters' change once both hops have landed, and the
    replies."""
    mods = _pkg(name)
    serve_broker = mods["bus"].serve_broker
    broker_a = serve_broker("127.0.0.1", 0, native=False, node_id="vm/a")
    broker_b = serve_broker("127.0.0.1", 0, native=False, node_id="vm/b")
    stop = threading.Event()
    worker = None
    try:
        broker_a.add_peer("vm/b", broker_b.uri)
        broker_b.add_peer("vm/a", broker_a.uri)
        cache_a = mods["cache"].Cache(mods["bus"].connect(broker_a.uri))
        cache_b = mods["cache"].Cache(mods["bus"].connect(broker_b.uri))
        cache_b.register_worker("job-r", "wb",
                                info={"trial_id": "t", "score": 0.9})

        def serve():
            while not stop.is_set():
                for it in cache_b.pop_queries("wb", timeout=0.1):
                    cache_b.send_prediction_batch(
                        it["batch_id"], "wb",
                        [[float(len(it["queries"]))]] * len(
                            it["queries"]),
                        shard=it.get("shard"),
                        origin_node=it.get("onode"))

        worker = threading.Thread(target=serve, daemon=True)
        worker.start()
        base = _relay_counts(mods["registry"])
        enc = mods["cache"].encode_payload
        bid = cache_a.send_query_shards(
            [("wb", 0, 2, 0)], [enc([1.0, 2.0]), enc([3.0, 4.0])],
            worker_nodes={"wb": "vm/b"}, local_node="vm/a")
        replies = cache_a.gather_prediction_batches(bid, 1, timeout=10.0)
        preds = [[float(x) for x in p] for r in replies
                 for p in r["predictions"]]
        # The reply's 'out' is counted after its frame landed: poll.
        delta = _poll(lambda: _delta(mods["registry"], base),
                      {"out": 2, "in": 2, "fallback": 0},
                      f"{name} relay counters")
        # A local scatter pays no hop.
        base = _relay_counts(mods["registry"])
        bid = cache_b.send_query_shards(
            [("wb", 0, 1, 0)], [enc([5.0])], worker_nodes={"wb": "vm/b"},
            local_node="vm/b")
        local = cache_b.gather_prediction_batches(bid, 1, timeout=10.0)
        assert len(local) == 1
        assert _delta(mods["registry"], base) == \
            {"out": 0, "in": 0, "fallback": 0}
        return delta, preds
    finally:
        stop.set()
        if worker is not None:
            worker.join(timeout=5)
        broker_b.stop()
        broker_a.stop()


def test_a_remote_scatter_pays_one_relay_hop_a_leg_as_the_reference():
    port = _remote_scatter("port")
    assert port == _remote_scatter("ref")
    assert port == ({"out": 2, "in": 2, "fallback": 0}, [[2.0], [2.0]])


def _dead_peer(name):
    mods = _pkg(name)
    serve_broker = mods["bus"].serve_broker
    broker_a = serve_broker("127.0.0.1", 0, native=False, node_id="vm/a")
    broker_b = serve_broker("127.0.0.1", 0, native=False, node_id="vm/b")
    try:
        broker_a.add_peer("vm/b", broker_b.uri)
        bus_a = mods["bus"].connect(broker_a.uri)
        broker_b.stop()
        base = _relay_counts(mods["registry"])
        t0 = time.monotonic()
        bus_a.relay_push("vm/b", "dead-q", {"v": 7})
        elapsed = time.monotonic() - t0
        delta = _delta(mods["registry"], base)
        landed = bus_a.pop("dead-q", timeout=2.0)
        # An unknown node falls back the same way.
        bus_a.relay_push_many("vm/nobody", [("dead-q", {"v": 8})])
        unknown = bus_a.pop("dead-q", timeout=2.0)
        assert elapsed < 10.0, elapsed
        return delta, landed, unknown
    finally:
        broker_b.stop()
        broker_a.stop()


def test_a_dead_peer_falls_back_to_the_local_broker_as_the_reference():
    port = _dead_peer("port")
    assert port == _dead_peer("ref")
    assert port == ({"out": 0, "in": 0, "fallback": 1}, {"v": 7},
                    {"v": 8})


def test_a_single_node_has_no_cluster_surface():
    from rafiki_torch.bus import serve_broker
    from rafiki_torch.predictor.app import PredictorService

    broker = serve_broker("127.0.0.1", 0, native=False)
    try:
        assert broker.node_id == ""
        assert broker._server.relay_counter is None
    finally:
        broker.stop()
    svc = PredictorService.for_job("zero-fab", "job-z", None, MemoryBus(),
                                   cache_bytes=1 << 16, microbatch=False)
    try:
        assert svc._fabric is False and svc._m_fabric is None
        assert svc.edge_cache is not None
        assert svc.predictor._node == ""
        assert svc.predictor._plan_nodes([]) is None
    finally:
        svc.stats.close()
        svc.predictor.close()
        svc.edge_cache.close()


# --- The edge-cache fabric ---


def _make_frontend(name, bus, sid, job):
    mods = _pkg(name)
    if name == "port":
        svc = mods["PredictorService"].for_job(
            sid, job, None, bus, cache_bytes=1 << 20, cache_admit_after=1,
            microbatch=False)
        svc.predictor.worker_wait_timeout = 10.0
        svc.predictor.gather_timeout = 10.0
        return svc.start()
    svc = mods["PredictorService"](sid, job, meta=None, bus=bus,
                                   host="127.0.0.1", cache_bytes=1 << 20,
                                   cache_admit_after=1, microbatch=False)
    svc.predictor.worker_wait_timeout = 10.0
    svc.predictor.gather_timeout = 10.0
    svc._http.start()
    if svc._fabric:
        svc.predictor.cache.register_frontend(
            job, svc.stats.service, f"127.0.0.1:{svc.port}")
    return svc


def _stop_frontend(name, svc, job):
    if name == "port":
        svc.stop()
        return
    if svc._fabric:
        svc.predictor.cache.unregister_frontend(job, svc.stats.service)
    svc._http.stop()
    svc.stats.close()
    svc.predictor.close()
    svc.edge_cache.close()
    if svc._m_fabric is not None:
        svc._m_fabric.remove(service=svc.stats.service)


def _events(name, svc):
    c = _pkg(name)["registry"]().find("rafiki_tpu_serving_fabric_total")
    if c is None:
        return {}
    return {lab["event"]: int(v) for lab, v in c.samples()
            if lab.get("service") == svc.stats.service}


def _post(svc, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{svc.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _fabric_run(name):
    """Two frontends of one job: a miss on B is answered by A's cache; a
    direct invalidation on A reaches B, whose next query scatters."""
    mods = _pkg(name)
    bus = mods["bus"].MemoryBus()
    wcache = mods["cache"].Cache(bus)
    served = {"n": 0}
    stop = threading.Event()
    wcache.register_worker("job-f", "wf", info={"trial_id": "t",
                                                "score": 0.9})

    def serve():
        while not stop.is_set():
            for it in wcache.pop_queries("wf", timeout=0.1):
                qs = it["queries"] if "queries" in it else list(it["batch"])
                served["n"] += len(qs)
                wcache.send_prediction_batch(
                    it["batch_id"], "wf",
                    [[0.8, float(np.sum(q)) / 100.0] for q in qs],
                    shard=it.get("shard"), compute_s=0.001 * len(qs))

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    fa = fb = None
    out = {}
    try:
        fa = _make_frontend(name, bus, "cfa", "job-f")
        fb = _make_frontend(name, bus, "cfb", "job-f")
        assert fa._fabric and fb._fabric
        q = mods["cache"].encode_payload(np.array([3.0, 4.0], np.float32))
        a1 = _post(fa, "/predict", {"query": q})["prediction"]
        out["after_a"] = served["n"]
        b1 = _post(fb, "/predict", {"query": q})["prediction"]
        out["after_b"] = served["n"]
        out["same"] = a1 == b1
        out["b_events"] = _events(name, fb)
        epoch_b = fb.edge_cache.epoch
        _post(fa, "/cache/invalidate", {})
        _poll(lambda: fb.edge_cache.epoch > epoch_b, True, "gossip landed")
        out["a_events"] = _events(name, fa)
        _post(fb, "/predict", {"query": q})
        out["final"] = served["n"]
        out["b_events_final"] = _events(name, fb)
        return out
    finally:
        for svc in (fa, fb):
            if svc is not None:
                _stop_frontend(name, svc, "job-f")
        stop.set()
        worker.join(timeout=5)


def test_a_peer_hit_and_a_gossiped_invalidation_as_the_reference(
        monkeypatch):
    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_FABRIC", "1")
    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S", "2.0")
    port = _fabric_run("port")
    assert port == _fabric_run("ref")
    assert port["after_a"] == 1 and port["after_b"] == 1  # no 2nd scatter
    assert port["same"]  # the peer's answer is the scatter's
    assert port["b_events"] == {"peer_hit": 1}
    assert port["a_events"] == {"peer_miss": 1, "gossip_sent": 1}
    # B's next query misses, finds A empty too, and scatters.
    assert port["final"] == 2
    assert port["b_events_final"] == {"peer_hit": 1, "gossip_recv": 1,
                                      "peer_miss": 1}


def test_gossip_racing_a_local_insert_never_resurrects_it():
    cache = EdgeCache(max_bytes=1 << 16, admit_after=1, service="race-t")
    try:
        kind, flight = cache.begin("k")
        assert kind == "lead"
        epoch = cache.epoch  # the leader's snapshot, before the scatter
        cache.invalidate()  # the gossiped invalidation lands mid-flight
        cache.resolve("k", {"answer": "stale"}, epoch, flight=flight)
        assert flight.wait(1.0) == {"answer": "stale"}
        kind, _ = cache.begin("k")
        assert kind == "lead"  # not a hit on a resurrected value
    finally:
        cache.close()


def test_a_dead_peer_costs_one_bounded_probe(monkeypatch):
    from rafiki_torch.predictor.app import PredictorService

    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_FABRIC", "1")
    monkeypatch.setenv("RAFIKI_TPU_CLUSTER_PROBE_TIMEOUT_S", "0.5")
    bus = MemoryBus()
    svc = PredictorService.for_job("cfd", "job-d", None, bus,
                                   cache_bytes=1 << 16, microbatch=False)
    try:
        bus.set("f:job-d:ghost", "127.0.0.1:9")  # nobody listens
        t0 = time.monotonic()
        assert svc._peer_probe("ab" * 32) is None
        assert time.monotonic() - t0 < 5.0
        assert svc._fabric_peers() == ["127.0.0.1:9"]
        svc._gossip_invalidate()  # logged, never raised
        c = port_registry().find("rafiki_tpu_serving_fabric_total")
        assert c.value(service=svc.stats.service,
                       event="probe_error") == 1
    finally:
        svc.stop()


# --- Scrape targets by node ---


class _BusServices:
    def __init__(self, bus):
        self._bus = bus

    def serving_bus(self):
        return self._bus


def test_scrape_targets_group_by_node_and_merge():
    bus = MemoryBus()
    bus.set("w:job1:s1", {"metrics": "127.0.0.1:9001", "node": "vm/a"})
    bus.set("w:job1:s2", {"metrics": "127.0.0.1:9002", "node": "vm/b"})
    bus.set("w:job1:s3", {"metrics": "127.0.0.1:9003", "node": "vm/b"})
    bus.set("w:job1:s4", {"trial_id": "t"})  # a thread worker: silent
    bus.set("w:job2:sx", {"metrics": "127.0.0.1:9009", "node": "vm/c"})
    by_node, silent = worker_scrape_targets(_BusServices(bus), "job1")
    assert by_node == {"vm/a": ["127.0.0.1:9001"],
                       "vm/b": ["127.0.0.1:9002", "127.0.0.1:9003"]}
    assert silent == 1
    assert worker_metrics_addrs(_BusServices(bus), "job1") == [
        "127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003"]
    calls = []

    def fetch(addr, path):
        calls.append((addr, path))
        if addr.endswith("9002"):
            raise OSError("connection refused")
        return f"# metrics from {addr}"

    text, fetched, failed = merge_worker_expositions(fetch, by_node)
    assert (fetched, failed) == (2, 1)
    assert "9001" in text and "9003" in text
    assert sorted(a for a, _ in calls) == [
        "127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003"]
    assert all(p == "/metrics" for _, p in calls)
    # The reference groups the same registry the same way.
    from rafiki_tpu.admin.scrape import worker_scrape_targets as ref_targets
    from rafiki_tpu.bus import MemoryBus as RMemoryBus

    rbus = RMemoryBus()
    for k in bus.keys(""):
        rbus.set(k, bus.get(k))
    assert ref_targets(_BusServices(rbus), "job1") == (by_node, silent)


def test_scrape_targets_of_an_empty_and_a_broken_bus():
    assert worker_scrape_targets(_BusServices(MemoryBus()),
                                 "job-none") == ({}, 0)

    class _Broken:
        def serving_bus(self):
            raise ConnectionError("broker down")

    assert worker_scrape_targets(_Broken(), "job1") == ({}, 0)


def test_the_scrape_cache_fetches_each_endpoint_once_a_sweep():
    hits = {"n": 0}

    def stats(params, body, ctx):
        hits["n"] += 1
        return 200, {"ok": True}

    server = JsonHttpServer([("GET", "/stats", stats)], host="127.0.0.1",
                            name="t-scrape").start()
    try:
        host = f"127.0.0.1:{server.port}"
        cache = ScrapeCache(timeout=5.0)
        assert cache.fetch(host, "/stats") == {"ok": True}
        assert cache.fetch(host, "/stats") == {"ok": True}
        assert hits["n"] == 1
        assert isinstance(cache.fetch(host, "/metrics"), str)
        dead = ScrapeCache(timeout=0.5)
        for _ in range(2):
            with pytest.raises(OSError):
                dead.fetch("127.0.0.1:9", "/stats")
        assert len(dead._memo) == 1
    finally:
        server.stop()


# --- The admin's invalidation fan-out ---


def test_the_admin_s_invalidation_reaches_every_registered_frontend(
        tmp_path):
    from rafiki_torch.cache import Cache
    from rafiki_torch.platform import LocalPlatform

    got = {}

    def frontend(name):
        def invalidate(params, body, ctx):
            got[name] = got.get(name, 0) + 1
            return 200, {"enabled": True, "epoch": got[name]}
        return JsonHttpServer([("POST", "/cache/invalidate", invalidate)],
                              host="127.0.0.1", name=f"t-fan-{name}").start()

    servers = {n: frontend(n) for n in ("a", "b", "row")}
    p = LocalPlatform(workdir=str(tmp_path / "w"), device="cpu",
                      supervise_interval=0)
    try:
        cache = Cache(p.services.serving_bus())
        job = {"id": "job-x",
               "predictor_host": f"127.0.0.1:{servers['row'].port}"}
        # No registry entry: the job row's one predictor.
        p.admin._invalidate_predictor_cache(job)
        assert got == {"row": 1}
        for n in ("a", "b"):
            cache.register_frontend("job-x", f"inst-{n}",
                                    f"127.0.0.1:{servers[n].port}")
        p.admin._invalidate_predictor_cache(job)
        assert got == {"row": 1, "a": 1, "b": 1}
        # A frontend that does not answer fails the promotion.
        cache.register_frontend("job-x", "inst-dead", "127.0.0.1:9")
        with pytest.raises(RuntimeError, match="did not acknowledge"):
            p.admin._invalidate_predictor_cache(job)
        cache.unregister_frontend("job-x", "inst-dead")
        assert sorted(cache.frontends("job-x")) == ["inst-a", "inst-b"]
    finally:
        p.shutdown()
        for s in servers.values():
            s.stop()


# --- No surface with the fabric off: a fresh process ---

_STACK = r'''
import json, os, re, sys, threading, urllib.request
import numpy as np
from rafiki_torch.bus import BusClient, BusServer
from rafiki_torch.cache import Cache, encode_payload
from rafiki_torch.client import Client
from rafiki_torch.observe.metrics import registry
from rafiki_torch.platform import LocalPlatform
from rafiki_torch.predictor.app import PredictorService

broker = BusServer().start()
plat = LocalPlatform(workdir=sys.argv[1], device="cpu",
                     supervise_interval=0, http=True, bus_uri=broker.uri)
wbus = BusClient(broker.host, broker.port)
wcache = Cache(wbus)
wcache.register_worker("job-o", "wo", info={"trial_id": "t"})
stop = threading.Event()

def serve():
    while not stop.is_set():
        for it in wcache.pop_queries("wo", timeout=0.1):
            n = len(it["queries"]) if "queries" in it else len(it["batch"])
            wcache.send_prediction_batch(it["batch_id"], "wo", [[1.0]] * n,
                                         shard=it.get("shard"))

worker = threading.Thread(target=serve, name="smoke-worker", daemon=True)
worker.start()
fronts = [PredictorService.for_job(f"f{i}", "job-o", None,
                                   BusClient(broker.host, broker.port),
                                   cache_bytes=1 << 16,
                                   cache_admit_after=1).start()
          for i in range(2)]
for f in fronts:
    for v in (1.0, 2.0):
        req = urllib.request.Request(
            f"{f.url}/predict",
            data=json.dumps({"query": encode_payload(
                np.full(3, v, np.float32))}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        urllib.request.urlopen(req, timeout=60).read()
c = Client(admin_port=plat.admin_port)
token = c.login("superadmin@rafiki", "rafiki")["token"]
req = urllib.request.Request(
    f"http://127.0.0.1:{plat.admin_port}/nodes",
    headers={"Authorization": f"Bearer {token}"})
nodes = json.loads(urllib.request.urlopen(req, timeout=30).read())
fams = sorted({line.split("{")[0].split(" ")[0]
               for line in registry().expose().splitlines()
               if line and not line.startswith("#")})
# A socket server's per-connection threads come and go with the
# connections; the threads the stack itself starts are what is compared.
threads = sorted(re.sub(r"[0-9a-f]{4,}|\d+", "#", t.name)
                 for t in threading.enumerate()
                 if "process_request_thread" not in t.name)
print(json.dumps({"nodes": nodes, "families": fams, "threads": threads,
                  "fabric": [f._fabric for f in fronts]}))
stop.set()
worker.join(timeout=5)
for f in fronts:
    f.stop()
plat.shutdown()
broker.stop()
'''

CLUSTER_FAMILIES = ("rafiki_tpu_node_", "rafiki_tpu_bus_relay_",
                    "rafiki_tpu_serving_fabric_",
                    "rafiki_tpu_fault_injections_total")


def _stack(tmp_path, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("RAFIKI_TPU_CLUSTER_FABRIC", faults.PLAN_ENV)}
    e.update(env)
    e["PYTHONPATH"] = str(ROOT) + os.pathsep + e.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _STACK, str(tmp_path)],
                         cwd=ROOT, env=e, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_fabric_off_adds_no_series_and_no_thread(tmp_path):
    off = _stack(tmp_path / "off")
    assert off["nodes"] == {"enabled": False}
    assert off["fabric"] == [False, False]
    assert not [f for f in off["families"]
                if f.startswith(CLUSTER_FAMILIES)], off["families"]
    assert "rafiki_tpu_serving_cache_total" in off["families"]
    # The fabric on, with an armed plan, adds series and no thread.
    on = _stack(tmp_path / "on", RAFIKI_TPU_CLUSTER_FABRIC="1",
                RAFIKI_TPU_FAULT_PLAN="bus.delay:n=1,ms=1")
    assert on["nodes"]["enabled"] and on["fabric"] == [True, True]
    for fam in ("rafiki_tpu_node_peers", "rafiki_tpu_serving_fabric_total",
                "rafiki_tpu_fault_injections_total"):
        assert fam in on["families"], fam
    assert on["threads"] == off["threads"]
