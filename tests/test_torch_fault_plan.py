"""The port's fault-injection plane (``rafiki_torch/faults.py``) held
against the reference's (``rafiki_tpu/faults.py``, after
``tests/test_faults.py``).

One table of plans parses to equal rules in both packages, or is
refused by both; one seed gives both the same fire sequence for ``p=``,
``n=`` and ``every=``; a disarmed plane gives every site ``None`` and
leaves the memory bus and the HTTP server as they were; and each site
of the port (the memory bus, the TCP client, the HTTP server) injects
what its rule says, counted in ``rafiki_tpu_fault_injections_total``.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from rafiki_torch import faults
from rafiki_torch.bus import BusClient, BusServer, MemoryBus
from rafiki_torch.config import NodeConfig
from rafiki_torch.observe.metrics import registry
from rafiki_torch.utils.service import JsonHttpServer
from rafiki_tpu import faults as rfaults
from rafiki_tpu.config import NodeConfig as RNodeConfig

COUNTER = "rafiki_tpu_fault_injections_total"


@pytest.fixture(autouse=True)
def _clean_fault_planes(monkeypatch):
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    monkeypatch.delenv(faults.SEED_ENV, raising=False)
    faults.reset()
    rfaults.reset()
    yield
    faults.reset()
    rfaults.reset()


def _injections(site=None, kind=None) -> float:
    c = registry().find(COUNTER)
    if c is None:
        return 0.0
    return sum(v for lab, v in c.samples()
               if (site is None or lab["site"] == site)
               and (kind is None or lab["kind"] == kind))


def _rules(plan):
    return {site: [(r.kind, dict(r.params)) for r in rules]
            for site, rules in plan.rules.items()}


PLANS = [
    "", ";", "bus.drop", "bus.delay:ms=5", "bus.disconnect:n=1,op=push",
    "bus.drop:op=push; http.error:code=502,route=/predict ;"
    "worker.crash:n=3",
    "worker.slow:p=0.25,ms=600", "node.kill:op=vm/b,n=1",
    "http.timeout:every=4,ms=80", "worker.crash:n=1;bus.delay:p=0.02,ms=2",
    " bus.drop : op = push_many , kind = query ",
    "http.error:route=/predict,n=1",
    # Refused by both:
    "bus.explode", "gpu.delay:ms=5", "bus.delay:ms", "bus.delay:ms=abc",
    "worker.crash:n=two", "bus.delay:probability=0.02,ms=2",
    "worker.crash:N=2", "bus.delay:p=0.5,n=3", "http.error:code=5xx",
    "node.kill:every=x", "worker", "bus.", ".drop"]


@pytest.mark.parametrize("text", PLANS)
def test_plans_parse_as_the_reference(text):
    got = []
    for mod in (faults, rfaults):
        try:
            got.append(_rules(mod.FaultPlan.parse(text, seed=3)))
        except ValueError:
            got.append("refused")
    assert got[0] == got[1]


@pytest.mark.parametrize("text,calls", [
    ("bus.drop:p=0.5,op=push", 256), ("bus.drop:p=0.02", 512),
    ("bus.drop:n=7", 32), ("bus.drop:every=3,op=push", 30),
    ("bus.drop:p=0.3;bus.drop:p=0.7,op=push;bus.drop:every=5", 200)])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_a_seed_gives_the_reference_s_fire_sequence(text, calls, seed):
    seqs = []
    for mod in (faults, rfaults):
        plan = mod.FaultPlan.parse(text, seed=seed)
        seqs.append([plan.fire("bus", op="push", kind="query") is not None
                     for _ in range(calls)])
    assert seqs[0] == seqs[1]
    if "p=0.5" in text:
        assert any(seqs[0]) and not all(seqs[0])


def test_another_seed_gives_another_sequence():
    def draw(seed):
        plan = faults.FaultPlan.parse("bus.drop:p=0.5", seed=seed)
        return [plan.fire("bus", op="push") is not None
                for _ in range(64)]

    assert draw(7) == draw(7)
    assert draw(7) != draw(8)


def test_match_keys_filter_and_do_not_advance_counters():
    plan = faults.FaultPlan.parse("bus.drop:op=push,kind=query")
    assert plan.fire("bus", op="push", kind="reply") is None
    assert plan.fire("bus", op="pop", kind="query") is None
    assert plan.fire("bus", op="push", kind="query") == ("drop", None)
    plan = faults.FaultPlan.parse("http.error:n=2,route=/a")
    assert plan.fire("http", op="GET", route="/b") is None
    assert plan.fire("http", op="GET", route="/a") is None
    assert plan.fire("http", op="GET", route="/a") == ("error", 503)
    plan = faults.FaultPlan.parse("node.kill:op=vm/b")
    assert plan.fire("node", op="vm/a") is None
    assert plan.fire("node", op="vm/b") == ("kill", None)


def test_site_hook_is_none_when_disarmed_and_set_plan_rearms():
    for site in faults.SITES:
        assert faults.site_hook(site) is None
    with pytest.raises(ValueError):
        faults.site_hook("gpu")
    with pytest.raises(ValueError):
        faults.set_plan("bus.nope")
    assert not faults.enabled()
    faults.set_plan("")  # armed, no rules: sites get hooks
    bus = MemoryBus()
    assert bus._fault is not None
    bus.push("q", 1)
    assert bus.pop("q") == 1
    faults.set_plan("bus.drop:op=push")  # injure the built bus
    bus.push("q", 2)
    assert bus.pop("q", timeout=0.0) is None
    faults.set_plan(None)  # the same hook goes quiet
    bus.push("q", 3)
    assert bus.pop("q") == 3
    assert MemoryBus()._fault is None


def test_the_plan_arms_from_the_environment(monkeypatch):
    monkeypatch.setenv(faults.PLAN_ENV, "bus.drop:n=2")
    monkeypatch.setenv(faults.SEED_ENV, "5")
    assert faults.enabled()
    faults.reset()
    monkeypatch.setenv(faults.PLAN_ENV, "bus.explode")  # logged, disarmed
    assert not faults.enabled()


def test_the_memory_bus_hot_path_is_unchanged_when_disarmed():
    bus = MemoryBus()
    assert bus._fault is None
    before = _injections()
    for i in range(50):
        bus.push("q", i)
    assert bus.pop_all("q", timeout=0.0) == list(range(50))
    bus.push_many([("q:a", 1), ("q:b", 2)])
    assert bus.pop("q:a") == 1 and bus.pop("q:b") == 2
    bus.set("k", {"v": 1})
    assert bus.get("k") == {"v": 1}
    assert _injections() == before


def _server(name):
    return JsonHttpServer(
        [("GET", "/ping", lambda p, b, c: (200, {"ok": True})),
         ("GET", "/boom", lambda p, b, c: (200, {"ok": True})),
         ("POST", "/predict", lambda p, b, c: (200, {"ok": True}))],
        host="127.0.0.1", name=name).start()


def _status(url, data=None):
    req = urllib.request.Request(url, data=data, method=(
        "POST" if data is not None else "GET"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_the_http_hot_path_is_unchanged_when_disarmed():
    server = _server("t-torch-faults-off")
    try:
        assert server._fault is None
        before = _injections()
        assert _status(f"http://127.0.0.1:{server.port}/ping") == \
            (200, {"ok": True})
        assert _injections() == before
    finally:
        server.stop()


def test_bus_drop_loses_pushes_only():
    faults.set_plan("bus.drop:op=push")
    bus = MemoryBus()
    bus.push("q", 1)
    assert bus.pop("q", timeout=0.0) is None
    faults.set_plan("bus.drop:op=pop")  # a pop ignores a drop verdict
    bus.push("q2", 2)
    assert bus.pop("q2") == 2
    faults.set_plan("bus.drop:op=push_many,kind=query")
    bus.push_many([("q:w1", {"a": 1}), ("q:w2", {"a": 2})])
    assert bus.pop("q:w1", timeout=0.0) is None
    bus.push_many([("r:b1", {"a": 3})])  # a reply kind is not matched
    assert bus.pop("r:b1") == {"a": 3}


def test_bus_delay_sleeps_and_delivers():
    faults.set_plan("bus.delay:ms=60,op=push")
    bus = MemoryBus()
    t0 = time.monotonic()
    bus.push("q", 1)
    assert time.monotonic() - t0 >= 0.05
    assert bus.pop("q") == 1


def test_bus_disconnect_raises_once():
    faults.set_plan("bus.disconnect:n=1")
    bus = MemoryBus()
    with pytest.raises(ConnectionError, match="injected"):
        bus.push("q", 1)
    bus.push("q", 2)
    assert bus.pop("q") == 2


def test_injections_are_counted_by_site_and_kind():
    faults.set_plan("bus.drop:op=push")
    bus = MemoryBus()
    before = _injections("bus", "drop")
    for i in range(3):
        bus.push("q", i)
    assert _injections("bus", "drop") - before == 3
    # A plan parsed and never fired leaves the registry alone.
    plan = faults.FaultPlan.parse("worker.crash:n=99")
    assert plan._counter is None and not plan._counter_known


def test_http_error_answers_before_dispatch_once():
    faults.set_plan("http.error:n=1,code=503")
    server = _server("t-torch-faults-err")
    try:
        url = f"http://127.0.0.1:{server.port}/ping"
        status, body = _status(url)
        assert status == 503 and "injected" in body["error"]
        assert _status(url)[0] == 200
    finally:
        server.stop()


def test_http_error_honours_the_route_filter():
    faults.set_plan("http.error:route=/boom,code=500")
    server = _server("t-torch-faults-route")
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert _status(base + "/ping")[0] == 200
        assert _status(base + "/boom")[0] == 500
        assert _status(base + "/predict", b"{}")[0] == 200
    finally:
        server.stop()


def test_http_timeout_stalls_then_serves():
    faults.set_plan("http.timeout:ms=80,n=1")
    server = _server("t-torch-faults-stall")
    try:
        t0 = time.monotonic()
        status, _ = _status(f"http://127.0.0.1:{server.port}/ping")
        assert time.monotonic() - t0 >= 0.06
        assert status == 200
    finally:
        server.stop()


def test_the_tcp_client_s_injected_disconnect_drops_its_socket():
    server = BusServer().start()
    try:
        faults.set_plan("bus.disconnect:n=1,op=push")
        client = BusClient(server.host, server.port)
        assert client.ping()  # the op filter leaves ping alone
        sock = client._local.sock
        assert sock is not None
        with pytest.raises(ConnectionError, match="injected"):
            client.push("q", 1)
        assert getattr(client._local, "sock", None) is None
        client.push("q", 2)  # a fresh socket
        assert client._local.sock is not sock
        assert client.pop("q") == 2
        faults.set_plan("bus.drop:op=push")
        client.push("q", 3)  # dropped before it leaves the client
        faults.set_plan(None)
        assert client.pop("q", timeout=0.0) is None
        client.close()
    finally:
        server.stop()


def test_a_disarmed_tcp_client_has_no_hook():
    server = BusServer().start()
    try:
        client = BusClient(server.host, server.port)
        assert client._fault is None
        client.push("q", np.int64(4).item())
        assert client.pop("q") == 4
        client.close()
    finally:
        server.stop()


def test_node_config_carries_the_plan_as_the_reference():
    for cls in (NodeConfig, RNodeConfig):
        with pytest.raises(ValueError):
            cls(fault_plan="bus.explode").validate()
        cls(fault_plan="bus.delay:ms=5").validate()
    saved = dict(os.environ)
    exported = []
    try:
        for cls in (NodeConfig, RNodeConfig):
            os.environ[faults.PLAN_ENV] = "unset-sentinel"
            os.environ[faults.SEED_ENV] = "unset-sentinel"
            cfg = cls(fault_plan="worker.crash:n=2", fault_seed=9)
            cfg.validate()
            cfg.apply_env()
            exported.append((os.environ[faults.PLAN_ENV],
                             os.environ[faults.SEED_ENV]))
            cls().apply_env()  # an empty plan pops both
            assert faults.PLAN_ENV not in os.environ
            assert faults.SEED_ENV not in os.environ
        NodeConfig(fault_plan="worker.crash:n=2", fault_seed=9).apply_env()
        faults.reset()
        assert faults.enabled()  # armed from the environment
        NodeConfig().apply_env()
        faults.reset()
        assert not faults.enabled()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert exported == [("worker.crash:n=2", "9")] * 2
