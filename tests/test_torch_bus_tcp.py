"""The port's TCP and native brokers held against the reference's.

- The bus script of ``test_torch_bus_cache.py`` over the port's
  ``BusClient`` -> ``BusServer`` sees what the reference's ``MemoryBus``
  sees.
- The wire is one: the port's client works against the reference's
  broker and the reference's client against the port's, and through a
  recording proxy the frames each client sends, and each broker
  answers, are byte for byte the other package's.
- The reference's TCP cases (``tests/test_bus.py``) and native cases
  (``tests/test_native_bus.py``) run as one test parametrised over the
  port's two brokers (the native one built with g++ at first use).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from rafiki_torch.bus import BusClient, BusServer, MemoryBus, connect
from rafiki_torch.bus.native import NativeBusServer
from rafiki_torch.cache import Cache
from rafiki_tpu.bus import BusClient as RefClient
from rafiki_tpu.bus import BusServer as RefServer
from rafiki_tpu.bus import MemoryBus as RefMemoryBus
from test_torch_bus_cache import _bus_script


def test_bus_script_over_tcp_answers_as_the_reference():
    server = BusServer().start()
    try:
        client = BusClient(server.host, server.port)
        assert _bus_script(client) == _bus_script(RefMemoryBus())
        client.close()
    finally:
        server.stop()


class _Proxy:
    """Forwards one TCP connection to ``target`` and records the bytes
    of each direction."""

    def __init__(self, target_port: int):
        self.sent = bytearray()      # client -> broker
        self.answered = bytearray()  # broker -> client
        self._listen = socket.socket()
        self._listen.bind(("127.0.0.1", 0))
        self._listen.listen(1)
        self.port = self._listen.getsockname()[1]
        self._target = target_port
        self._threads = []
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept(self):
        conn, _ = self._listen.accept()
        up = socket.create_connection(("127.0.0.1", self._target))
        for src, dst, buf in ((conn, up, self.sent),
                              (up, conn, self.answered)):
            t = threading.Thread(target=self._pump, args=(src, dst, buf),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _pump(src, dst, buf):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                buf.extend(data)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self._listen.close()
        for t in self._threads:
            t.join(timeout=5)


def _recorded(client_cls, server_cls):
    server = server_cls().start()
    proxy = _Proxy(server.port)
    try:
        client = client_cls("127.0.0.1", proxy.port)
        seen = _bus_script(client)
        client.close()
    finally:
        server.stop()
        proxy.close()
    return seen, bytes(proxy.sent), bytes(proxy.answered)


def test_the_wire_is_shared_byte_for_byte():
    ref = _recorded(RefClient, RefServer)
    port = _recorded(BusClient, BusServer)
    port_to_ref = _recorded(BusClient, RefServer)
    ref_to_port = _recorded(RefClient, BusServer)
    assert ref[0] == port[0] == port_to_ref[0] == ref_to_port[0]
    # The clients send the same frames, the brokers answer the same.
    assert port[1] == ref[1] == port_to_ref[1] == ref_to_port[1]
    assert port[2] == ref[2] == port_to_ref[2] == ref_to_port[2]
    assert len(ref[1]) > 100 and len(ref[2]) > 100


def _start(kind):
    return (NativeBusServer if kind == "native" else BusServer)().start()


# --- The reference's TCP cases (tests/test_bus.py) ---

def _concurrent_clients(kind):
    server = _start(kind)
    try:
        clients = [BusClient(server.host, server.port) for _ in range(4)]

        def producer(c, k):
            for i in range(25):
                c.push("load", k * 100 + i)

        threads = [threading.Thread(target=producer, args=(c, k))
                   for k, c in enumerate(clients)]
        [t.start() for t in threads]
        [t.join(timeout=30) for t in threads]
        assert not any(t.is_alive() for t in threads)
        drained = clients[0].pop_all("load", timeout=1.0)
        assert sorted(drained) == sorted(k * 100 + i for k in range(4)
                                         for i in range(25))
        [c.close() for c in clients]
    finally:
        server.stop()


def _connect_uri(kind):
    server = _start(kind)
    try:
        c = connect(server.uri)
        assert isinstance(c, BusClient)
        c.push("u", 1)
        assert c.pop("u") == 1
        c.close()
    finally:
        server.stop()
    assert isinstance(connect(""), MemoryBus)
    assert connect("memory://") is connect("memory://")
    MemoryBus.reset_shared()


def _error_response_keeps_connection(kind):
    server = _start(kind)
    try:
        c = BusClient(server.host, server.port)
        with pytest.raises(RuntimeError, match="unknown op"):
            c._call({"op": "nope"})
        assert c.ping()  # the connection is still usable
        c.close()
    finally:
        server.stop()


def _cache_scatter_gather(kind):
    """The cache's scatter, reply and gather over the broker; a gather
    of three workers of whom one answers returns that one at its
    timeout."""
    from rafiki_torch.cache import encode_payload

    server = _start(kind)
    try:
        cache = Cache(BusClient(server.host, server.port))
        cache.register_worker("job", "w0")
        cache.register_worker("job", "w1")
        assert cache.running_workers("job") == ["w0", "w1"]
        img = np.ones((4, 4, 1), np.uint8)
        bid = cache.send_query_shards(
            [("w0", 0, 1, "s0"), ("w1", 0, 1, "s1")],
            [encode_payload(img)])
        for w in ["w0", "w1"]:
            items = cache.pop_queries(w, timeout=1.0)
            assert len(items) == 1
            np.testing.assert_array_equal(items[0]["queries"][0], img)
            cache.send_prediction_batch(bid, w, [[0.25, 0.75]],
                                        shard=items[0]["shard"])
        got = cache.gather_prediction_batches(bid, n_workers=2,
                                              timeout=2.0)
        assert sorted(p["worker_id"] for p in got) == ["w0", "w1"]
        assert [list(p["predictions"][0]) for p in got] == \
            [[0.25, 0.75]] * 2
        bid = cache.send_query_shards([("w0", 0, 1, "s")],
                                      [encode_payload([1, 2, 3])])
        cache.pop_queries("w0", timeout=1.0)
        cache.send_prediction_batch(bid, "w0", ["ok"], shard="s")
        t0 = time.monotonic()
        assert len(cache.gather_prediction_batches(bid, n_workers=3,
                                                   timeout=0.3)) == 1
        assert time.monotonic() - t0 < 2.0
        cache.unregister_worker("job", "w0")
        assert cache.running_workers("job") == ["w1"]
    finally:
        server.stop()


# --- The reference's native cases (tests/test_native_bus.py) ---

def _concurrent_hammer(kind):
    server = _start(kind)
    try:
        payload = {"blob": "é" * 2000, "n": 1.5,
                   "nested": [1, [2, {"x": None}]]}
        errors = []

        def pingpong(tid):
            try:
                c = BusClient(server.host, server.port)
                for i in range(100):
                    c.push(f"h{tid}", {"i": i, **payload})
                    got = c.pop(f"h{tid}", timeout=5.0)
                    assert got["i"] == i and got["blob"] == payload["blob"]
                c.close()
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=pingpong, args=(t,))
                   for t in range(8)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        # A wake-up across clients through the broker.
        c1 = BusClient(server.host, server.port)
        c2 = BusClient(server.host, server.port)
        got = []
        t = threading.Thread(
            target=lambda: got.append(c1.pop("wake", timeout=10.0)))
        t.start()
        c2.push("wake", {"v": 42})
        t.join(timeout=10)
        assert got == [{"v": 42}]
        c1.close()
        c2.close()
    finally:
        server.stop()


def _parked_pop_not_misdelivered(kind):
    """A client that dies with a parked pop never has its response land
    on a new connection that reuses the file descriptor."""
    server = _start(kind)
    hdr = struct.Struct(">I")

    def frame(obj):
        d = json.dumps(obj).encode()
        return hdr.pack(len(d)) + d

    try:
        c1 = socket.create_connection((server.host, server.port))
        c1.sendall(frame({"op": "pop", "queue": "q", "timeout": 30}))
        time.sleep(0.2)
        c1.close()
        time.sleep(0.2)
        c2 = BusClient(server.host, server.port)
        assert c2.ping()
        c2.push("q", {"v": 1})
        assert c2.ping()  # the responses stay in lockstep
        assert c2.pop("q", timeout=1.0) == {"v": 1}
        c2.close()
    finally:
        server.stop()


def _push_many_one_round_trip(kind):
    """A scatter to several queues is one ``push_many`` op (one
    observation of ``rafiki_tpu_bus_op_seconds``), and it wakes a parked
    pop as a push does."""
    from rafiki_torch.observe import metrics

    server = _start(kind)
    try:
        c = BusClient(server.host, server.port)
        hist = metrics.registry().histogram("rafiki_tpu_bus_op_seconds")
        many0 = hist.count(backend="tcp", op="push_many", kind="query")
        push0 = hist.count(backend="tcp", op="push", kind="query")
        items = [(f"q:w{i}", {"batch_id": "b1", "queries": [i],
                              "shard": f"s{i}"}) for i in range(5)]
        c.push_many(items)
        assert not getattr(c, "_no_push_many", False)
        assert hist.count(backend="tcp", op="push_many",
                          kind="query") == many0 + 1
        assert hist.count(backend="tcp", op="push", kind="query") == push0
        for i in range(5):
            assert c.pop(f"q:w{i}", timeout=2.0) == {
                "batch_id": "b1", "queries": [i], "shard": f"s{i}"}
        got = []
        t = threading.Thread(
            target=lambda: got.append(c.pop("q:park", timeout=10.0)))
        t.start()
        c2 = BusClient(server.host, server.port)
        c2.push_many([("q:park", {"v": 7})])
        t.join(timeout=10)
        assert got == [{"v": 7}]
        c.close()
        c2.close()
    finally:
        server.stop()


def _sharded_scatter_one_push_many(kind):
    """A replica-sharded ``Predictor`` scatter over the broker is one
    query-kind ``push_many``."""
    from rafiki_torch.observe import metrics
    from rafiki_torch.predictor.predictor import Predictor

    server = _start(kind)
    stop = threading.Event()
    threads = []
    try:
        cache = Cache(BusClient(server.host, server.port))
        cache.register_worker("job", "wA1", info={"trial_id": "tA"})
        cache.register_worker("job", "wA2", info={"trial_id": "tA"})

        def worker_loop(wid):
            c = Cache(BusClient(server.host, server.port))
            while not stop.is_set():
                for it in c.pop_queries(wid, timeout=0.1):
                    c.send_prediction_batch(
                        it["batch_id"], wid,
                        [q * 2 for q in it["queries"]],
                        shard=it.get("shard"))

        threads += [threading.Thread(target=worker_loop, args=(w,),
                                     daemon=True) for w in ("wA1", "wA2")]
        [t.start() for t in threads]
        hist = metrics.registry().histogram("rafiki_tpu_bus_op_seconds")
        many0 = hist.count(backend="tcp", op="push_many", kind="query")
        push0 = hist.count(backend="tcp", op="push", kind="query")
        p = Predictor("job", BusClient(server.host, server.port),
                      gather_timeout=10.0, worker_wait_timeout=10.0)
        assert p.predict(list(range(8))) == [float(q * 2)
                                             for q in range(8)]
        assert hist.count(backend="tcp", op="push_many",
                          kind="query") == many0 + 1
        assert hist.count(backend="tcp", op="push", kind="query") == push0
        p.close()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        server.stop()
    assert not any(t.is_alive() for t in threads)


def _push_many_unknown_op_fallback(kind, monkeypatch):
    """Against a broker without ``push_many`` (the Python broker made
    old) the client falls back to pushes for good."""
    from rafiki_torch.bus.tcp import _Handler

    real_dispatch = _Handler._dispatch

    def old_dispatch(bus, req):
        if req.get("op") == "push_many":
            raise ValueError(f"unknown op: {req.get('op')!r}")
        return real_dispatch(bus, req)

    monkeypatch.setattr(_Handler, "_dispatch", staticmethod(old_dispatch))
    server = _start(kind)
    try:
        c = BusClient(server.host, server.port)
        c.push_many([("q:a", 1), ("q:b", 2)])
        assert getattr(c, "_no_push_many", False) is True
        assert c.pop("q:a", timeout=1.0) == 1
        assert c.pop("q:b", timeout=1.0) == 2
        c.push_many([("q:a", 3)])
        assert c.pop("q:a", timeout=1.0) == 3
        c.close()
    finally:
        server.stop()


def _serve_broker_selects(kind):
    from rafiki_torch.bus import serve_broker

    server = serve_broker(native=(kind == "native"))
    try:
        assert isinstance(server, NativeBusServer if kind == "native"
                          else BusServer)
        assert BusClient(server.host, server.port).ping()
    finally:
        server.stop()


def _crash_is_not_a_clean_shutdown(kind):
    """A native broker child that dies on its own raises from
    ``serve_forever``; ``stop`` stays clean. The Python broker's
    counterpart: ``stop`` severs live connections at once, as a dead
    broker process would."""
    if kind == "native":
        server = NativeBusServer().start()
        server._proc.kill()
        with pytest.raises(RuntimeError, match="exited with status"):
            server.serve_forever()
        server.stop()  # idempotent after the crash
        NativeBusServer().start().stop()
        return
    server = BusServer().start()
    c = BusClient(server.host, server.port, retry_total_s=0.0)
    assert c.ping()
    got = []
    t = threading.Thread(target=lambda: got.append(
        _raises(lambda: c.pop("never", timeout=30.0))))
    t.start()
    time.sleep(0.2)
    server.stop()
    t.join(timeout=10)
    assert got == [True]


def _raises(fn):
    try:
        fn()
    except (ConnectionError, OSError):
        return True
    return False


CASES = {"concurrent_clients": _concurrent_clients,
         "connect_uri": _connect_uri,
         "error_keeps_connection": _error_response_keeps_connection,
         "cache_scatter_gather": _cache_scatter_gather,
         "concurrent_hammer": _concurrent_hammer,
         "parked_pop_fd_reuse": _parked_pop_not_misdelivered,
         "push_many_one_round_trip": _push_many_one_round_trip,
         "sharded_scatter": _sharded_scatter_one_push_many,
         "serve_broker_selects": _serve_broker_selects,
         "crash_or_stop": _crash_is_not_a_clean_shutdown}

# Every case on both brokers but two. The fallback needs a broker
# without push_many, which is the Python one made old. The parked pop's
# guarantee is the native broker's: the Python broker's handler thread,
# parked in the queue's pop, takes the item whether or not its client
# is still there, as the reference's does.
PAIRS = ([(case, kind) for case in sorted(CASES)
          for kind in ("python", "native")
          if (case, kind) != ("parked_pop_fd_reuse", "python")]
         + [("push_many_fallback", "python")])


@pytest.mark.parametrize("case,kind", PAIRS)
def test_broker_case(case, kind, monkeypatch):
    if case == "push_many_fallback":
        _push_many_unknown_op_fallback(kind, monkeypatch)
    else:
        CASES[case](kind)
