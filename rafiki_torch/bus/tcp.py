"""TCP broker backend: a Redis-shaped queue server of the project's own.

The port's copy of ``rafiki_tpu/bus/tcp.py``, on the same wire, so
either package's client talks to either package's broker. Wire format:
a 4-byte big-endian length and a UTF-8 JSON frame, both directions.
Request: ``{"op": ..., ...}``; response: ``{"ok": true, "value": ...}``
or ``{"ok": false, "error": ...}``. The server wraps a ``MemoryBus``, so
both backends share queue semantics exactly; blocking pops hold only
the handler's thread (``ThreadingTCPServer``, one thread a connection).

The client keeps one socket per calling thread (``threading.local``) so
a blocked ``pop`` in one thread never serialises another thread's
traffic. After a transport failure it reconnects on a bounded backoff
(``RAFIKI_TPU_BUS_RETRY_BASE_S`` and ``RAFIKI_TPU_BUS_RETRY_TOTAL_S``),
retrying what the broker cannot have executed and the idempotent ops.
The broker relays frames addressed to another node's broker
(``add_peer``), one hop at most.

The reference's fault-injection sites (its ``bus`` site hook) are left
out: the port has no fault plane yet (ROADMAP, queue 1).
"""

from __future__ import annotations

import json
import os
import random
import select
import socket
import socketserver
import struct
import threading
from typing import Any, List, Optional

import time

from .base import (BaseBus, bus_op_histogram, bus_reconnect_counter,
                   bus_relay_counter, queue_kind)
from .memory import MemoryBus

_HDR = struct.Struct(">I")
_MAX_FRAME = 256 * 1024 * 1024

#: Per-peer retry budget for broker→broker relay forwards, seconds. A
#: dead peer must fail the forward FAST (the handler thread holds the
#: sender's request open) and degrade to local execution — never the
#: client-side 15 s default.
_PEER_RETRY_TOTAL_S = 2.0

#: Ops safe to retry even after their frame was FULLY sent (the broker
#: may have executed them): pure reads, and writes whose replay is a
#: no-op (set = same value, del/qdel = already gone). ``push``/``pop``
#: families are NOT here — replaying a sent push duplicates a frame,
#: replaying a sent pop loses the popped item.
_IDEMPOTENT_OPS = frozenset(
    {"get", "keys", "qlen", "ping", "set", "del", "qdel"})

#: Ceiling on one backoff sleep (the exponential is bounded twice: per
#: sleep here, and in total by the retry budget).
_RETRY_MAX_SLEEP = 2.0


def _peer_closed(sock: socket.socket) -> bool:
    """Whether an IDLE cached socket has a close (or stray bytes)
    queued. The protocol is strict request/response, so between ops the
    peer owes us nothing: a socket polling READABLE means EOF (broker
    died / restarted) or framing skew — either way it must not carry
    the next frame. Zero-timeout poll, never a recv: on a socket
    with a Python-level timeout, recv — even MSG_DONTWAIT — parks in
    the interpreter's readiness wait first. ``poll`` rather than
    ``select``: select raises ValueError on fds >= FD_SETSIZE, and
    treating that as "closed" would re-dial the broker on EVERY op in
    a high-fd process."""
    try:
        p = select.poll()
        p.register(sock, select.POLLIN)
        return bool(p.poll(0))
    except (OSError, ValueError):
        return True


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("bus peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Any:
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if length > _MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return json.loads(_recv_exact(sock, length))


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        bus: MemoryBus = self.server.bus  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Track the live connection so a server stop() can sever it:
        # without this, handler threads outlive shutdown() and keep
        # serving the ORPHANED in-memory bus — clients would never
        # notice the broker "died" and never migrate to its successor
        # (a process kill closes these sockets; an in-process stop
        # must behave the same).
        conns = self.server.conns  # type: ignore[attr-defined]
        with self.server.conns_lock:  # type: ignore[attr-defined]
            conns.add(sock)
        try:
            while True:
                try:
                    req = _recv_frame(sock)
                except (ConnectionError, OSError, ValueError):
                    return
                try:
                    if req.get("op") == "relay":
                        value = self._relay(req)
                    else:
                        value = self._dispatch(bus, req)
                    resp = {"ok": True, "value": value}
                except Exception as e:  # report, keep connection alive
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                try:
                    _send_frame(sock, resp)
                except (ConnectionError, OSError):
                    return
        finally:
            with self.server.conns_lock:  # type: ignore[attr-defined]
                conns.discard(sock)

    @staticmethod
    def _dispatch(bus: MemoryBus, req: dict) -> Any:
        op = req.get("op")
        if op == "push":
            bus.push(req["queue"], req["value"])
            return None
        if op == "push_many":
            bus.push_many([(i["queue"], i["value"])
                           for i in req["items"]])
            return None
        if op == "pop":
            return bus.pop(req["queue"], float(req.get("timeout", 0.0)))
        if op == "pop_all":
            return bus.pop_all(req["queue"], int(req.get("max_items", 0)),
                               float(req.get("timeout", 0.0)))
        if op == "qlen":
            return bus.queue_len(req["queue"])
        if op == "qdel":
            bus.delete_queue(req["queue"])
            return None
        if op == "set":
            bus.set(req["key"], req["value"])
            return None
        if op == "get":
            return bus.get(req["key"])
        if op == "del":
            bus.delete(req["key"])
            return None
        if op == "keys":
            return bus.keys(req.get("prefix", ""))
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op: {op!r}")

    def _relay(self, req: dict) -> Any:
        """Inter-node relay (docs/cluster.md): execute ``req["req"]``
        on the broker owning node ``req["node"]``'s queues. A frame for
        a remote node pays exactly ONE inter-node hop: the forwarded
        frame carries ``hop=1`` and the receiving broker executes it
        locally no matter what (never re-forwards). An unknown or
        unreachable peer degrades to executing the inner op against
        THIS broker — the pre-cluster single-broker behavior — so a
        dead node never wedges the sender (the serving gather timeout
        and resubmit own delivery from there)."""
        srv = self.server  # type: ignore[assignment]
        target = req.get("node")
        inner = req.get("req") or {}
        ctr = srv.relay_counter  # type: ignore[attr-defined]
        if req.get("hop") or target == srv.node_id:  # type: ignore[attr-defined]
            if ctr is not None:
                ctr.inc(direction="in")
            return self._dispatch(srv.bus, inner)  # type: ignore[attr-defined]
        client = srv.peer_client(target)  # type: ignore[attr-defined]
        if client is not None:
            try:
                value = client._call({"op": "relay", "node": target,
                                      "hop": 1, "req": inner})
                if ctr is not None:
                    ctr.inc(direction="out")
                return value
            except (ConnectionError, OSError, BusOpError):
                pass  # dead/old peer: fall through to local execution
        if ctr is not None:
            ctr.inc(direction="fallback")
        return self._dispatch(srv.bus, inner)  # type: ignore[attr-defined]


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # Relay topology (empty/None on a single-node broker): set up by
    # ``BusServer`` at construction / ``add_peer``.
    node_id = ""
    relay_counter = None

    def peer_client(self, node: Any) -> Optional["BusClient"]:
        """Cached broker→broker client for a registered peer node, or
        None when the node is unknown (never been ``add_peer``-ed)."""
        if not isinstance(node, str):
            return None
        with self.peers_lock:  # type: ignore[attr-defined]
            addr = self.peers.get(node)  # type: ignore[attr-defined]
            if addr is None:
                return None
            cli = self.peer_clients.get(node)  # type: ignore[attr-defined]
            if cli is None:
                # Tight retry budget: the forward happens inside a
                # handler thread holding the SENDER's request open.
                cli = BusClient(addr[0], addr[1],
                                retry_total_s=_PEER_RETRY_TOTAL_S)
                self.peer_clients[node] = cli  # type: ignore[attr-defined]
            return cli


class BusServer:
    """The broker process side. ``port=0`` picks a free port.

    ``node_id`` names the cluster node this broker serves queues for
    (docs/cluster.md). Default "" keeps the single-node broker: no
    relay topology, and the relay counter series is never registered.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 node_id: str = ""):
        self._server = _Server((host, port), _Handler)
        self._server.bus = MemoryBus()  # type: ignore[attr-defined]
        self._server.conns = set()  # type: ignore[attr-defined]
        self._server.conns_lock = (  # type: ignore[attr-defined]
            threading.Lock())
        self._server.node_id = node_id  # type: ignore[attr-defined]
        self._server.peers = {}  # type: ignore[attr-defined]
        self._server.peer_clients = {}  # type: ignore[attr-defined]
        self._server.peers_lock = (  # type: ignore[attr-defined]
            threading.Lock())
        # The relay series is born ONLY on a cluster-configured broker
        # (named node now, or first add_peer later): a default broker
        # keeps the zero-series contract for fabric-off deployments.
        if node_id:
            self._server.relay_counter = (  # type: ignore[attr-defined]
                bus_relay_counter())
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="bus-server", daemon=True)

    @property
    def uri(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    @property
    def node_id(self) -> str:
        return self._server.node_id  # type: ignore[attr-defined]

    def add_peer(self, node_id: str, uri: str) -> None:
        """Register a peer node's broker as the relay target for frames
        addressed to ``node_id`` (``uri`` = ``tcp://host:port``).
        Re-registering replaces the address (a respawned peer broker
        moves ports) and drops the cached client to it."""
        if not uri.startswith("tcp://"):
            raise ValueError(f"unsupported peer uri: {uri!r}")
        host, _, port = uri[len("tcp://"):].partition(":")
        srv = self._server
        with srv.peers_lock:  # type: ignore[attr-defined]
            srv.peers[node_id] = (  # type: ignore[attr-defined]
                host or "127.0.0.1", int(port or 6380))
            stale = srv.peer_clients.pop(  # type: ignore[attr-defined]
                node_id, None)
        if stale is not None:
            stale.close()
        if srv.relay_counter is None:  # type: ignore[attr-defined]
            srv.relay_counter = (  # type: ignore[attr-defined]
                bus_relay_counter())

    def start(self) -> "BusServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # Sever live connections so stop() is indistinguishable from a
        # broker-process death: blocked client ops fail NOW instead of
        # quietly continuing against the orphaned in-memory state.
        with self._server.conns_lock:  # type: ignore[attr-defined]
            conns = list(self._server.conns)  # type: ignore[attr-defined]
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        """Run in the foreground (broker-process entrypoint)."""
        self._server.serve_forever()


class BusOpError(RuntimeError):
    """The broker itself REPORTED an op failure (malformed request,
    unknown op — protocol/version skew), as opposed to a transport
    failure (ConnectionError/OSError: broker dead or restarting).
    Subclasses RuntimeError so pre-existing broad catches still see it;
    callers that must react differently — a transport failure heals
    when the broker returns, a reported error usually will not — can
    now tell them apart (worker/inference.py serve loop)."""


class BusClient(BaseBus):
    def __init__(self, host: str, port: int, timeout: float = 300.0,
                 retry_base_s: Optional[float] = None,
                 retry_total_s: Optional[float] = None):
        self.host, self.port = host, port
        # Socket-level timeout; must exceed any blocking-pop timeout so the
        # server, not the transport, decides when a pop gives up.
        self._sock_timeout = timeout
        self._local = threading.local()
        # Reconnection policy (docs/robustness.md): after a transport
        # failure, frame-UNSENT ops and idempotent reads retry on a
        # bounded exponential backoff with jitter until the total
        # budget lapses — a broker restart heals instead of failing
        # every in-flight op. Knob precedence matches NodeConfig:
        # constructor arg > RAFIKI_TPU_BUS_RETRY_* env > default.
        from ..config import NodeConfig

        if retry_base_s is None:
            retry_base_s = float(os.environ.get(
                NodeConfig.env_name("bus_retry_base_s"), "0.05"))
        if retry_total_s is None:
            retry_total_s = float(os.environ.get(
                NodeConfig.env_name("bus_retry_total_s"), "15.0"))
        self._retry_base = max(1e-3, retry_base_s)
        self._retry_total = max(0.0, retry_total_s)
        # One timing site (_call) covers every op against EITHER broker
        # (Python BusServer or the C++ native one — the client is the
        # only Python-side hop the native path has). None when
        # RAFIKI_TPU_METRICS=0, decided at construction.
        self._hist = bus_op_histogram()
        self._m_reconnects = bus_reconnect_counter()

    def _sock(self, timeout_cap: Optional[float] = None,
              ) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is not None and _peer_closed(sock):
            # A broker that died while this socket sat idle leaves a
            # FIN/RST already queued: catching it HERE turns the next
            # op into the safe frame-UNSENT case. Without the check the
            # first post-restart send "succeeds" into the kernel buffer
            # and the failure surfaces at recv — frame-SENT, where a
            # non-idempotent op must propagate rather than retry.
            self._drop()
            sock = None
        if sock is None:
            timeout = self._sock_timeout
            if timeout_cap is not None:
                timeout = min(timeout, max(timeout_cap, 1e-3))
            sock = socket.create_connection((self.host, self.port),
                                            timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
        return sock

    def _call(self, req: dict) -> Any:
        # push_many carries its queues inside "items", relay inside its
        # "req" envelope; label by the first one so the serving scatter
        # records kind="query" exactly as the memory backend does.
        queue = req.get("queue")
        if queue is None and req.get("items"):
            queue = req["items"][0].get("queue")
        if queue is None and req.get("op") == "relay":
            inner = req.get("req") or {}
            queue = inner.get("queue")
            if queue is None and inner.get("items"):
                queue = inner["items"][0].get("queue")
        if self._hist is None:
            return self._call_inner(req)
        t0 = time.monotonic()
        try:
            return self._call_inner(req)
        finally:
            self._hist.observe(
                time.monotonic() - t0, backend="tcp",
                op=str(req.get("op")), kind=queue_kind(queue))

    def _call_inner(self, req: dict) -> Any:
        """One op, with bounded-backoff reconnection.

        The retry boundary is FRAME-SENT vs FRAME-UNSENT: a failure
        before ``_send_frame`` returned means the broker never saw a
        complete frame (length-prefixed framing — a partial frame never
        dispatches), so resending is always safe. Once the frame is
        fully sent the op may have executed, so only ``_IDEMPOTENT_OPS``
        may retry past that point: replaying a sent ``push`` would
        duplicate a frame (double feedback), replaying a sent ``pop``
        would lose the popped item — those propagate instead.

        Retry schedule: the first reconnect is immediate (the common
        stale-cached-socket case — the broker is fine, our idle socket
        was closed), then exponential backoff with jitter from
        ``bus_retry_base_s``, each sleep capped, the whole affair
        bounded by ``bus_retry_total_s`` (0 = legacy single resend).
        """
        op = str(req.get("op"))
        retry_sent = op in _IDEMPOTENT_OPS
        deadline: Optional[float] = None
        attempt = 0
        while True:
            sent = False
            try:
                # Reconnects under a nonzero budget bound their connect
                # AND recv by what's left of it: a blackholed broker
                # (SYNs dropped, no RST) must not park a 15 s-budget op
                # for the full 300 s socket timeout per attempt. Budget
                # 0 keeps the legacy uncapped single resend.
                cap = None
                if deadline is not None and self._retry_total > 0:
                    cap = deadline - time.monotonic()
                sock = self._sock(timeout_cap=cap)
                _send_frame(sock, req)
                sent = True
                if cap is not None and not retry_sent:
                    # The frame is SENT on a non-idempotent op: past
                    # this point a failure propagates (never retried),
                    # so the budget no longer applies — restore the
                    # full window or a blocking pop legitimately held
                    # by the broker longer than the remaining budget
                    # would spuriously time out and lose its reply.
                    sock.settimeout(self._sock_timeout)
                resp = _recv_frame(sock)
            except (ConnectionError, OSError):
                self._drop()
                if sent and not retry_sent:
                    raise
                attempt += 1
                if deadline is None:
                    deadline = time.monotonic() + self._retry_total
                if self._m_reconnects is not None:
                    self._m_reconnects.inc()
                if attempt == 1:
                    continue  # stale socket: one immediate reconnect
                delay = min(self._retry_base * (2 ** (attempt - 2))
                            * (0.5 + random.random()),  # jitter [0.5, 1.5)
                            _RETRY_MAX_SLEEP)
                if time.monotonic() + delay >= deadline:
                    raise
                time.sleep(delay)
                continue
            if cap is not None:
                # The retry succeeded on a budget-capped socket; restore
                # the full timeout so the cached socket keeps serving
                # long blocking pops.
                sock.settimeout(self._sock_timeout)
            if not resp.get("ok"):
                raise BusOpError(f"bus error: {resp.get('error')}")
            return resp.get("value")

    def _drop(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._local.sock = None

    # --- BaseBus ---

    def push(self, queue: str, value: Any) -> None:
        self._call({"op": "push", "queue": queue, "value": value})

    def push_many(self, items) -> None:
        """One round-trip for a multi-queue scatter. An older broker
        (the cached native binary predating the op) reports an unknown
        op; that negotiates a permanent per-item fallback rather than
        failing the scatter."""
        items = list(items)
        if not items:
            return
        if getattr(self, "_no_push_many", False):
            for queue, value in items:
                self.push(queue, value)
            return
        try:
            self._call({"op": "push_many",
                        "items": [{"queue": q, "value": v}
                                  for q, v in items]})
        except BusOpError as e:
            # Fall back ONLY on "unknown op" (nothing executed). Any
            # other reported failure may have pushed a prefix of the
            # items; re-pushing would duplicate frames.
            if "unknown op" not in str(e):
                raise
            self._no_push_many = True
            for queue, value in items:
                self.push(queue, value)

    def relay_push(self, node: str, queue: str, value: Any) -> None:
        """Push destined for ``node``'s broker, via OUR broker's
        inter-node relay: one client round-trip, at most one inter-node
        hop. A broker without the relay op (the cached native binary
        predating it) negotiates a permanent fallback to plain local
        pushes — the pre-cluster single-broker behavior."""
        if not node or getattr(self, "_no_relay", False):
            self.push(queue, value)
            return
        try:
            self._call({"op": "relay", "node": node,
                        "req": {"op": "push", "queue": queue,
                                "value": value}})
        except BusOpError as e:
            if "unknown op" not in str(e):
                raise
            self._no_relay = True
            self.push(queue, value)

    def relay_push_many(self, node: str, items) -> None:
        """Batch form of ``relay_push`` (the scatter path): the whole
        remote portion of a shard fan-out is one frame to our broker
        and ONE forwarded frame to the peer broker."""
        items = list(items)
        if not items:
            return
        if not node or getattr(self, "_no_relay", False):
            self.push_many(items)
            return
        try:
            self._call({"op": "relay", "node": node,
                        "req": {"op": "push_many",
                                "items": [{"queue": q, "value": v}
                                          for q, v in items]}})
        except BusOpError as e:
            if "unknown op" not in str(e):
                raise
            self._no_relay = True
            self.push_many(items)

    def pop(self, queue: str, timeout: float = 0.0) -> Optional[Any]:
        return self._call({"op": "pop", "queue": queue, "timeout": timeout})

    def pop_all(self, queue: str, max_items: int = 0,
                timeout: float = 0.0) -> List[Any]:
        return self._call({"op": "pop_all", "queue": queue,
                           "max_items": max_items, "timeout": timeout})

    def queue_len(self, queue: str) -> int:
        return int(self._call({"op": "qlen", "queue": queue}))

    def delete_queue(self, queue: str) -> None:
        self._call({"op": "qdel", "queue": queue})

    def set(self, key: str, value: Any) -> None:
        self._call({"op": "set", "key": key, "value": value})

    def get(self, key: str) -> Optional[Any]:
        return self._call({"op": "get", "key": key})

    def delete(self, key: str) -> None:
        self._call({"op": "del", "key": key})

    def keys(self, prefix: str = "") -> List[str]:
        return list(self._call({"op": "keys", "prefix": prefix}))

    def ping(self) -> bool:
        try:
            return self._call({"op": "ping"}) == "pong"
        except (RuntimeError, ConnectionError, OSError):
            return False

    def close(self) -> None:
        self._drop()
