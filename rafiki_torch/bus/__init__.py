"""Message bus: queues and a key-value registry for the traffic between
the platform's services.

The port's copy of ``rafiki_tpu/bus``, one interface with three
backends on one wire:

- ``MemoryBus``: in-process; every service of one process shares one
  object;
- ``BusClient`` -> ``BusServer``: a TCP broker of the project's own
  (length-prefixed JSON frames, blocking pops on condition variables)
  for services in several processes or on several hosts;
- ``NativeBusServer`` (``bus.native``): the same wire served by a C++
  ``poll()`` loop, built with g++ at first use; ``serve_broker`` picks
  it when a toolchain exists.

Tensors never ride the bus: it carries control-plane JSON and the
base64-framed query payloads.
"""

from .base import BaseBus
from .memory import MemoryBus
from .native import NativeBusServer, serve_broker
from .tcp import BusClient, BusOpError, BusServer

__all__ = ["BaseBus", "MemoryBus", "BusClient", "BusOpError", "BusServer",
           "NativeBusServer", "serve_broker", "connect"]


def connect(uri: str = "") -> BaseBus:
    """Open a bus from a URI: ``""`` and ``"memory://"`` give the
    process-wide ``MemoryBus``; ``"tcp://host:port"`` a client of the
    broker there."""
    if not uri or uri.startswith("memory://"):
        return MemoryBus.shared()
    if uri.startswith("tcp://"):
        host, _, port = uri[len("tcp://"):].partition(":")
        return BusClient(host or "127.0.0.1", int(port or 6380))
    raise ValueError(f"unsupported bus uri: {uri!r}")
