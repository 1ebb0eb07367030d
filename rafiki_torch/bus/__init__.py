"""Message bus: queues and a key-value registry for the traffic between
the platform's services.

The port's copy of ``rafiki_tpu/bus``: the ``BaseBus`` interface and its
in-process backend ``MemoryBus``, on which every service of one
``LocalPlatform`` shares one object. The reference's TCP broker and its
native (C++) broker carry the bus between processes and hosts; they
come with the process manager (ROADMAP, queue 1).
"""

from .base import BaseBus
from .memory import MemoryBus

__all__ = ["BaseBus", "MemoryBus", "connect"]


def connect(uri: str = "") -> BaseBus:
    """Open a bus from a URI: ``""`` and ``"memory://"`` give the
    process-wide ``MemoryBus``. A ``tcp://`` URI raises: the port has no
    broker yet."""
    if not uri or uri.startswith("memory://"):
        return MemoryBus.shared()
    if uri.startswith("tcp://"):
        raise NotImplementedError(
            f"bus uri {uri!r}: the TCP and native brokers are not ported "
            "yet (ROADMAP.md, queue 1); use the in-process bus ('' or "
            "'memory://')")
    raise ValueError(f"unsupported bus uri: {uri!r}")
