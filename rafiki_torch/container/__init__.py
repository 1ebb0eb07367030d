"""Container runtime: how the platform's services run.

The port's copy of ``rafiki_tpu/container``: the ``ContainerManager``
contract and its thread runtime, in which every service is a thread of
the process that owns the node's cards, and ``build_service``, the
service entry point as a function. The reference's process and docker
managers start ``python -m rafiki_tpu.container.services``; the port's
own process entry waits for them (ROADMAP, queue 1).
"""

from .manager import ContainerManager, ThreadContainerManager
from .services import SystemContext, build_service

__all__ = ["ContainerManager", "SystemContext", "ThreadContainerManager",
           "build_service"]
