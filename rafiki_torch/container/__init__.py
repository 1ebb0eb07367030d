"""Container runtime: how the platform's services run.

The port's copy of ``rafiki_tpu/container``: the ``ContainerManager``
contract and its runtimes (threads of the process that owns the node's
cards, processes of their own, docker containers), and the service
entry: ``build_service`` as a function, ``python -m
rafiki_torch.container.services`` as a process.
"""

from .manager import (ContainerManager, DockerContainerManager,
                      ProcessContainerManager, ThreadContainerManager)
from .services import SystemContext, build_service

__all__ = ["ContainerManager", "ThreadContainerManager",
           "ProcessContainerManager", "DockerContainerManager",
           "SystemContext", "build_service"]
