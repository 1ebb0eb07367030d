"""Container managers: the contract and the thread runtime.

The port's copy of ``ContainerManager`` and ``ThreadContainerManager``
from ``rafiki_tpu/container/manager.py`` (:24-116). The interface is the
reference's ``create_service``/``destroy_service``/``service_alive``,
so the services manager does not know how a service runs.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Dict, Optional

from .services import SystemContext, build_service


class ContainerManager(abc.ABC):
    # Whether two services this manager launches may co-own a chip
    # (time-sliced tenancy). Only threads of one process can: they share
    # one CUDA context, so their launches interleave on the card.
    supports_chip_sharing = False

    @abc.abstractmethod
    def create_service(self, service_id: str, environ: Dict[str, str]) -> str:
        """Launch a service; returns a runtime container id."""

    @abc.abstractmethod
    def destroy_service(self, container_id: str) -> None:
        pass

    @abc.abstractmethod
    def service_alive(self, container_id: str) -> bool:
        pass


class ThreadContainerManager(ContainerManager):
    """Every service is a thread in this process, on the chip group's
    device its environment names."""

    supports_chip_sharing = True

    def __init__(self, ctx: SystemContext):
        self.ctx = ctx
        self._services: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_service(self, service_id: str, environ: Dict[str, str]) -> str:
        service = build_service(environ, self.ctx)
        service.start()
        with self._lock:
            self._services[service_id] = service
        return service_id

    def destroy_service(self, container_id: str) -> None:
        with self._lock:
            service = self._services.pop(container_id, None)
        if service is not None:
            service.stop()

    def service_alive(self, container_id: str) -> bool:
        with self._lock:
            service = self._services.get(container_id)
        if service is None:
            return False
        running = getattr(service, "running", None)
        if running is None:
            return True
        return bool(running)

    def get(self, container_id: str) -> Optional[Any]:
        with self._lock:
            return self._services.get(container_id)
