"""Container managers: the contract and its three runtimes.

The port's copy of ``rafiki_tpu/container/manager.py``. The interface is
the reference's ``create_service``/``destroy_service``/
``kill_service``/``service_alive``, so the services manager does not
know how a service runs:

- ``ThreadContainerManager``: every service is a thread of this
  process, on the chip group's device its environment names;
- ``ProcessContainerManager``: every service is a process of its own,
  ``python -m rafiki_torch.container.services`` with the service's
  environment (stores, bus, chips and device type among it);
- ``DockerContainerManager``: every service is a container of the node
  image running the same entry, through the docker CLI (an injectable
  ``runner``).

Only threads may share a chip: processes each hold a CUDA context of
their own, so ``supports_chip_sharing`` is off for the other two.
"""

from __future__ import annotations

import abc
import logging
import os
import subprocess
import sys
import threading
from typing import Any, Dict, Optional

from ..constants import EnvVars
from .services import SystemContext, build_service

_log = logging.getLogger(__name__)

#: The module a service process runs.
SERVICE_MODULE = "rafiki_torch.container.services"


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

    def kill_service(self, container_id: str) -> None:
        """A hard kill: the service dies leaving its meta row RUNNING and
        its bus registration stale, what a real node death leaves, so
        the supervise sweep's detection is what recovery runs. For a
        process or a container ``destroy_service`` is hard already (the
        dying process updates no row); threads override this."""
        self.destroy_service(container_id)

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

    def kill_service(self, container_id: str) -> None:
        """A service with ``kill()`` (the inference worker) dies through
        it, its row left RUNNING; a thread cannot be killed, so any
        other service stops gracefully."""
        with self._lock:
            service = self._services.pop(container_id, None)
        if service is None:
            return
        kill = getattr(service, "kill", None)
        if kill is not None:
            kill()
        else:
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


class ProcessContainerManager(ContainerManager):
    """Every service a process of its own: ``python -m
    rafiki_torch.container.services`` with this process's environment
    and the service's. The stores must be files (the environment's URIs
    are opened by a fresh process) and the bus a TCP broker; each
    service process holds its own CUDA context."""

    def __init__(self, python: str = sys.executable):
        self.python = python
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def create_service(self, service_id: str, environ: Dict[str, str]) -> str:
        env = dict(os.environ)
        env.update(environ)
        proc = subprocess.Popen([self.python, "-m", SERVICE_MODULE],
                                env=env)
        with self._lock:
            self._procs[service_id] = proc
        return service_id

    def destroy_service(self, container_id: str) -> None:
        with self._lock:
            proc = self._procs.pop(container_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def service_alive(self, container_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(container_id)
        return proc is not None and proc.poll() is None


class DockerContainerManager(ContainerManager):
    """Every service a container of the node image, through the docker
    CLI: the service's environment injected with ``-e``, the generic
    entry ``python -m rafiki_torch.container.services``, host networking
    by default so the bus and admin ports behave as in the process
    runtime. The chip group rides ``RAFIKI_TPU_CHIPS`` as in the other
    runtimes; a card reaches the container through ``extra_args`` (for
    example ``--gpus all``). The CLI runs through ``runner`` (the tests
    give a fake)."""

    def __init__(self, image: str = "rafiki-tpu", network: str = "host",
                 extra_args: Optional[list] = None,
                 volumes: Optional[list] = None, runner=None):
        self.image = image
        self.network = network
        self.extra_args = list(extra_args or [])
        self.volumes = list(volumes or [])
        self._run = runner or self._run_docker

    @staticmethod
    def _run_docker(args: list) -> str:
        out = subprocess.run(["docker", *args], check=True,
                             capture_output=True, text=True)
        return out.stdout.strip()

    @staticmethod
    def _normalize_store_env(environ: Dict[str, str]) -> Dict[str, str]:
        """File stores' paths made absolute: a relative one would resolve
        against the image's working directory inside the container."""
        env = dict(environ)
        meta = env.get(EnvVars.META_URI, "")
        if meta and meta != ":memory:" and "://" not in meta:
            env[EnvVars.META_URI] = os.path.abspath(meta)
        params = env.get(EnvVars.PARAMS_DIR, "")
        if params:
            env[EnvVars.PARAMS_DIR] = os.path.abspath(params)
        return env

    @staticmethod
    def _auto_mounts(environ: Dict[str, str]) -> list:
        """The file stores' directories, mounted at the same path inside
        the container, so the environment's paths hold there verbatim."""
        mounts = []
        meta = environ.get(EnvVars.META_URI, "")
        if meta and meta != ":memory:" and "://" not in meta:
            parent = os.path.dirname(meta)
            if parent and parent != "/":
                mounts.append(parent)
        params = environ.get(EnvVars.PARAMS_DIR, "")
        if params:
            mounts.append(params)
        return mounts

    def create_service(self, service_id: str, environ: Dict[str, str]) -> str:
        environ = self._normalize_store_env(environ)
        args = ["run", "-d", "--name", f"rafiki-{service_id[:12]}",
                "--network", self.network]
        for key, value in environ.items():
            args += ["-e", f"{key}={value}"]
        seen_targets = set()  # docker refuses a mount point twice
        for mount in self._auto_mounts(environ) + self.volumes:
            spec = mount if ":" in mount else f"{mount}:{mount}"
            target = spec.split(":")[1]
            if target in seen_targets:
                continue
            seen_targets.add(target)
            args += ["-v", spec]
        args += self.extra_args
        args += [self.image, "python", "-m", SERVICE_MODULE]
        return self._run(args)  # stdout = the container id

    def destroy_service(self, container_id: str) -> None:
        try:
            self._run(["rm", "-f", container_id])
        except subprocess.CalledProcessError:
            _log.warning("docker rm -f %s failed", container_id,
                         exc_info=True)

    def service_alive(self, container_id: str) -> bool:
        try:
            out = self._run(["inspect", "-f", "{{.State.Running}}",
                             container_id])
        except subprocess.CalledProcessError as e:
            # Only "no such container" is death. Any other failure of the
            # CLI (a daemon restarting) must not read as one, or the
            # supervisor would tear healthy services down.
            stderr = (e.stderr or "") if hasattr(e, "stderr") else ""
            if "No such" in stderr:
                return False
            _log.warning("docker inspect %s failed transiently; assuming "
                         "alive", container_id)
            return True
        return out.strip() == "true"
