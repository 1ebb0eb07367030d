"""LocalPlatform: the whole stack of one node, wired in one process.

The port's copy of ``rafiki_tpu/platform.py`` (:31-259), the composition
root it builds by default: every service a thread
(``ThreadContainerManager``), the process-local ``MemoryBus``, sqlite
meta and safetensors params under the workdir, a ``ChipAllocator`` over
the node's CUDA devices, the ``ServicesManager`` and the ``Admin``, and
the admin REST service when ``http=True``. A supervisor thread sweeps
for dead services every ``supervise_interval`` seconds (0 turns it off)
and a heartbeat thread keeps this node's lease fresh.

``device=None`` means CUDA: on a box without a card construction
raises, before it touches the workdir, and never carries on on the CPU.
``device="cpu"`` (the tests) runs every service on the CPU, each of the
allocator's ``n_chips`` chips (1 by default) being the host's CPU.

The reference's autoscaler, SLO engine and node registry are off by
default there and not ported here; ``from_config`` waits for the
``serve`` CLI and ``NodeConfig``, and the options of a node that joins
another's workdir (``node_id``, ``adopt_unowned``,
``stop_jobs_on_shutdown``) for the ``join`` CLI.
"""

from __future__ import annotations

import fcntl
import hashlib
import logging
import os
import socket
import tempfile
import threading
from typing import Optional

from .admin import Admin, ServicesManager
from .admin.app import AdminApp
from .bus import MemoryBus, connect
from .container import SystemContext, ThreadContainerManager
from .parallel.chips import ChipAllocator
from .store import MetaStore, ParamStore
from .torchenv import DeviceLike, resolve_device

_log = logging.getLogger(__name__)


class LocalPlatform:
    """Everything needed to run jobs on this node.

    ``workdir=None`` -> a temporary directory; meta and params live
    under it. ``n_chips=None`` -> every CUDA device (one chip on the
    CPU). ``http=True`` also starts the admin REST service
    (``admin_port`` 0 picks a free port).
    """

    def __init__(self, workdir: Optional[str] = None,
                 n_chips: Optional[int] = None, http: bool = False,
                 admin_port: int = 0, bus_uri: str = "",
                 supervise_interval: float = 10.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._tmp = None
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="rafiki_torch_")
            workdir = self._tmp.name
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)

        # A node's identity is stable across restarts (host + workdir),
        # so a restarted node's supervise sweep finds its own rows. Two
        # live primaries on one workdir would each judge the other's
        # services dead: an exclusive flock, held for the process's
        # life, refuses the second before it opens anything.
        wd = hashlib.sha1(os.path.abspath(workdir).encode()).hexdigest()[:8]
        node_id = f"{socket.gethostname()}/{wd}"
        self._lock_fd = os.open(os.path.join(workdir, "node.lock"),
                                os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._lock_fd)
            self._lock_fd = None
            raise RuntimeError(
                f"another primary node already serves workdir {workdir!r} "
                f"(node_id {node_id}); a second one would supervise-kill "
                f"the first's workers. Use a different workdir.") from None

        self.meta = MetaStore(os.path.join(workdir, "meta.db"))
        self.params = ParamStore(os.path.join(workdir, "params"))
        self.bus = connect(bus_uri)
        self.ctx = SystemContext(meta=self.meta, params=self.params,
                                 bus=self.bus, device_type=self.device.type)
        self.container = ThreadContainerManager(self.ctx)
        self.allocator = ChipAllocator(n_chips, device=self.device)
        self.services = ServicesManager(self.meta, self.container,
                                        self.allocator, node_id)
        self.admin = Admin(self.meta, self.params, self.services)
        self.app: Optional[AdminApp] = None
        if http:
            self.app = AdminApp(self.admin, port=admin_port).start()

        self._stop_supervisor = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        if supervise_interval > 0:
            def _loop() -> None:
                while not self._stop_supervisor.wait(supervise_interval):
                    try:
                        self.services.supervise()
                    except Exception:
                        _log.exception("supervision sweep failed")

            self._supervisor = threading.Thread(
                target=_loop, name="supervisor", daemon=True)
            self._supervisor.start()

        # The heartbeat is always on, whatever the sweep's interval:
        # this node's lease must not lapse while its workers live.
        def _beat() -> None:
            interval = self.services.NODE_LEASE / 4.0
            while not self._stop_supervisor.wait(interval):
                try:
                    self.services.heartbeat()
                except Exception:
                    _log.exception("heartbeat failed")

        self._heartbeat = threading.Thread(target=_beat, name="heartbeat",
                                           daemon=True)
        self._heartbeat.start()

    @property
    def admin_port(self) -> int:
        assert self.app is not None, "platform started without http=True"
        return self.app.port

    def shutdown(self) -> None:
        self._stop_supervisor.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        self._heartbeat.join(timeout=5)
        if self.app is not None:
            self.app.stop()
        for job in self.meta.get_train_jobs(status="RUNNING"):
            self.services.stop_train_services(job["id"])
        for job in self.meta.get_inference_jobs(status="RUNNING"):
            self.services.stop_inference_services(job["id"])
        self.services.stop_own_services()
        self.meta.close()
        self.params.close()
        MemoryBus.reset_shared()
        if self._lock_fd is not None:  # releases the flock too
            os.close(self._lock_fd)
            self._lock_fd = None
        if self._tmp is not None:
            self._tmp.cleanup()
