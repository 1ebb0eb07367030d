"""LocalPlatform: the whole stack of one node, wired in one process.

The port's copy of ``rafiki_tpu/platform.py`` (:31-259), the composition
root it builds by default: every service a thread
(``ThreadContainerManager``), the bus ``bus_uri`` names (the
process-local ``MemoryBus`` by default, or a TCP broker's client),
sqlite meta and safetensors params under the workdir, a
``ChipAllocator`` over the node's CUDA devices, the ``ServicesManager``
and the ``Admin``, and the admin REST service when ``http=True``. A
supervisor thread sweeps for dead services every ``supervise_interval``
seconds (0 turns it off) and a heartbeat thread keeps this node's lease
fresh. The process's span sink is ``<workdir>/logs/spans.jsonl``
(``observe.trace``), which the admin's ``GET /trace/<id>`` reads, and
uploaded datasets land in ``<workdir>/datasets``.
``from_config`` builds one from a validated ``NodeConfig`` (the
``serve`` CLI's path).

A primary node's identity is stable across restarts (host and
workdir), so a restarted node sweeps its own stale rows; an exclusive
flock on ``<workdir>/node.lock`` refuses a second primary on the same
workdir. A join node shares a primary's workdir and bus: it passes a
``node_id`` of its own (no flock), ``stop_jobs_on_shutdown=False`` (it
must not stop the cluster's jobs when it leaves) and
``adopt_unowned=False``; on shutdown every node stops what it launched.

``device=None`` means CUDA: on a box without a card construction
raises, before it touches the workdir, and never carries on on the CPU.
``device="cpu"`` (the tests) runs every service on the CPU, each of the
allocator's ``n_chips`` chips (1 by default) being the host's CPU.

With the cluster fabric on (``RAFIKI_TPU_CLUSTER_FABRIC``, read when
the platform is built) the platform builds the node registry
(``admin/nodes.py``) as ``node_registry``, announces this node at once
and then on each heartbeat, and withdraws it on shutdown; off, it is
None and nothing of it exists.

The serving control loop is built only when armed, when the platform
is built: the autoscaler (``admin/autoscaler.py``) with
``RAFIKI_TPU_AUTOSCALE`` on, the SLO engine (``admin/slo_engine.py``)
when ``RAFIKI_TPU_SLO_RULES`` names objectives. Each is attached to the
services manager, whose supervise sweep runs them, and closed (its
series dropped) on shutdown. Off, each is None and nothing of it exists.
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
from .config import _parse_bool, cluster_fabric_enabled
from .container import SystemContext, ThreadContainerManager
from .observe import trace as observe_trace
from .observe import workload as observe_workload
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
                 device: DeviceLike = None,
                 stop_jobs_on_shutdown: bool = True, node_id: str = "",
                 adopt_unowned: bool = True):
        self.device = resolve_device(device)
        self.stop_jobs_on_shutdown = stop_jobs_on_shutdown
        self._tmp = None
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="rafiki_torch_")
            workdir = self._tmp.name
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)

        # A primary's identity is stable across restarts (host +
        # workdir), so a restarted node's supervise sweep finds its own
        # rows. Two live primaries on one workdir would each judge the
        # other's services dead: an exclusive flock, held for the
        # process's life, refuses the second before it opens anything.
        # A join node names itself and shares the workdir by design.
        self._lock_fd = None
        if not node_id:
            wd = hashlib.sha1(
                os.path.abspath(workdir).encode()).hexdigest()[:8]
            node_id = f"{socket.gethostname()}/{wd}"
            self._lock_fd = os.open(os.path.join(workdir, "node.lock"),
                                    os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(self._lock_fd)
                self._lock_fd = None
                raise RuntimeError(
                    f"another primary node already serves workdir "
                    f"{workdir!r} (node_id {node_id}); a second one would "
                    f"supervise-kill the first's workers. Use a different "
                    f"workdir, or join the cluster with `rafiki_torch "
                    f"join`.") from None

        meta_uri = os.path.join(workdir, "meta.db")
        params_dir = os.path.join(workdir, "params")
        self.meta = MetaStore(meta_uri)
        self.params = ParamStore(params_dir)
        self.bus = connect(bus_uri)
        self.ctx = SystemContext(meta=self.meta, params=self.params,
                                 bus=self.bus, device_type=self.device.type)
        self.container = ThreadContainerManager(self.ctx)
        self.allocator = ChipAllocator(n_chips, device=self.device)
        self.services = ServicesManager(
            self.meta, self.container, self.allocator, node_id,
            log_dir=os.path.join(workdir, "logs"), meta_uri=meta_uri,
            params_dir=params_dir, bus_uri=bus_uri,
            adopt_unowned=adopt_unowned)
        # Every service thread of this process (HTTP edges, batcher,
        # workers) appends its spans here.
        observe_trace.configure(self.services.log_dir)
        # The workload records (on with RAFIKI_TPU_WORKLOAD_RECORD) go
        # next to it, in <workdir>/logs/workload.jsonl.
        observe_workload.configure(self.services.log_dir)
        # Uploaded datasets (POST /datasets) land in <workdir>/datasets.
        self.admin = Admin(self.meta, self.params, self.services,
                           datasets_dir=os.path.join(workdir, "datasets"))
        self.autoscaler = None
        if _parse_bool(os.environ.get("RAFIKI_TPU_AUTOSCALE", "0")):
            from .admin.autoscaler import Autoscaler

            self.autoscaler = Autoscaler.from_env(self.services, self.meta)
            self.services.autoscaler = self.autoscaler
        self.slo_engine = None
        if os.environ.get("RAFIKI_TPU_SLO_RULES", "").strip():
            from .admin.slo_engine import SloEngine

            self.slo_engine = SloEngine.from_env(self.services, self.meta)
            self.services.slo_engine = self.slo_engine
        self.node_registry = None
        if cluster_fabric_enabled():
            from .admin.nodes import NodeRegistry

            self.node_registry = NodeRegistry(
                self.services.serving_bus, node_id=self.services.node_id,
                n_chips=self.allocator.n_chips, bus_uri=bus_uri,
                lease_s=self.services.NODE_LEASE)
            self.services.node_registry = self.node_registry
            try:
                self.node_registry.announce()
            except (ConnectionError, OSError, RuntimeError):
                _log.warning("initial node registry announce failed; the "
                             "heartbeat retries", exc_info=True)
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

    @classmethod
    def from_config(cls, cfg, http: bool = False,
                    device: DeviceLike = None) -> "LocalPlatform":
        """Construct from one validated ``NodeConfig`` (the ``serve``
        CLI's path)."""
        return cls(workdir=cfg.workdir, n_chips=cfg.n_chips, http=http,
                   admin_port=cfg.port, bus_uri=cfg.bus_uri,
                   supervise_interval=cfg.supervise_interval,
                   device=device)

    @property
    def admin_port(self) -> int:
        assert self.app is not None, "platform started without http=True"
        return self.app.port

    def shutdown(self) -> None:
        self._stop_supervisor.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        self._heartbeat.join(timeout=5)
        if self.autoscaler is not None:
            self.services.autoscaler = None
            self.autoscaler.close()  # drop the autoscale series
        if self.slo_engine is not None:
            self.services.slo_engine = None
            self.slo_engine.close()  # drop the slo series
        if self.node_registry is not None:
            self.services.node_registry = None
            try:
                self.node_registry.close()  # withdraw, drop the series
            except (ConnectionError, OSError, RuntimeError):
                pass  # the broker may be gone already
        if self.app is not None:
            self.app.stop()
        if self.stop_jobs_on_shutdown:
            for job in self.meta.get_train_jobs(status="RUNNING"):
                self.services.stop_train_services(job["id"])
            for job in self.meta.get_inference_jobs(status="RUNNING"):
                self.services.stop_inference_services(job["id"])
        # Either way, stop what this node launched: a leaving join node
        # must leave no RUNNING row to read as a live remote worker.
        self.services.stop_own_services()
        self.meta.close()
        self.params.close()
        observe_trace.release(self.services.log_dir)
        observe_workload.configure(None)
        if isinstance(self.bus, MemoryBus):
            MemoryBus.reset_shared()
        else:
            self.bus.close()
        if self._lock_fd is not None:  # releases the flock too
            os.close(self._lock_fd)
            self._lock_fd = None
        if self._tmp is not None:
            self._tmp.cleanup()
