"""Native bus broker: a C++ event-loop server, compiled at first use.

The port's copy of ``rafiki_tpu/bus/native.py``. The Python
``BusServer`` (``tcp.py``) parses and re-encodes every frame under the
interpreter lock, so a busy node's control-plane traffic contends with
its model host code. ``NativeBusServer`` runs the wire-compatible C++
broker (``native_broker.cpp`` beside this file: a ``poll()`` event loop
that splices payloads without re-parsing them) as a child process;
``BusClient`` connects to either unchanged.

g++ builds the binary at first use into ``build/broker/`` at the root
of the checkout, named by a hash of the source, through a temporary
file and a rename, so two processes building it at once race
benignly.
``NativeBusServer.available()`` says whether a toolchain (or a binary
already built) exists; ``serve_broker`` takes the Python broker when
none does or the build fails, as the reference does, and says which
broker it started.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_log = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parent / "native_broker.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "broker"


def _binary_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"native_broker_{digest}"


def build_broker(force: bool = False) -> str:
    """Compile the broker unless its binary exists; returns the binary's
    path. Raises ``RuntimeError`` when g++ fails or is missing."""
    binary = _binary_path()
    if not force and binary.exists():
        return str(binary)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-o", tmp, str(_SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        os.unlink(tmp)
        detail = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(f"native broker build failed: {detail}") from e
    os.chmod(tmp, 0o755)
    os.replace(tmp, binary)
    return str(binary)


class NativeBusServer:
    """The broker child's handle, with ``BusServer``'s interface.
    ``build_s`` is the seconds its construction spent in g++ (0.0 when
    the binary was already built)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        built = _binary_path().exists()
        t0 = time.perf_counter()
        self._binary = build_broker()
        self.build_s = 0.0 if built else time.perf_counter() - t0
        self._requested = (host, port)
        self.host = host
        self.port = port
        self._proc: Optional[subprocess.Popen] = None

    @staticmethod
    def available() -> bool:
        """Whether the binary is built or g++ is there to build it (the
        build itself happens when a server is made, and a failed one
        raises there)."""
        return _binary_path().exists() or shutil.which("g++") is not None

    @property
    def uri(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    def start(self) -> "NativeBusServer":
        host, port = self._requested
        self._proc = subprocess.Popen(
            [self._binary, host, str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        line = self._proc.stdout.readline().strip()  # "PORT <n>"
        if not line.startswith("PORT "):
            self.stop()
            raise RuntimeError(
                f"native broker failed to start (got {line!r})")
        self.port = int(line.split()[1])
        return self

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._proc.stdout.close()
            self._proc = None

    def serve_forever(self) -> None:
        """Run in the foreground (the broker process's entry). Raises
        when the child broker dies on its own: a crash must not look
        like a clean shutdown to a supervisor."""
        if self._proc is None:
            self.start()
        rc = self._proc.wait()
        if self._proc is not None and rc != 0:
            raise RuntimeError(f"native broker exited with status {rc}")


def serve_broker(host: str = "127.0.0.1", port: int = 0, *,
                 native: Optional[bool] = None, node_id: str = ""):
    """Start a broker, the native one by preference, and return it
    started (``.uri``, ``.stop()``).

    ``native=None`` picks the C++ broker when a toolchain or a built
    binary exists, else the Python ``BusServer``. ``node_id`` names the
    cluster node whose queues this broker serves, with the inter-node
    relay, which only the Python broker has: naming a node picks it."""
    from ..observe import metrics
    from .tcp import BusServer

    def _mark(backend: str) -> None:
        if metrics.metrics_enabled():
            # rta: disable=RTA301 backend is one of two fixed broker kinds, set once per process
            metrics.registry().gauge(
                "rafiki_tpu_bus_broker_info",
                "1 for the broker backend this process started"
            ).set(1, backend=backend)

    if native is None:
        native = NativeBusServer.available() and not node_id
    if native and node_id:
        raise ValueError("native broker does not support the inter-node "
                         "relay; start a node-scoped broker with "
                         "native=False (or native=None)")
    if native:
        try:
            server = NativeBusServer(host, port).start()
            _mark("native")
            _log.info("native bus broker on %s", server.uri)
            return server
        except RuntimeError:
            _log.warning("native broker unavailable; using Python broker",
                         exc_info=True)
    server = BusServer(host, port, node_id=node_id).start()
    _mark("python")
    _log.info("Python bus broker on %s", server.uri)
    return server
