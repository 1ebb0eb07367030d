"""Device traces and utilization metering.

The port's copy of ``rafiki_tpu/observe/profiling.py``, on
``torch.profiler`` where the reference has ``jax.profiler``:

- **Trace sessions.** ``trace_session(dir)`` profiles a block (CPU and,
  on a card, CUDA activities) and writes one Chrome/TensorBoard trace
  file (``<host>_<pid>.<ns>.pt.trace.json``) into ``dir``. With
  ``RAFIKI_TPU_TRACE_DIR`` set, ``TrialRunner`` traces each trial into
  ``$RAFIKI_TPU_TRACE_DIR/<trial_id>/`` (``trial_trace_dir``).
  ``start_device_profile`` opens a bounded session on a live serving
  worker (``POST /inference_jobs/<id>/profile``), which its serve loop
  stops at the deadline.
- **MFU metering.** ``MfuMeter`` turns steps against wall time into
  achieved FLOP/s and a fraction of the card's peak
  (``device_peak_flops``: a table by the card's name, the
  ``RAFIKI_TPU_PEAK_FLOPS`` override, a calibrated matmul estimate on
  the CPU). ``flops_of_step`` counts one step's FLOPs with
  ``torch.utils.flop_counter``.

One profiler a process: Kineto allows one session, so the trial traces
and the on-demand sessions share one lock, and a busy profiler skips
the trace (counted in ``rafiki_tpu_trial_traces_total{event=busy}`` or
``rafiki_tpu_profile_sessions_total{event=busy}``), never failing the
trial or the worker. A session's start and stop hold the process's
capture lock (``torchenv.capture_exclusive``): starting or stopping
CUPTI while another thread captures a CUDA graph may break the capture.
Time-sliced tenants share one process and one CUDA context, so a
trace's device events hold every thread's kernels, another tenant's
too; each trace file says so in its ``rafiki_tpu_trace`` metadata.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

from ..torchenv import DeviceLike, capture_exclusive, resolve_device

_log = logging.getLogger(__name__)

TRACE_DIR_ENV = "RAFIKI_TPU_TRACE_DIR"
PEAK_FLOPS_ENV = "RAFIKI_TPU_PEAK_FLOPS"

#: Peak dense bf16 FLOP/s of one card by a substring of the name
#: ``torch.cuda.get_device_name`` gives. H100 SXM: 989 TFLOP/s without
#: sparsity, from NVIDIA's H100 data sheet, at the full 700 W limit.
_PEAK_FLOPS_BY_NAME = {
    "H100 80GB HBM3": 989e12,
    "H100 SXM": 989e12,
}

H100_PEAK_BF16_FLOPS = _PEAK_FLOPS_BY_NAME["H100 80GB HBM3"]

#: What every trace file says of its own scope.
TRACE_SCOPE = ("device events cover every thread of the process: a "
               "time-sliced tenant's kernels share the card and its CUDA "
               "context, so they appear in this trace too")


def trial_trace_dir(trial_id: str) -> Optional[str]:
    """The directory to trace this trial into, or None when tracing is
    off (``RAFIKI_TPU_TRACE_DIR`` unset)."""
    root = os.environ.get(TRACE_DIR_ENV, "").strip()
    if not root:
        return None
    return os.path.join(root, trial_id)


#: The one profiler of the process: trial traces and on-demand sessions
#: take it without waiting, a script's own profile waits for it.
PROFILER_LOCK = threading.Lock()


def _trial_counter():
    from . import metrics

    return metrics.registry().counter(
        "rafiki_tpu_trial_traces_total",
        "Per-trial trace sessions (event=start|busy: skipped for a busy "
        "profiler)")


def _profile_counter():
    from . import metrics

    return metrics.registry().counter(
        "rafiki_tpu_profile_sessions_total",
        "On-demand device profile sessions (event=start|busy|stop)")


def _count(counter, event: str) -> None:
    try:
        # rta: disable=RTA301 event is the fixed start|busy|stop vocabulary of the two profiler families; process-global, deliberately immortal
        counter().inc(event=event)
    except Exception:  # metrics must never fail a session
        pass


def _activities() -> List[Any]:
    from torch.profiler import ProfilerActivity, supported_activities

    have = supported_activities()
    acts = [ProfilerActivity.CPU]
    if ProfilerActivity.CUDA in have and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start_profiler(out_dir: str, what: str) -> Any:
    """A started ``torch.profiler`` session whose trace goes to
    ``out_dir``."""
    from torch.profiler import profile

    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=_activities())
    with capture_exclusive():
        prof.start()
    prof.add_metadata_json("rafiki_tpu_trace", json.dumps(
        {"what": what, "pid": os.getpid(), "scope": TRACE_SCOPE}))
    return prof


def _stop_profiler(prof: Any, out_dir: str) -> Tuple[str, float, float]:
    """Stop the session and write its trace file: ``(path, seconds to
    stop, seconds to write)``."""
    t0 = time.monotonic()
    with capture_exclusive():
        prof.stop()
    t1 = time.monotonic()
    path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path, t1 - t0, time.monotonic() - t1


@contextlib.contextmanager
def trace_session(trace_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block into ``trace_dir`` (nothing when None,
    and only a count when the profiler is busy)."""
    if not trace_dir:
        yield
        return
    if not PROFILER_LOCK.acquire(blocking=False):
        _log.info("profiler busy; skipping trace for %s", trace_dir)
        _count(_trial_counter, "busy")
        yield
        return
    try:
        prof = _start_profiler(trace_dir, "trial " + os.path.basename(
            trace_dir.rstrip(os.sep)))
        _count(_trial_counter, "start")
        try:
            yield
        finally:
            path, stop_s, write_s = _stop_profiler(prof, trace_dir)
            _log.info("trace written to %s (stop %.3f s, write %.3f s)",
                      path, stop_s, write_s)
    finally:
        PROFILER_LOCK.release()


#: Ceiling of an on-demand profile session: the profiler holds buffers
#: and the process's one profiler, so a long request is clamped.
PROFILE_MAX_S = 60.0


class DeviceProfileSession:
    """One bounded on-demand ``torch.profiler`` session on a live
    serving worker: started between bursts, stopped by the worker's
    serve loop once the deadline passes (or when the loop exits), so
    serving never pauses; it observes the bursts inside its window."""

    def __init__(self, prof: Any, out_dir: str, deadline_mono: float):
        self.out_dir = out_dir
        self.deadline_mono = deadline_mono
        self._prof = prof
        self._stopped = False

    def expired(self, now: float) -> bool:
        return now >= self.deadline_mono

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        try:
            path, stop_s, write_s = _stop_profiler(self._prof, self.out_dir)
            _log.info("on-demand profile written to %s (stop %.3f s, "
                      "write %.3f s)", path, stop_s, write_s)
        except Exception:
            _log.exception("on-demand profile stop failed")
        finally:
            PROFILER_LOCK.release()
            _count(_profile_counter, "stop")


def start_device_profile(out_dir: str, duration_s: float,
                         ) -> Optional[DeviceProfileSession]:
    """Begin a bounded on-demand profile into ``out_dir`` (the duration
    clamped to [0.5, ``PROFILE_MAX_S``] seconds); None when the profiler
    is busy or cannot start. The caller serves on either way."""
    duration_s = min(max(0.5, float(duration_s)), PROFILE_MAX_S)
    if not PROFILER_LOCK.acquire(blocking=False):
        _log.info("profiler busy; on-demand profile request skipped")
        _count(_profile_counter, "busy")
        return None
    try:
        prof = _start_profiler(out_dir, "on-demand profile")
    except Exception:
        PROFILER_LOCK.release()
        _log.exception("on-demand profile start failed")
        return None
    _count(_profile_counter, "start")
    return DeviceProfileSession(prof, out_dir,
                                time.monotonic() + duration_s)


def device_peak_flops(device: DeviceLike = None) -> Optional[float]:
    """Peak FLOP/s of one device, or None when unknown.

    ``RAFIKI_TPU_PEAK_FLOPS`` overrides. A card's peak comes from the
    table above by its name. The CPU has no data sheet here: the first
    call times a dense f32 matmul and returns the achieved rate, a
    calibrated estimate that no caller reports as a device metric.
    ``None`` means the card (``torchenv.resolve_device``)."""
    override = os.environ.get(PEAK_FLOPS_ENV, "").strip()
    if override:
        return float(override)
    dev = resolve_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        for sub, peak in _PEAK_FLOPS_BY_NAME.items():
            if sub in name:
                return peak
        return None
    return _cpu_peak_flops_estimate()


_cpu_peak_cache: List[float] = []
_cpu_peak_lock = threading.Lock()


def _cpu_peak_flops_estimate() -> float:
    """Best of 3 achieved FLOP/s of a 512³ f32 matmul, cached per
    process (about 100 ms once, on this process's cores)."""
    with _cpu_peak_lock:
        if _cpu_peak_cache:
            return _cpu_peak_cache[0]
        n = 512
        x = torch.ones((n, n), dtype=torch.float32)
        x @ x  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            x @ x
            best = min(best, time.perf_counter() - t0)
        peak = 2 * n ** 3 / max(best, 1e-9)
        _cpu_peak_cache.append(peak)
        return peak


def flops_of_step(step: Callable[[], Any]) -> Optional[float]:
    """FLOPs of one call of ``step`` as ``torch.utils.flop_counter``
    counts them (matmuls, convolutions and
    ``scaled_dot_product_attention``: 2 a multiply-add, backward
    included when ``step`` runs it); None when it counts none. The
    counter sees only torch operators, not the kernels bound through
    ctypes (K1-K3), so count a step whose attention runs on the plain
    path (``ops.attention.flash_attention_plain``, or the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step()
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


class MfuMeter:
    """Steps against wall time -> achieved FLOP/s and MFU.

    ``flops_per_step`` is the cost of one train step over the
    ``n_devices`` it runs on; the peak is ``peak_flops_per_device``
    times ``n_devices``, the device's own (``device_peak_flops``) when
    not given, resolved at the first read of ``peak``."""

    def __init__(self, flops_per_step: Optional[float],
                 n_devices: int = 1,
                 peak_flops_per_device: Optional[float] = None,
                 device: DeviceLike = None):
        self.flops_per_step = flops_per_step
        self.n_devices = n_devices
        self._peak_per_device = peak_flops_per_device
        self._device = device
        self.n_steps = 0
        # Monotonic, so a wall-clock step cannot give a negative rate.
        self._t0 = time.monotonic()

    @property
    def peak(self) -> Optional[float]:
        if self._peak_per_device is None:
            self._peak_per_device = device_peak_flops(self._device)
        if not self._peak_per_device:
            return None
        return self._peak_per_device * self.n_devices

    def tick(self, n_steps: int = 1) -> None:
        self.n_steps += n_steps

    def reset(self) -> None:
        """Restart the measurement window (after a warm-up that is not
        part of steady-state utilization)."""
        self.n_steps = 0
        self._t0 = time.monotonic()

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    @property
    def achieved_flops(self) -> Optional[float]:
        """Achieved FLOP/s so far (None when the step cost is unknown
        or no step counted)."""
        if not self.flops_per_step or self.n_steps == 0:
            return None
        return self.flops_per_step * self.n_steps / max(self.elapsed, 1e-9)

    @property
    def mfu(self) -> Optional[float]:
        """Fraction of peak [0, ~1], or None when peak or cost is
        unknown."""
        achieved = self.achieved_flops
        if achieved is None:
            return None
        peak = self.peak
        if not peak:
            return None
        return achieved / peak
