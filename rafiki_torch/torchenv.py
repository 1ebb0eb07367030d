"""Device resolution for the port: the counterpart of ``jaxenv``.

Every entry point takes an explicit ``device=`` and defaults to CUDA.
The CPU is used only when the caller asks for it (the tests do). When no
card is present and the caller did not ask for the CPU, resolution
raises: the port never quietly carries on on the CPU.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
from typing import Any, Iterator, Mapping, Optional, Union

import torch

from .constants import EnvVars

DeviceLike = Union[str, torch.device, None]

#: The device type a service process runs on, ``cuda`` or ``cpu``: the
#: reference's resolved-platform variable, which its children honour.
#: A ``ServicesManager`` writes its node's device type into every
#: service's environment.
PLATFORM_ENV = EnvVars.PLATFORM


def env_device(env: Optional[Mapping[str, str]] = None) -> torch.device:
    """The device ``PLATFORM_ENV`` names in ``env`` (``os.environ`` by
    default), resolved: unset means CUDA, which raises without a card;
    any other word than ``cuda`` or ``cpu`` raises ``ValueError``."""
    env = os.environ if env is None else env
    raw = (env.get(PLATFORM_ENV) or "cuda").strip().lower()
    if raw not in ("cuda", "cpu"):
        raise ValueError(f"{PLATFORM_ENV}={raw!r}: expected cuda or cpu")
    return resolve_device(raw)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. ``"cpu"`` is honoured as asked. A CUDA
    device without a card raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(device: Optional[torch.device] = None) -> None:
    """Wait for the card's queued work (a no-op on the CPU): what the
    reference's jitted sync probe measured with a device round trip."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


#: Held while a thread works on a side stream or captures a CUDA graph.
#: ``torch.cuda.Stream()`` hands out the same few pooled streams to
#: every thread, and ``torch.cuda.graph`` captures on one of them: work
#: that another thread enqueues on a stream being captured falls into
#: the graph or breaks the capture, and a capture's start synchronises
#: the device, which breaks a capture running on another thread. Two
#: inference workers building their first runners at once did both.
#: The lock is the process's own: a service process on the same card
#: has a CUDA context, streams and graph pools of its own, and captures
#: there are not ordered against captures here.
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def side_stream(device: torch.device) -> Iterator[None]:
    """Run the block on a side stream that waits for the current one
    and is waited for after it (a capture's warm-up: the libraries make
    their workspaces there), while no other thread of the process uses
    a side stream or captures."""
    with _CAPTURE_LOCK:
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            yield
        main.wait_stream(side)


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph", pool: Any = None,
                  stream: Any = None) -> Iterator[None]:
    """``torch.cuda.graph(graph, pool=pool, stream=stream)`` (``stream``
    None: torch's own capture stream) while no other thread of
    the process uses a side stream or captures. ``thread_local``: other
    threads may keep launching work on their current streams meanwhile
    (an inference worker beside a train step's capture).

    Python's cyclic garbage collector is off for the capture: a cycle it
    collected there could hold a CUDA graph, whose destruction inside a
    capture invalidates it (and leaves ``pool`` marked as recording,
    so every later capture into it raises)."""
    with _CAPTURE_LOCK:
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                yield
        finally:
            if collecting:
                gc.enable()


@contextlib.contextmanager
def capture_exclusive() -> Iterator[None]:
    """Hold the capture lock: no other thread of the process captures a
    CUDA graph or works on a side stream meanwhile. A profiler's start
    and stop take it, since switching CUPTI on or off during another
    thread's capture may break that capture."""
    with _CAPTURE_LOCK:
        yield
