"""Device resolution for the port: the counterpart of ``jaxenv``.

Every entry point takes an explicit ``device=`` and defaults to CUDA.
The CPU is used only when the caller asks for it (the tests do). When no
card is present and the caller did not ask for the CPU, resolution
raises: the port never quietly carries on on the CPU.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


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
