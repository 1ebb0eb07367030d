"""A node over several processes, on ``torch.distributed``.

The port's counterpart of the reference's ``jax.distributed`` use
(``rafiki_tpu/__main__.py:54-60``). After ``jax.distributed.initialize``
the reference's ``jax.devices()`` is the global device list: every
process's local devices, in process order; ``ChipGroup.devices``
(``rafiki_tpu/parallel/chips.py:44-48``), the ``ChipAllocator``
(:164-172) and ``build_mesh`` (``rafiki_tpu/parallel/mesh.py:57``) size
from it, and a mesh over it runs a family's data parallelism across the
processes whenever every process runs the same step. Here:

- ``initialize(coordinator, num_processes, process_id)`` joins the
  process group (``init_process_group(init_method="tcp://...")``), then
  each process tells the others its local devices. ``devices()`` is the
  global list: a local entry is a ``torch.device``, another process's a
  ``RemoteDevice`` (a descriptor: nothing can be placed on it here).
  ``shutdown`` leaves the group.
- The backend of the collectives is chosen once, from that topology:
  NCCL where every rank has a card of its own, gloo where the ranks are
  on the CPU or share a card (NCCL refuses two ranks on one device).
  It is logged and exposed as ``backend()``, and never swapped after a
  failure. Gloo takes only ``broadcast`` and ``all_reduce`` on CUDA
  tensors: every other collective here stages through host memory,
  explicitly.
- ``every_process()`` marks the thread's work as a step that every
  process runs (a trial's train step over a mesh that spans them).
  Outside it, a ``ChipGroup`` that holds another process's device
  raises ``NotAddressableError``, as jax refuses a device that is not
  addressable.
- The collectives the families' data parallelism needs, each carried by
  autograd: ``gather_rows`` (the processes' rows, in process order; its
  backward is the caller's own rows, since what follows the gather is
  computed alike in every process: the loss), ``ordered_sum`` (the
  ranks' partial sums added in rank order, as the one-process mesh adds
  them, so the value is bit for bit that mesh's; its backward sums the
  gradient over the processes) and ``sum_grads`` (the parameters'
  gradients summed over the processes after the backward, one
  collective a (device, dtype) group, in parameter order).

A mesh's ``dp`` axis may cross processes; its ``sp``, ``ep``, ``pp`` and
``tp`` axes may not (``CrossProcessAxisError``, ROADMAP queue 1 item
8 (e)).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import threading
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as tdist

from ..torchenv import PLATFORM_ENV

_log = logging.getLogger(__name__)


class NotAddressableError(RuntimeError):
    """A device of another process used where only this process's can
    be: outside a step that every process runs."""


class CrossProcessAxisError(ValueError):
    """A mesh whose sp, ep, pp or tp axis (or the tagger's experts)
    would cross processes: not ported (ROADMAP queue 1 item 8 (e))."""


@dataclass(frozen=True)
class RemoteDevice:
    """An entry of the global device list that lies on another process:
    its process, its device type and its index there."""

    process: int
    type: str
    index: int

    def __str__(self) -> str:
        where = self.type if self.type == "cpu" else f"{self.type}:{self.index}"
        return f"process {self.process} {where}"


@dataclass
class _Node:
    process_index: int
    num_processes: int
    backend: str
    local: List[torch.device]
    devices: List[Any]
    group: Any  # the collectives' group (None: the default one)


_NODE: Optional[_Node] = None
_TLS = threading.local()


def _local_default() -> List[torch.device]:
    kind = (os.environ.get(PLATFORM_ENV) or "cuda").strip().lower()
    if kind != "cpu" and torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _card_id(dev: torch.device) -> str:
    """What tells two ranks' cards apart: the card's UUID."""
    props = torch.cuda.get_device_properties(dev)
    return str(getattr(props, "uuid", dev.index))


def choose_backend(topology: Sequence[dict]) -> str:
    """``nccl`` when every process's local devices are cards and no card
    is any other rank's too, else ``gloo``."""
    cards = []
    for proc in topology:
        if not proc["devices"] or any(t != "cuda"
                                      for t, _, _ in proc["devices"]):
            return "gloo"
        cards.extend((proc["host"], cid) for _, _, cid in proc["devices"])
    if len(set(cards)) != len(cards) or not tdist.is_nccl_available():
        return "gloo"
    return "nccl"


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               local_devices: Optional[Sequence[Any]] = None,
               timeout_s: float = 300.0) -> _Node:
    """Join the node's process group at ``coordinator`` (``host:port``,
    process 0 listens there) as process ``process_id`` of
    ``num_processes``, with ``local_devices`` (default: this process's
    cards, or the CPU once when the platform is the CPU), and build the
    global device list. Returns the node's description."""
    global _NODE
    if _NODE is not None:
        raise RuntimeError("this process is already one of a node's")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in "
                         f"[0, {num_processes})")
    local = [torch.device(d) for d in (local_devices if local_devices
                                       is not None else _local_default())]
    if not local:
        raise ValueError("a process of a node needs a local device")
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    tdist.init_process_group("gloo", init_method=addr,
                             world_size=num_processes, rank=process_id,
                             timeout=timedelta(seconds=timeout_s))
    mine = {"host": socket.gethostname(),
            "devices": [(d.type, 0 if d.index is None else d.index,
                         _card_id(d) if d.type == "cuda" else "cpu")
                        for d in local]}
    topology: List[Any] = [None] * num_processes
    tdist.all_gather_object(topology, mine)
    backend = choose_backend(topology)
    group = tdist.new_group(backend="nccl") if backend == "nccl" else None
    devices: List[Any] = []
    for p, proc in enumerate(topology):
        for j, (kind, index, _) in enumerate(proc["devices"]):
            devices.append(local[j] if p == process_id
                           else RemoteDevice(p, kind, index))
    _NODE = _Node(process_id, num_processes, backend, local, devices, group)
    _log.info("process %d of %d: %d global devices, %d local, backend %s",
              process_id, num_processes, len(devices), len(local), backend)
    return _NODE


def shutdown() -> None:
    """Leave the node's process group (a no-op outside one)."""
    global _NODE
    if _NODE is None:
        return
    _NODE = None
    if tdist.is_initialized():
        tdist.destroy_process_group()


def is_initialized() -> bool:
    return _NODE is not None


def process_index() -> int:
    return 0 if _NODE is None else _NODE.process_index


def process_count() -> int:
    return 1 if _NODE is None else _NODE.num_processes


def backend() -> Optional[str]:
    """The collectives' backend, ``nccl`` or ``gloo``; None outside a
    node over several processes."""
    return None if _NODE is None else _NODE.backend


def devices() -> List[Any]:
    """The global device list (process order); outside a node, None."""
    return None if _NODE is None else list(_NODE.devices)


def local_devices() -> List[torch.device]:
    return [] if _NODE is None else list(_NODE.local)


def device_count() -> int:
    return 0 if _NODE is None else len(_NODE.devices)


def is_local(entry: Any) -> bool:
    """Whether a device-list entry is this process's."""
    return not isinstance(entry, RemoteDevice)


def owner(entry: Any) -> int:
    """The process a device-list entry lies on."""
    return entry.process if isinstance(entry, RemoteDevice) \
        else process_index()


@contextlib.contextmanager
def every_process() -> Iterator[None]:
    """Mark the block as a step that every process of the node runs:
    groups and meshes that hold other processes' devices are usable in
    it."""
    prior = getattr(_TLS, "every", False)
    _TLS.every = True
    try:
        yield
    finally:
        _TLS.every = prior


def in_every_process() -> bool:
    return bool(getattr(_TLS, "every", False))


# --- Collectives ---------------------------------------------------------


def _group():
    return None if _NODE is None else _NODE.group


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend's collectives other than all_reduce and
    broadcast take it: the host under gloo, the card under NCCL."""
    if backend() == "gloo" and t.device.type == "cuda":
        return t.to("cpu")
    return t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (one shape everywhere), stacked on a new
    leading axis in process order, on ``t``'s device. Not carried by
    autograd."""
    src = _staged(t.detach().contiguous())
    out = torch.empty((process_count(), *src.shape), dtype=src.dtype,
                      device=src.device)
    if backend() == "nccl":
        tdist.all_gather_into_tensor(out, src, group=_group())
    else:
        tdist.all_gather(list(out.unbind(0)), src, group=_group())
    return out.to(t.device, non_blocking=True)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes, in place (on the card too: gloo
    takes all_reduce there)."""
    tdist.all_reduce(t, group=_group())
    return t


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor, counts: Sequence[int]):
        me = process_index()
        ctx.lo = sum(counts[:me])
        ctx.n = local.shape[0]
        width = max(counts)
        pad = local
        if local.shape[0] < width:
            pad = torch.cat([local, local.new_zeros(
                (width - local.shape[0], *local.shape[1:]))])
        everyone = all_gather(pad)
        return torch.cat([everyone[p, :c] for p, c in enumerate(counts)])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[ctx.lo:ctx.lo + ctx.n], None


def gather_rows(local: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """The processes' rows joined in process order: process ``p`` gives
    ``counts[p]`` rows. Its backward hands back the caller's own rows
    of the gradient, which is right only where what follows the gather
    is computed alike in every process (the batch's loss)."""
    return _GatherRows.apply(local, tuple(int(c) for c in counts))


class _OrderedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor):
        ctx.k = local.shape[0]
        everyone = all_gather(local).flatten(0, 1)
        total = everyone[0]
        for s in everyone[1:]:
            total = total + s
        return total

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = all_reduce_(grad.contiguous().clone())
        return g.unsqueeze(0).expand(ctx.k, *g.shape)


def ordered_sum(local: torch.Tensor) -> torch.Tensor:
    """``local`` stacks this process's ranks' partials (every process
    the same count, ranks in process order): their sum over all ranks
    of the node, added in rank order (the one-process mesh's order, so
    the value is bit for bit its own). Autograd carries it: each
    partial's gradient is the sum over the processes of the total's."""
    return _OrderedSum.apply(local)


def sum_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the processes, after a
    backward that each process ran on its own rows: one all_reduce a
    (device, dtype) group of the gradients, in parameter order. A
    parameter without a gradient here has none in any process (every
    process runs the same step) and is left out."""
    groups: dict = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.device, p.grad.dtype), []).append(p)
    for ps in groups.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        all_reduce_(flat)
        offset = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
