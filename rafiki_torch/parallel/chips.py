"""Chip groups: which CUDA devices a service runs on.

The port's copy of ``ChipGroup`` and ``ChipAllocator`` from
``rafiki_tpu/parallel/chips.py`` (:34-86, :127-360). The scheduler
assigns each worker a contiguous range of device indices, carried in
the service's environment as ``EnvVars.CHIPS`` (the counterpart of
``CUDA_VISIBLE_DEVICES``). A worker runs on its group's first device
(``ChipGroup.device``) and binds the group to its thread
(``bind_to_thread``, ref :67-86), so that a model that builds a mesh
(``parallel.mesh.build_mesh``; the transformer tagger's parallel modes)
finds the group's devices through ``ChipGroup.current()``: the thread's
group, else the environment's, else every CUDA device. A group's
indices may repeat: ``ChipGroup(indices=(0,) * 4)`` is a mesh of four
entries on one card, the counterpart of the reference tests' virtual
devices. The allocator hands out distinct chips only.

The allocator counts the node's CUDA devices and raises when there is
none: it never reports a card it does not have. In a node over several
processes (``parallel.dist``) a group's indices and the allocator's
count are of the global device list, every process's devices in process
order, as the reference's are of ``jax.devices()``. A platform asked to run
on the CPU (the tests) gives the allocator its chip count, each chip
then being the host's CPU.

The reference places a group on the TPU's ICI torus as the most compact
free box (``discover_topology``, :88-126); the cards of one host expose
no such coordinates (``discover_topology`` gives None for CUDA and CPU
devices, as the reference does for devices without ``.coords``), so
placement here is the reference's fallback for a backend without them:
first fit on a contiguous index range.

``allocate(..., shared_ok=True)`` keeps the reference's time-sliced
tier: when no exclusive range is free, a group may be placed on chips
others already own, least-subscribed first, up to ``max_share`` owners
a chip: ``RAFIKI_TPU_MAX_CHIP_SHARE`` (``NodeConfig.max_chip_share``),
read at each call, else ``MAX_SHARE``. Only the thread container
manager allows it: its services share one process and one CUDA
context, so their launches interleave on the card.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from . import dist
from ..constants import EnvVars
from ..torchenv import PLATFORM_ENV, DeviceLike, resolve_device

#: Owners a chip may have in the time-sliced tier, by default.
MAX_SHARE = 4
MAX_SHARE_ENV = "RAFIKI_TPU_MAX_CHIP_SHARE"


@dataclass(frozen=True)
class ChipGroup:
    """An ordered set of device indices assigned to one service."""

    indices: tuple
    name: str = ""
    device_type: str = "cuda"

    @property
    def n_chips(self) -> int:
        return len(self.indices)

    @property
    def device(self) -> torch.device:
        """The device the group's worker runs on: its first card, or the
        CPU for a group of a platform run on the CPU. In a node over
        several processes, a group that holds another process's device
        raises ``NotAddressableError``, unless the thread runs a step
        that every process runs (``dist.every_process``): there it is
        the group's first local device."""
        if not dist.is_initialized():
            if self.device_type == "cpu":
                return torch.device("cpu")
            return torch.device(self.device_type, self.indices[0])
        entries = self.devices()
        local = [d for d in entries if dist.is_local(d)]
        if len(local) != len(entries) and not dist.in_every_process():
            remote = next(d for d in entries if not dist.is_local(d))
            raise dist.NotAddressableError(
                f"chip group {self.name or self.indices} holds {remote}, "
                f"which this process (process {dist.process_index()}) "
                "cannot address outside a step that every process runs")
        if not local:
            raise dist.NotAddressableError(
                f"chip group {self.name or self.indices} holds no device "
                f"of process {dist.process_index()}")
        return local[0]

    def devices(self) -> List[Any]:
        """The group's devices in group order, one an index: CUDA
        devices, or the CPU once an index for a group of a platform run
        on the CPU. In a node over several processes an index is one of
        the global list (``dist.devices()``, ref :44-48), and another
        process's entry is a ``dist.RemoteDevice``."""
        if dist.is_initialized():
            everyone = dist.devices()
            return [everyone[i] for i in self.indices]
        if self.device_type == "cpu":
            return [torch.device("cpu")] * len(self.indices)
        return [torch.device(self.device_type, i) for i in self.indices]

    def to_env(self) -> str:
        return ",".join(str(i) for i in self.indices)

    @staticmethod
    def from_env(value: str, device_type: str = "cuda") -> "ChipGroup":
        """The group named by an ``EnvVars.CHIPS`` value."""
        idx = tuple(int(x) for x in value.split(",") if x != "")
        if not idx:
            raise ValueError("an empty chip group")
        return ChipGroup(indices=idx, device_type=device_type)

    # --- Thread-scoped binding (ref :67-86) ---
    #
    # Worker threads sharing one process cannot partition devices through
    # the process-wide environment; each service thread binds its group
    # here and models resolve it through ``current()``.

    _tls = threading.local()

    def bind_to_thread(self) -> None:
        ChipGroup._tls.group = self

    @staticmethod
    def unbind_thread() -> None:
        ChipGroup._tls.group = None

    @staticmethod
    def bound() -> Optional["ChipGroup"]:
        """The thread's group, else the one ``EnvVars.CHIPS`` names (on
        the device type ``PLATFORM_ENV`` names, CUDA by default), else
        None."""
        group = getattr(ChipGroup._tls, "group", None)
        if group is not None:
            return group
        value = os.environ.get(EnvVars.CHIPS, "")
        if not value:
            return None
        kind = (os.environ.get(PLATFORM_ENV) or "cuda").strip().lower()
        return ChipGroup.from_env(value, "cpu" if kind == "cpu" else "cuda")

    @staticmethod
    def current() -> "ChipGroup":
        """``bound()``, else every device of the node: the global list
        in a node over several processes, else every CUDA device (raises
        without a card, as ``resolve_device`` does)."""
        group = ChipGroup.bound()
        if group is not None:
            return group
        if dist.is_initialized():
            return ChipGroup(indices=tuple(range(dist.device_count())),
                             device_type=dist.local_devices()[0].type)
        resolve_device("cuda")
        return ChipGroup(indices=tuple(range(torch.cuda.device_count())))


def discover_topology(devices: Sequence) -> Optional[List[tuple]]:
    """Per-device physical coordinates, or None when the devices have
    none (ref :88-103). ``torch.device``s carry no ``.coords``, so for
    CUDA and CPU devices this is None and the allocator places by index."""
    coords = []
    for d in devices:
        c = getattr(d, "coords", None)
        if c is None or len(c) < 2:
            return None
        coords.append(tuple(int(v) for v in c))
    return coords if len(set(coords)) == len(coords) else None


class ChipAllocator:
    """Carves the node's devices into non-overlapping chip groups;
    thread-safe. ``allocate`` returns None when the request cannot be
    met: callers queue, retry or pack (the ``ServicesManager``)."""

    def __init__(self, n_chips: Optional[int] = None,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.device_type = dev.type
        if dist.is_initialized():
            # The global device list, as the reference's jax.devices()
            # after jax.distributed.initialize (ref :164-172).
            have = dist.device_count()
            if n_chips is None:
                n_chips = have
            elif n_chips > have:
                raise ValueError(f"{n_chips} chips asked for; this node "
                                 f"has {have} devices over "
                                 f"{dist.process_count()} processes")
        elif dev.type == "cuda":
            have = torch.cuda.device_count()
            if n_chips is None:
                n_chips = have
            elif n_chips > have:
                raise ValueError(f"{n_chips} chips asked for; this node "
                                 f"has {have} CUDA devices")
        elif n_chips is None:
            n_chips = 1
        if n_chips <= 0:
            raise ValueError("a chip allocator needs at least one chip")
        self.n_chips = n_chips
        self._lock = threading.Lock()
        # Co-ownership: each chip carries a list of owner names (shared
        # tenancy appends; exclusive placement needs an empty list).
        self._owners: List[List[str]] = [[] for _ in range(n_chips)]
        self._groups: Dict[str, ChipGroup] = {}

    def allocate(self, n: int, name: str, *, shared_ok: bool = False,
                 max_share: Optional[int] = None) -> Optional[ChipGroup]:
        """Allocate ``n`` contiguous chips; None when none fit.
        ``shared_ok`` adds the time-sliced tier: exclusive placement
        first, then ever more subscribed chips, one load tier at a time,
        up to ``max_share`` owners a chip (None: the environment's, else
        ``MAX_SHARE``)."""
        if n <= 0:
            raise ValueError("n must be positive")
        if max_share is None:
            try:
                max_share = int(os.environ.get(MAX_SHARE_ENV, MAX_SHARE))
            except ValueError:
                max_share = MAX_SHARE
        with self._lock:
            if name in self._groups:
                raise ValueError(
                    f"group {name!r} already holds chips; release it first")
            idx = None
            for cap in range(max_share if shared_ok else 1):
                allowed = {i for i, o in enumerate(self._owners)
                           if len(o) <= cap}
                if len(allowed) >= n:
                    idx = self._find_linear(n, allowed)
                if idx is not None:
                    break
            if idx is None:
                return None
            for j in idx:
                self._owners[j].append(name)
            group = ChipGroup(indices=idx, name=name,
                              device_type=self.device_type)
            self._groups[name] = group
            return group

    def _find_linear(self, n: int, allowed: set) -> Optional[tuple]:
        """First-fit contiguous index range."""
        run_start, run_len = None, 0
        for i in range(self.n_chips):
            if i in allowed:
                run_start = i if run_len == 0 else run_start
                run_len += 1
                if run_len == n:
                    return tuple(range(run_start, run_start + n))
            else:
                run_len = 0
        return None

    def release(self, name: str) -> None:
        with self._lock:
            group = self._groups.pop(name, None)
            if group:
                for i in group.indices:
                    if name in self._owners[i]:
                        self._owners[i].remove(name)

    @property
    def free_chips(self) -> int:
        with self._lock:
            return sum(1 for o in self._owners if not o)

    def utilization(self) -> float:
        return 1.0 - self.free_chips / self.n_chips
