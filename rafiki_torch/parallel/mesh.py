"""Meshes and placement rules for a trial's devices.

The counterpart of ``rafiki_tpu/parallel/mesh.py``. A trial's devices
form a mesh with the axes ``("dp", "pp", "ep", "sp", "tp")``: the batch
over ``dp``, GPipe stages over ``pp`` (``ops.pipeline``), slices of an
expert stack over ``ep`` (``ops.moe``), sequence shards over ``sp``
(``ops.attention.ring_attention`` and ``ulysses_attention``), and large
kernels' output features over ``tp``.

In one process the port has one controller, as the reference has. A
mesh is an object array of ``torch.device``s; a placed tensor
is its per-coordinate shards (``Placed``), each on its mesh device; a
collective is a copy between mesh devices (``Tensor.to``, which autograd
carries back). A replicated leaf stays one tensor: each coordinate's
copy of it is a ``.to(device)`` of it, so the ranks' gradients add up
in the leaf's ``.grad``, the psum over ``dp``.

A mesh may name one device more than once, the counterpart of the
reference tests' virtual devices: on one card, ``build_mesh([cuda:0] *
4, sp=2)`` runs two data-parallel pairs of sequence shards. There,
``.to`` returns the tensor itself, and nothing writes in place to a
shard another rank reads.

In a node over several processes (``parallel.dist``) a mesh is built
over entries of the global device list: another process's entry is a
``dist.RemoteDevice``. Every process builds the same mesh and runs the
same step, each on its local coordinates (``Mesh.local_ranks``); a
``Placed`` cuts only local coordinates. Only ``dp`` may cross
processes: each dp rank's (pp, ep, sp, tp) block must lie in one
process, in process order (``dist.CrossProcessAxisError`` otherwise,
ROADMAP queue 1 item 8 (e)).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dist

DP_AXIS = "dp"
PP_AXIS = "pp"
EP_AXIS = "ep"
SP_AXIS = "sp"
TP_AXIS = "tp"
AXES = (DP_AXIS, PP_AXIS, EP_AXIS, SP_AXIS, TP_AXIS)

# Kernels smaller than this are cheaper to replicate than to shard+gather.
_TP_MIN_FEATURES = 256

#: A placement rule: one entry a dimension of the leaf, the mesh axis it
#: is split over or None (``()`` replicates), the reference's
#: ``PartitionSpec``.
Spec = Tuple[Optional[str], ...]


class Mesh:
    """Devices arranged over ``AXES``: ``devices`` is the object array,
    ``shape`` maps each axis to its size."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, coord: Sequence[int]) -> Any:
        """The device at ``coord``, one index an axis of ``AXES``: a
        ``torch.device``, or another process's ``dist.RemoteDevice``."""
        return self.devices[tuple(coord)]

    def distinct(self) -> int:
        """How many distinct devices the mesh's entries name."""
        return len(set(self.devices.flat))

    @property
    def spans_processes(self) -> bool:
        """Whether some entry is another process's."""
        return any(not dist.is_local(d) for d in self.devices.flat)

    def rank_owner(self, i: int) -> int:
        """The process that dp rank ``i``'s block lies on."""
        return dist.owner(self.devices[i].flat[0])

    def local_ranks(self) -> List[int]:
        """The dp ranks whose blocks lie on this process: all of them in
        one process."""
        return [i for i in range(self.shape[DP_AXIS])
                if dist.is_local(self.devices[i].flat[0])]

    def process_ranks(self) -> List[int]:
        """How many dp ranks each process holds, in process order."""
        counts = [0] * dist.process_count()
        for i in range(self.shape[DP_AXIS]):
            counts[self.rank_owner(i)] += 1
        return counts

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}"
                f"; {self.distinct()} distinct of {self.size})")


# Interned meshes, one for each (devices, tp, sp, ep, pp), as the
# reference interns them for its compiled-step cache.
_MESH_CACHE: dict = {}


def build_mesh(devices: Sequence[Any], tp: int = 1, sp: int = 1, ep: int = 1,
               pp: int = 1) -> Mesh:
    """Arrange ``devices`` into a (dp, pp, ep, sp, tp) mesh;
    dp = n / (pp * ep * sp * tp). ``tp`` varies fastest, then ``sp``
    (ring neighbours are adjacent in device order), then ``ep`` and
    ``pp`` (ref :44-71)."""
    devices = [d if isinstance(d, dist.RemoteDevice) else torch.device(d)
               for d in devices]
    n = len(devices)
    if n == 0 or n % (tp * sp * ep * pp) != 0:
        raise ValueError(f"{n} devices not divisible by pp*ep*sp*tp="
                         f"{pp * ep * sp * tp}")
    key = (tuple(devices), tp, sp, ep, pp)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        arr = np.empty(n, dtype=object)
        arr[:] = devices
        mesh = Mesh(arr.reshape(n // (pp * ep * sp * tp), pp, ep, sp, tp))
        if mesh.spans_processes:
            _check_processes(mesh, dict(tp=tp, sp=sp, ep=ep, pp=pp))
        _MESH_CACHE[key] = mesh
    return mesh


def _check_processes(mesh: Mesh, axes: Dict[str, int]) -> None:
    """A mesh over several processes: each dp rank's block in one
    process, the ranks in process order, as many on each process."""
    owners = []
    for i in range(mesh.shape[DP_AXIS]):
        block = {dist.owner(d) for d in mesh.devices[i].flat}
        if len(block) > 1:
            crossing = [a for a, k in axes.items() if k > 1]
            raise dist.CrossProcessAxisError(
                f"the mesh's {'/'.join(crossing)} axis would cross "
                f"processes {sorted(block)}: only dp spans processes "
                "(sp, ep, pp and tp across processes are ROADMAP queue 1 "
                "item 8 (e))")
        owners.append(block.pop())
    if owners != sorted(owners) or len(set(mesh.process_ranks())) != 1:
        raise ValueError(f"dp ranks on processes {owners}: a mesh over "
                         "several processes takes the same number of dp "
                         "ranks from each, in process order")


class Placed:
    """A leaf placed on a mesh by ``spec``: ``at(coord)`` is the shard
    that ``coord`` holds, on its device. Shards are cut and copied on
    first use and kept, a copy a (slice, device)."""

    def __init__(self, leaf: torch.Tensor, mesh: Mesh, spec: Spec):
        self.leaf, self.mesh, self.spec = leaf, mesh, spec
        self._shards: Dict[Any, torch.Tensor] = {}

    def index(self, coord: Sequence[int]) -> Tuple[slice, ...]:
        """The slice of the leaf that ``coord`` holds."""
        out = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            size = self.leaf.shape[dim] // n
            i = coord[AXES.index(axis)]
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def at(self, coord: Sequence[int]) -> torch.Tensor:
        idx = self.index(coord)
        dev = self.mesh.device(coord)
        if not dist.is_local(dev):
            raise dist.NotAddressableError(
                f"coordinate {tuple(coord)} lies on {dev}: a process cuts "
                "only its own coordinates")
        key = (tuple((s.start, s.stop) for s in idx), dev)
        shard = self._shards.get(key)
        if shard is None:
            shard = self.leaf[idx] if idx else self.leaf
            shard = shard.to(dev, non_blocking=True)
            self._shards[key] = shard
        return shard


class Sharding:
    """A placement descriptor: ``spec`` on ``mesh`` (the reference's
    ``NamedSharding``); ``place`` applies it to a tensor."""

    def __init__(self, mesh: Mesh, spec: Spec = ()):
        self.mesh, self.spec = mesh, tuple(spec)

    def place(self, leaf: torch.Tensor) -> Placed:
        return Placed(leaf, self.mesh, self.spec)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, Sharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis batch sharding over dp (tp replicates the batch)."""
    return Sharding(mesh, (DP_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def param_spec(arr: Any, tp: int, ep: int = 1, name: str = "",
               pp: int = 1) -> Spec:
    """The placement rule of one parameter (ref :85-115): a leaf whose
    name holds ``stage`` with a leading axis of ``pp`` splits it over
    ``pp``, and a stage-stacked ``expert`` leaf its second axis over
    ``ep`` too; an ``expert`` leaf with a leading axis divisible by
    ``ep`` splits it over ``ep``; a kernel whose output features are a
    multiple of ``tp`` and at least ``_TP_MIN_FEATURES`` splits them
    over ``tp``. Everything else replicates (``()``)."""
    shape = tuple(getattr(arr, "shape", ()))
    if pp > 1 and "stage" in name and shape and shape[0] == pp:
        if ep > 1 and "expert" in name and len(shape) > 1 \
                and shape[1] % ep == 0:
            return (PP_AXIS, EP_AXIS) + (None,) * (len(shape) - 2)
        return (PP_AXIS,) + (None,) * (len(shape) - 1)
    if ep > 1 and "expert" in name and shape and shape[0] % ep == 0:
        return (EP_AXIS,) + (None,) * (len(shape) - 1)
    if tp <= 1 or len(shape) < 2:
        return ()
    out_features = shape[-1]
    if out_features % tp == 0 and out_features >= _TP_MIN_FEATURES:
        return (None,) * (len(shape) - 1) + (TP_AXIS,)
    return ()


def _map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                   path: Tuple[str, ...] = ()) -> Any:
    """``fn(name, leaf)`` over the leaves of nested dicts, lists and
    tuples; ``name`` is the path's keys joined by ``/``, lower-cased."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path).lower(), tree)


def variables_shardings(variables: Any, mesh: Mesh) -> Any:
    """The ``Sharding`` of every leaf of ``variables`` by
    ``param_spec``."""
    tp, ep, pp = (mesh.shape[a] for a in (TP_AXIS, EP_AXIS, PP_AXIS))
    return _map_with_path(
        lambda name, leaf: Sharding(mesh, param_spec(leaf, tp, ep=ep,
                                                     name=name, pp=pp)),
        variables)


def shard_variables(variables: Any, mesh: Mesh) -> Any:
    """``variables`` with every leaf ``Placed`` by ``param_spec``."""
    tp, ep, pp = (mesh.shape[a] for a in (TP_AXIS, EP_AXIS, PP_AXIS))
    return _map_with_path(
        lambda name, leaf: Sharding(mesh, param_spec(
            leaf, tp, ep=ep, name=name, pp=pp)).place(leaf), variables)
