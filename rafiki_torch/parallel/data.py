"""Data and tensor parallelism of a model family on its mesh.

What the reference's families get from ``batch_sharding`` and
``shard_variables`` inside one jitted step, in the port's single
controller (``mesh.py``): a batch's rows over ``dp``, one call per
data-parallel rank on that rank's device on the leaves it holds, and
the outputs gathered on the model's device, where the loss is the whole
batch's mean. The ranks' gradients add up in each leaf's ``.grad``
through the copies autograd carries back (``Placed``).

- ``port_spec`` is ``mesh.param_spec`` on the port's layouts: a leaf's
  flax name and shape come from the bridge (``bridge.jax_name``), the
  rule runs on them, and its split axis is mapped back. So ``tp``
  splits the output features of a ``Dense`` (the port's ``(out, in)``
  weight) and of a ``Conv`` (``(out, in, kh, kw)``), as the reference
  splits flax's ``(in, out)`` and ``(kh, kw, in, out)`` kernels.
- ``replica`` is one rank's shallow copy of a module tree on the leaves
  that rank holds. A kernel split over ``tp`` becomes its layer's
  ``tp_shards``: each tp rank computes its slice of the output features
  on its device and the slices are joined on the row's device
  (``layers.column``), the reference's all-gather of the activations.
  Any other split leaf is gathered whole. A layer that needs the whole
  batch's sums (``needs_dp_sum``: ``layers.BatchNorm``) gets ``dp_sum``
  and, on rank 0 alone (across processes, on each process's first
  rank), ``dp_writer``, the one rank that writes its running
  statistics.
- ``run_ranks`` runs the ranks' calls: one after the other, or, for a
  module whose layers sum over the ranks (``lockstep``), each in a
  thread of its own, meeting at every such sum, as
  ``torch.nn.DataParallel`` runs its replicas. A thread runs on the
  caller's current stream of each card and in its grad mode, so a
  capture or a side stream of the caller takes the ranks' work too.

Across processes (a mesh over the global device list, ``parallel.dist``)
every process runs the same step on its own dp ranks: ``mesh_apply``
runs the local ranks and joins the processes' outputs in row order
(``dist.gather_rows``); ``DpSum`` adds the local partials, then the
processes', all in rank order (``dist.ordered_sum``), so its value is
the one-process mesh's bit for bit; ``sum_grads`` sums the parameters'
gradients over the processes after the backward, where in one process
the ranks' copies add them up in each leaf's ``.grad``.
"""

from __future__ import annotations

import contextlib
import threading
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..model.bridge import jax_name
from . import dist
from .chips import ChipGroup
from .mesh import (DP_AXIS, TP_AXIS, Mesh, Placed, Sharding, Spec,
                   build_mesh, param_spec)


def group_mesh(device: torch.device, **axes: int) -> Mesh:
    """A model family's mesh: ``build_mesh`` over the devices of the
    group bound to the thread with ``axes`` (``sp``, ``tp``, ...), or
    over ``device`` alone when none is bound. The group's first device
    must be ``device``: the model's parameters, its loss and its staged
    labels live there."""
    group = ChipGroup.bound()
    devices = group.devices() if group is not None else [device]
    local = [d for d in devices if dist.is_local(d)]
    if not local:
        raise dist.NotAddressableError(
            f"the group {devices} holds no device of this process")
    if local[0] != device:
        raise ValueError(f"the model's device {device} is not its "
                         f"group's first, {local[0]}")
    return build_mesh(devices, **axes)


def gather_ranks(mesh: Mesh, blocks: Sequence[Tuple[int, int]],
                 local: torch.Tensor) -> torch.Tensor:
    """``local`` stacks this process's dp ranks' values, one a rank with
    rows in ``blocks``: on a mesh over several processes, every such
    rank's in rank order (``dist.gather_rows``), else ``local``."""
    if not mesh.spans_processes:
        return local
    counts = [0] * dist.process_count()
    for i, (lo, hi) in enumerate(blocks):
        counts[mesh.rank_owner(i)] += int(lo < hi)
    return dist.gather_rows(local, counts)


def sum_grads(mesh: Mesh, params) -> None:
    """After a backward on a mesh over several processes, sum the
    parameters' gradients over the processes (``dist.sum_grads``); a
    no-op on a mesh of one process."""
    if mesh.spans_processes:
        dist.sum_grads(params)


def rank_coord(i: int, t: int = 0) -> Tuple[int, ...]:
    """The mesh coordinate of dp rank ``i`` and tp rank ``t``."""
    return (i, 0, 0, 0, t)


def row_blocks(n: int, parts: int) -> List[Tuple[int, int]]:
    """``(lo, hi)`` of ``parts`` contiguous blocks of ``n`` rows, the
    first ``n % parts`` one row longer: equal blocks when ``parts``
    divides ``n`` (``mesh.batch_sharding``); a block may be empty."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


def _flax_layout(key: str, leaf: torch.Tensor):
    """``(flax name, permutation from the port's layout to flax's)``,
    or None for a leaf the bridge maps otherwise (an LSTM cell's)."""
    try:
        return jax_name(key, leaf.dim())
    except ValueError:
        return None


def port_spec(key: str, leaf: torch.Tensor, tp: int) -> Spec:
    """The placement rule of the port's leaf ``key`` (a ``state_dict``
    name): the reference's ``param_spec`` of its flax name and shape,
    the split axis mapped back to the port's layout."""
    layout = _flax_layout(key, leaf)
    if layout is None:
        return ()
    name, perm = layout
    shape = tuple(leaf.shape)
    flax_shape = shape if perm is None else tuple(shape[p] for p in perm)
    spec = param_spec(types.SimpleNamespace(shape=flax_shape), tp,
                      name=name.lower())
    if not spec or perm is None:
        return spec
    out: List[Optional[str]] = [None] * len(shape)
    for k, axis in enumerate(spec):
        out[perm[k]] = axis
    return tuple(out)


def place_leaves(named: Dict[str, torch.Tensor],
                 mesh: Mesh) -> Dict[str, Placed]:
    """Every leaf of ``named`` placed on ``mesh`` by ``port_spec``."""
    tp = mesh.shape[TP_AXIS]
    return {k: Sharding(mesh, port_spec(k, v, tp)).place(v)
            for k, v in named.items()}


def needs_lockstep(net: nn.Module) -> bool:
    """Whether a train-mode forward of ``net`` sums over the ranks: a
    layer of it asks for the whole batch's sums."""
    return net.training and any(getattr(m, "needs_dp_sum", False)
                                for m in net.modules())


def _is_kernel(key: str, leaf: torch.Tensor) -> bool:
    layout = _flax_layout(key, leaf)
    return layout is not None and layout[0].endswith("/kernel")


def replica(net: nn.Module, placed: Dict[str, Placed],
            coord: Sequence[int],
            dp_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
            ) -> nn.Module:
    """Rank ``coord``'s shallow copy of ``net``: each parameter the
    shard ``placed`` gives that coordinate (a kernel split over ``tp``
    its layer's ``tp_shards``, ``(device, weight, bias)`` a tp rank;
    another split leaf gathered whole), each buffer on the rank's device
    (rank 0's are ``net``'s own), and, on a layer that asks for it,
    ``dp_sum``. Names are ``net.named_parameters``'."""
    coord = tuple(coord)
    mesh = next(iter(placed.values())).mesh
    home = mesh.device(coord)
    tp = mesh.shape[TP_AXIS]
    tp_coords = [coord[:4] + (t,) for t in range(tp)]
    reps: Dict[int, nn.Module] = {}
    for name, mod in reversed(list(net.named_modules())):
        rep = mod._replicate_for_data_parallel()
        rep._modules = {k: (None if c is None else reps[id(c)])
                        for k, c in mod._modules.items()}
        prefix = f"{name}." if name else ""
        params = dict(mod._parameters)
        w = placed.get(prefix + "weight")
        if w is not None and TP_AXIS in w.spec and \
                _is_kernel(prefix + "weight", w.leaf):
            b = placed.get(prefix + "bias")
            shards = []
            for c in tp_coords:
                cols = w.index(c)[w.spec.index(TP_AXIS)]
                shards.append((mesh.device(c), w.at(c),
                               None if b is None else b.at(c)[cols]))
            rep.__dict__["tp_shards"] = shards
            params.pop("weight")
            params.pop("bias", None)
        for k, p in params.items():
            pl = None if p is None else placed[prefix + k]
            if pl is None:
                value = None
            elif TP_AXIS in pl.spec:
                value = torch.cat([pl.at(c).to(home, non_blocking=True)
                                   for c in tp_coords],
                                  dim=pl.spec.index(TP_AXIS))
            else:
                value = pl.at(coord)
            # A plain attribute (the replica has no parameters of its
            # own), set past nn.Module's __setattr__ checks.
            rep.__dict__[k] = value
        for k, buf in mod._buffers.items():
            if buf is not None:
                rep._buffers[k] = buf.to(home, non_blocking=True)
        if dp_sum is not None and getattr(mod, "needs_dp_sum", False):
            # The process's first rank writes the running statistics
            # (rank 0's buffers are the module's own).
            rep.__dict__.update(dp_sum=dp_sum,
                                dp_writer=coord[0] == mesh.local_ranks()[0])
        reps[id(mod)] = rep
    return reps[id(net)]


class DpSum:
    """The all-reduce of ``n`` ranks in lockstep: ``rank(i)`` is rank
    ``i``'s ``dp_sum``, which waits for every rank's partial and gives
    their sum in rank order on the caller's device, so every rank holds
    the same value. With ``cross``, the ``n`` ranks are this process's
    share of a mesh over several processes: local rank 0 adds every
    process's partials in rank order (``dist.ordered_sum``) and the
    local ranks read its total."""

    def __init__(self, n: int, cross: bool = False):
        self.slots: List[Optional[torch.Tensor]] = [None] * n
        self.barrier = threading.Barrier(n)
        self.cross = cross
        self.total: Optional[torch.Tensor] = None

    def rank(self, i: int) -> Callable[[torch.Tensor], torch.Tensor]:
        def dp_sum(t: torch.Tensor) -> torch.Tensor:
            self.slots[i] = t
            self.barrier.wait()
            if self.cross:
                if i == 0:
                    self.total = dist.ordered_sum(torch.stack(
                        [s.to(t.device, non_blocking=True)
                         for s in self.slots]))
                self.barrier.wait()
                total = self.total.to(t.device, non_blocking=True)
            else:
                total = None
                for s in self.slots:
                    s = s.to(t.device, non_blocking=True)
                    total = s if total is None else total + s
            # Every rank has read the slots before any writes again.
            self.barrier.wait()
            return total

        return dp_sum


def run_ranks(fns: Sequence[Callable[[], Any]],
              sync: Optional[DpSum] = None,
              devices: Sequence[torch.device] = ()) -> List[Any]:
    """Each of ``fns`` called once: in turn, or, with ``sync`` (the
    ranks' ``DpSum``), each in its own thread on the caller's current
    stream of each CUDA device of ``devices`` and in its grad mode. A
    rank that raises breaks the others' barrier; the first error is
    raised here."""
    if sync is None:
        return [fn() for fn in fns]
    grad = torch.is_grad_enabled()
    streams = [torch.cuda.current_stream(d) for d in dict.fromkeys(devices)
               if dist.is_local(d) and d.type == "cuda"]
    out: List[Any] = [None] * len(fns)
    errors: List[BaseException] = []

    def work(i: int) -> None:
        try:
            with torch.set_grad_enabled(grad), \
                    contextlib.ExitStack() as stack:
                for s in streams:
                    stack.enter_context(torch.cuda.stream(s))
                out[i] = fns[i]()
        except BaseException as e:  # noqa: B902  (raised in the caller)
            errors.append(e)
            sync.barrier.abort()

    threads = [threading.Thread(target=work, args=(i,), name=f"dp-rank-{i}")
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return out


def mesh_apply(mesh: Mesh, net: nn.Module, n: int,
               inputs: Callable[[torch.device, int, int], Tuple[Any, ...]],
               home: torch.device,
               replicas: Optional[List[nn.Module]] = None,
               kwargs: Optional[Callable[[torch.device],
                                         Dict[str, Any]]] = None
               ) -> torch.Tensor:
    """``net`` over ``n`` rows on ``mesh``'s dp ranks: rank ``i`` takes
    the rows ``row_blocks(n, dp)[i]``, its inputs ``inputs(device, lo,
    hi)`` made on its device, through its ``replica`` of ``net`` (built
    here on ``place_leaves`` of ``net``'s parameters, unless
    ``replicas`` are given: one a dp rank, None for another process's)
    with ``kwargs(device)``; the outputs are joined on ``home`` in row
    order. A rank without rows is skipped. A train-mode ``net`` whose
    layers sum over the ranks runs them in lockstep. On a mesh over
    several processes this process runs its own ranks and the outputs
    of every process are joined (``dist.gather_rows``)."""
    dp = mesh.shape[DP_AXIS]
    blocks = row_blocks(n, dp)
    ranks = mesh.local_ranks()
    cross = mesh.spans_processes
    lockstep = needs_lockstep(net)
    if lockstep and any(lo == hi for lo, hi in blocks):
        raise ValueError(f"{n} rows leave a rank of {dp} without rows")
    sync = DpSum(len(ranks), cross) if lockstep else None
    if replicas is None:
        placed = place_leaves(dict(net.named_parameters()), mesh)
        replicas = [None] * dp
        for j, i in enumerate(ranks):
            replicas[i] = replica(net, placed, rank_coord(i),
                                  None if sync is None else sync.rank(j))
    fns = []
    for i in ranks:
        lo, hi = blocks[i]
        if lo == hi:
            continue
        dev = mesh.device(rank_coord(i))

        def fn(i=i, lo=lo, hi=hi, dev=dev):
            kw = kwargs(dev) if kwargs is not None else {}
            return replicas[i](*inputs(dev, lo, hi), **kw).to(
                home, non_blocking=True)

        fns.append(fn)
    outs = run_ranks(fns, sync, list(mesh.devices.flat))
    mine = torch.cat(outs) if len(outs) > 1 else outs[0]
    if not cross:
        return mine
    counts = [0] * dist.process_count()
    for i, (lo, hi) in enumerate(blocks):
        counts[mesh.rank_owner(i)] += hi - lo
    return dist.gather_rows(mine, counts)
