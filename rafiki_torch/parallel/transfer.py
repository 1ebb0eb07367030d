"""Packed device-to-host reads and pinned host-to-device staging.

The counterpart of ``rafiki_tpu/parallel/transfer.py``:

- ``device_get_tree`` reads a whole tree of tensors back in one copy a
  (device, dtype) group: one ``torch.cat`` of the group's leaves on the
  device, one readback, then a split on the host. The plan (which leaves
  form which group) is cached by the tree's structure, which leaves are
  tensors, and their shapes and dtypes (ref :53-59), so two trees with
  the same structure but another mix of tensor and host leaves never
  share a plan. numpy has no bfloat16, so a bfloat16 group is read back
  as float32.
- ``HostStager`` keeps reusable host staging buffers, pinned on the card
  (``torch.empty(..., pin_memory=True)`` viewed as numpy), so a copy to
  the device is asynchronous; ``make_host_stager`` (ref :91-118) is its
  ``stage`` and mode, ``"pinned"`` on the card and ``"pageable"`` on the
  CPU. The inference worker stages its packed bursts in one and reports
  the mode as its registration's ``staging``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

_PACK_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_PACK_CACHE_MAX = 32


def _host_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def device_get_tree(tree: Any) -> Any:
    """A tree of tensors -> the same tree of numpy arrays, in one readback
    a (device, dtype) group; leaves that are not tensors pass through
    ``np.asarray``."""
    leaves, spec = pytree.tree_flatten(tree)
    if not leaves:
        return tree
    dev_idx = [i for i, leaf in enumerate(leaves)
               if isinstance(leaf, torch.Tensor)]
    if not dev_idx:
        return pytree.tree_unflatten([np.asarray(x) for x in leaves], spec)
    sig = tuple((tuple(leaves[i].shape), leaves[i].dtype, leaves[i].device)
                for i in dev_idx)
    key = (str(spec), tuple(dev_idx), sig)
    groups = _PACK_CACHE.get(key)
    if groups is None:
        groups = {}
        for i in dev_idx:
            groups.setdefault((leaves[i].device, leaves[i].dtype),
                              []).append(i)
        _PACK_CACHE[key] = groups
        while len(_PACK_CACHE) > _PACK_CACHE_MAX:
            _PACK_CACHE.popitem(last=False)
    _PACK_CACHE.move_to_end(key)
    dev_set = set(dev_idx)
    out: List[Any] = [None if i in dev_set else np.asarray(leaf)
                      for i, leaf in enumerate(leaves)]
    for (_, dtype), idxs in groups.items():
        with torch.no_grad():
            packed = torch.cat([leaves[i].detach().reshape(-1)
                                for i in idxs])
            flat = packed.to("cpu", _host_dtype(dtype)).numpy()
        offset = 0
        for i in idxs:
            shape: Tuple[int, ...] = tuple(leaves[i].shape)
            n = int(np.prod(shape)) if shape else 1
            out[i] = flat[offset:offset + n].reshape(shape)
            offset += n
    return pytree.tree_unflatten(out, spec)


class HostStager:
    """Reusable host staging buffers, two a ``(bucket, shape, dtype)``,
    made on first use and kept (buckets are a power-of-two ladder). On
    the card they are pinned and viewed as numpy; rows past a burst's
    count keep stale bytes, whose outputs are sliced away.

    ``buffer`` hands out the two in turn, which is enough for a caller
    that reads each use's results back before the use after next (the
    inference worker's bursts). ``stage`` copies an array through the
    next buffer to the device and waits, before it refills a buffer, for
    that buffer's last copy to finish."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        #: ``pinned`` or ``pageable``.
        self.mode = "pinned" if self.pinned else "pageable"
        self._bufs: Dict[Any, list] = {}

    def _new(self, bucket: int, shape: tuple, dtype) -> np.ndarray:
        if not self.pinned:
            return np.empty((bucket, *shape), dtype)
        t = torch.empty((bucket, *shape),
                        dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                        pin_memory=True)
        return t.numpy()

    def _entry(self, bucket: int, shape: tuple, dtype) -> list:
        key = (bucket, tuple(shape), np.dtype(dtype).str)
        entry = self._bufs.get(key)
        if entry is None:
            entry = [self._new(bucket, shape, dtype),
                     self._new(bucket, shape, dtype), 0, [None, None]]
            self._bufs[key] = entry
        entry[2] ^= 1
        return entry

    def buffer(self, bucket: int, shape: tuple, dtype) -> np.ndarray:
        entry = self._entry(bucket, shape, dtype)
        return entry[entry[2]]

    def stage(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the device, through a staging buffer."""
        arr = np.asarray(arr)
        if not self.pinned:
            return torch.from_numpy(np.array(arr, copy=True)).to(self.device)
        rows = arr.reshape(1, *arr.shape) if arr.ndim == 0 else arr
        entry = self._entry(rows.shape[0], rows.shape[1:], rows.dtype)
        slot = entry[2]
        if entry[3][slot] is not None:
            entry[3][slot].synchronize()
        buf = entry[slot]
        buf[...] = rows
        out = torch.from_numpy(buf).to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        entry[3][slot] = ev
        return out.reshape(arr.shape)


def make_host_stager(device) -> Tuple[Callable[[np.ndarray], torch.Tensor],
                                      str]:
    """``(stage, mode)`` for small per-step uploads to ``device``:
    ``stage(np_array)`` puts the array there, through a pinned buffer on
    the card (``mode`` ``"pinned"``) or a plain copy on the CPU
    (``"pageable"``)."""
    stager = HostStager(device)
    return stager.stage, stager.mode
