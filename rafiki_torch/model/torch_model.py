"""TorchModel: the PyTorch path of the BaseModel contract for image
classifiers.

The counterpart of ``JaxModel`` (``rafiki_tpu/model/jax_model.py:327``).
Zoo models declare a module (``create_module``) and knobs; this class
trains, evaluates, serves and (de)serialises it as the reference does:

- ``train`` (ref :476-813) stages the whole uint8 dataset on the device
  once, through the staging cache below; each step gathers its batch
  there by index and normalises it (``/255``), so the host sends index
  tensors, never images. A set of more than ``RAFIKI_TPU_STAGE_BYTES``
  image bytes (read per call) goes to the device a chunk at a time
  instead (ref :735-751): each chunk's rows, in the epoch's order, are
  copied into one fixed device buffer that the steps index with
  identity tables, so the captured step stays valid and both paths feed
  it the same rows in the same order. The host gathers the next chunk
  while the device runs this one's steps (``_ChunkLoader``). Each
  epoch's order is ``epoch_rng(seed, epoch).permutation(size)``, wrapped
  with ``np.resize`` when the set is smaller than one epoch's steps. The
  loss is f32 softmax cross-entropy on f32-cast logits; loss and train
  accuracy stay on the device and are read back once per chunk of up to
  128 steps; one ``logger.log`` record per epoch carries ``epoch``,
  ``loss``, ``train_acc``, ``steps_per_sec`` and, on the card,
  ``chip_util`` (analytic FLOPs of the module's convolutions and dense
  layers over the card's peak, ``observe.device_peak_flops``), which
  is also the ``rafiki_tpu_train_mfu_ratio`` gauge, set each epoch
  under the caller's bound labels beside the
  ``rafiki_tpu_train_step_seconds`` histogram (ref :676-688, :775-778);
  the dataset's ``load`` and ``stage`` are timed as trial phases
  (``observe.phases``). ``augment_in_graph(x, step)``
  augments each normalised batch on the device (identity by default;
  the conv zoo's ``pad_crop_flip``, ref :231-257). The module runs in
  train mode, so a BatchNorm's running statistics update in place, in
  the captured graph too; ``evaluate`` and ``predict`` run it in eval
  mode, on the running statistics (ref :518-581). The batch is capped at
  the dataset's size and rounded down to a multiple of the mesh's dp, at
  least dp (ref :486-488). On the card the step is captured once as a
  CUDA graph and replayed (``_TrainSteps``), the counterpart of the
  reference's many steps per compiled dispatch; over a mesh of distinct
  cards every step runs eagerly. The lr schedule spans
  ``schedule_total_epochs`` when a caller gives more than the run's
  ``max_epochs``, and ``checkpoint_dir`` turns on checkpoint resume
  (ref :693-712, :790-870; ``loop_ckpt.LoopCheckpointer``, with the
  early-stop counters beside the state).
- The mesh (ref :460-466): ``mesh`` is built from the group bound to
  the thread, ``tensor_parallel`` devices a data-parallel rank, or from
  the model's device alone when none is bound. With more than one entry,
  each dp rank gathers, normalises and augments its own rows of the step
  on its device (the staged set is on each distinct device once) and
  runs its replica of the module on the leaves it holds
  (``parallel.data``: kernels over ``tp`` column-parallel, BatchNorm over
  the whole batch); the logits are gathered on the model's device, the
  loss is the whole batch's mean, and one optimizer update follows, the
  ranks' gradients summed in each leaf's ``.grad``.
- ``evaluate`` (ref :890-991): argmax accuracy over the staged set in
  dp-aligned batches of up to 1024, the last one padded, their rows
  over the dp ranks; a set over ``RAFIKI_TPU_STAGE_BYTES`` ships each
  batch from the host instead.
- The device staging cache (ref :96-215): ``staged_dataset_arrays``
  and ``staged_token_ids`` keep a set's uint8 images and int32 labels,
  or its int32 token stream, on the device across trials, in a
  byte-budget LRU (``RAFIKI_TPU_STAGE_CACHE_BYTES``, read per call; 0
  disables it) keyed by the fingerprint the set was loaded under and
  the device, or the distinct devices a mesh names
  (``staged_mesh_arrays``: the images once on each, the labels on the
  first; a mesh on one card shares the card's entry). An entry is a copy made by a blocking transfer before it
  is cached: never a view of the host cache's read-only arrays (on the
  CPU ``torch.from_numpy`` would alias them), and never half copied
  when another thread takes it. Nothing writes a staged tensor: the
  steps gather from it into new tensors. A train call keeps its own
  reference for the trial's life, so an eviction only drops the
  cache's.
- ``predict`` / ``predict_submit`` / ``predict_proba`` (ref :994-1070):
  a 2-D query gains a channel axis and a shape mismatch raises
  ``ValueError``; all-uint8 batches go to the device as uint8 and are
  normalised there, float queries are taken as already normalised; the
  output is an f32 softmax; queries go in chunks of
  ``max_predict_batch``, each zero-padded to its bucket.
- Bucketed and staged predict (ref :1070-1220): ``predict_bucket(n,
  dtype)`` is the first of dp, 2·dp, 4·dp … at or above ``n``, its rows
  over the dp ranks, and ``predict_staged_submit(buf, n)``
  serves a burst from a caller's staging buffer whose leading dim is
  exactly that bucket. Each ``(bucket, is_u8, quant)`` has its runner
  (``_dispatch_bucket``): on the card a CUDA graph on a static input,
  every runner of a model in one memory pool, a replay bit for bit the
  eager forward; on the CPU, and over distinct cards, the same forward,
  eagerly. Under serving quantisation the int8 tensors are replicated on
  every rank (ref :1304-1309).
- Serving quantisation (ref :1222-1326): ``enable_serving_quant("int8")``
  makes every floating 2-D and 4-D ``kernel`` of the reference's flat
  layout int8 with per-output-channel scales, byte for byte the
  reference's. A model's ``quantized_apply`` may serve from them with
  ``dynamic_int8_matmul``; the default (None) dequantises them in the
  graph and runs the module unchanged.
- Stacked ensembles (ref :1328-1745): ``stack_signature`` and
  ``module_config`` say which members may stack; ``stack_members`` and
  ``StackedMembers`` live in ``stacked.py`` and are re-exported here.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..observe import MfuMeter, metrics
from ..observe import phases as _phases
from ..parallel.data import (group_mesh, mesh_apply, place_leaves,
                             rank_coord, replica, row_blocks)
from ..parallel.mesh import Mesh
from ..torchenv import (DeviceLike, graph_capture, resolve_device,
                        side_stream)
from ..utils.hashing import M32, mix32
from .base import BaseModel, Params
from .bridge import (dense_from_jax, dense_from_jax_tensors, dense_to_jax,
                     overlay_params)
from .dataset import (ByteBudgetLRU, ImageDataset, dataset_fingerprint,
                      env_bytes, load_image_dataset)
from .logger import logger
from .loop_ckpt import (LoopCheckpointer, TrainState, epoch_rng,
                        schedule_epochs)
from .optim import ScheduledOptimizer, scheduled_adam

#: Steps per device round trip of the train loop (ref :666).
CHUNK_STEPS = 128
#: Rows per evaluation batch (ref :904).
EVAL_BATCH = 1024
#: Eager train steps on the card before the step is captured.
WARMUP_STEPS = 3

#: A set of more image bytes than this is staged a chunk at a time
#: (ref :636-647; ``NodeConfig.stage_bytes``, read per call).
STAGE_BYTES_ENV = "RAFIKI_TPU_STAGE_BYTES"
STAGE_BYTES_DEFAULT = 2 << 30  # keep NodeConfig.stage_bytes equal

STAGE_CACHE_ENV = "RAFIKI_TPU_STAGE_CACHE_BYTES"
STAGE_CACHE_DEFAULT = 2 << 30  # keep NodeConfig.stage_cache_bytes equal

#: key -> (images, labels) or (ids,), on the device.
_STAGE_CACHE = ByteBudgetLRU("stage")


def stage_bytes_limit() -> int:
    """The image bytes over which a set is staged a chunk at a time."""
    return env_bytes(STAGE_BYTES_ENV, STAGE_BYTES_DEFAULT)


def stage_cache_budget() -> int:
    """The device staging cache's byte budget (0 disables it)."""
    return env_bytes(STAGE_CACHE_ENV, STAGE_CACHE_DEFAULT)


def clear_stage_cache() -> None:
    _STAGE_CACHE.clear()


def stage_cache_info() -> Dict[str, int]:
    return _STAGE_CACHE.info()


def _where_key(where: Any) -> Tuple[Tuple[str, Optional[int]], ...]:
    """The (type, index) of a device, or of each distinct device a mesh
    names (``mesh_devices``): a card standing for 4 entries holds the
    same tensors as the card alone, so both share one entry."""
    devs = mesh_devices(where) if isinstance(where, Mesh) else [where]
    return tuple((d.type, d.index) for d in devs)


def _stage_key(dataset_path: str, ds: Any, where: Any,
               nbytes: int, budget: int, *tag: str) -> Any:
    """The staging cache's key, or None when the entry is not to be
    cached: the budget is 0 or too small, or the file is gone. The
    fingerprint is the one the set was loaded under (a set made in
    memory takes the file's current one); ``where`` is a device or a
    mesh (``_where_key``: its distinct devices), where the reference
    has the mesh's device ids (ref :160, :204)."""
    if budget <= 0 or nbytes > budget:
        return None
    fp = getattr(ds, "fingerprint", None)
    if fp is None:
        try:
            fp = dataset_fingerprint(dataset_path)
        except OSError:
            return None  # the file vanished after the load
    return (*tag, fp, _where_key(where))


def _staged(dataset_path: str, ds: Any, where: Any,
            nbytes: int, make: Callable[[], Tuple[torch.Tensor, ...]],
            *tag: str) -> Tuple[torch.Tensor, ...]:
    """The cache's entry for ``ds`` on ``where`` (a device or a mesh),
    or ``make()``'s, cached when the budget holds its ``nbytes``."""
    budget = stage_cache_budget()
    key = _stage_key(dataset_path, ds, where, nbytes, budget, *tag)
    if key is not None:
        entry = _STAGE_CACHE.get(key)
        if entry is not None:
            _phases.cache_event("stage", "hit")
            return entry
        _phases.cache_event("stage", "miss")
    entry = make()
    if key is not None:
        _STAGE_CACHE.put(key, entry, nbytes, budget)
    return entry


def staged_dataset_arrays(dataset_path: str, ds: ImageDataset,
                          device: DeviceLike = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(uint8 images, int32 labels)`` of ``ds`` on ``device``, cached
    across trials (ref :137-174): trials 2..N of a sub-train job copy
    nothing. ``train`` and ``evaluate`` share the entry."""
    device = resolve_device(device)
    # torch.tensor copies, blocking: on the card the entry is whole
    # before it is cached, and on the CPU it never aliases ds's arrays.
    return _staged(
        dataset_path, ds, device,
        int(ds.images.nbytes) + 4 * int(ds.labels.shape[0]),
        lambda: (torch.tensor(ds.images, device=device),
                 torch.tensor(ds.labels.astype(np.int32), device=device)))


def mesh_devices(mesh: Mesh) -> List[torch.device]:
    """The distinct devices a mesh's entries name, in entry order."""
    return list(dict.fromkeys(mesh.devices.flat))


def staged_mesh_arrays(dataset_path: str, ds: ImageDataset, mesh: Mesh
                       ) -> Tuple[Dict[torch.device, torch.Tensor],
                                  torch.Tensor]:
    """``staged_dataset_arrays`` on a mesh (ref :137-174): the uint8
    images once on each distinct device its entries name and the int32
    labels on the first (the model's), in one cache entry keyed on
    those devices (ref :160). A mesh on one card shares the card's own
    entry. ``({device: images}, labels)``."""
    devs = mesh_devices(mesh)
    if len(devs) == 1:
        images, labels = staged_dataset_arrays(dataset_path, ds, devs[0])
        return {devs[0]: images}, labels
    entry = _staged(
        dataset_path, ds, mesh,
        int(ds.images.nbytes) * len(devs) + 4 * int(ds.labels.shape[0]),
        lambda: (*(torch.tensor(ds.images, device=d) for d in devs),
                 torch.tensor(ds.labels.astype(np.int32), device=devs[0])))
    return dict(zip(devs, entry[:-1])), entry[-1]


def staged_token_ids(dataset_path: str, ds: Any,
                     device: DeviceLike = None) -> torch.Tensor:
    """A token set's int32 id stream on ``device``, in the same cache
    and under the same ``stage`` counters as the image arrays, its key
    tagged ``"token"`` (ref :177-215): the LM's evaluations 2..N gather
    their windows from it on the device and copy no ids."""
    device = resolve_device(device)
    ids = ds.ids if ds.ids.dtype == np.int32 else ds.ids.astype(np.int32)
    return _staged(dataset_path, ds, device, int(ids.nbytes),
                   lambda: (torch.tensor(ids, device=device),),
                   "token")[0]


def _reflect(p: torch.Tensor, n: int) -> torch.Tensor:
    """Index into a length-``n`` axis of a coordinate ``p`` of its
    reflect padding (numpy's ``mode="reflect"``: the edge is not
    repeated), for ``-n < p < 2n - 1``."""
    p = p.abs()
    return torch.where(p >= n, 2 * (n - 1) - p, p)


def crop_flip(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
              flip: torch.Tensor, pad: int = 4) -> torch.Tensor:
    """(B, H, W, C) images -> each reflect-padded by ``pad``, cropped
    back to H × W at offset (``ys``, ``xs``) of the padded image, and
    flipped horizontally where ``flip``: what ``pad_crop_flip_graph``
    (ref :231-257) computes from its draws, as one gather."""
    b, h, w, _ = x.shape
    i = torch.arange(h, device=x.device)
    j = torch.arange(w, device=x.device)
    rows = _reflect(ys[:, None] + i - pad, h)
    jj = torch.where(flip[:, None], w - 1 - j, j)
    cols = _reflect(xs[:, None] + jj - pad, w)
    bi = torch.arange(b, device=x.device)
    return x[bi[:, None, None], rows[:, :, None], cols[:, None, :]]


def crop_flip_draw(seed: int, step: torch.Tensor, b: int, pad: int = 4,
                   row0: int = 0):
    """Row offsets, column offsets (each in [0, 2·pad]) and flips (p =
    0.5) of the ``b`` rows from row ``row0`` of train step ``step`` (a
    device int64 scalar): a hash of (``seed``, ``step``, row), so no
    generator state is read, a captured step draws anew at every replay,
    eager steps and replays draw the same, and a data-parallel rank
    draws its rows' share of the whole batch's draws. The draws are not
    ``jax.random``'s."""
    rows = torch.arange(row0, row0 + b, device=step.device)
    h = mix32(mix32(torch.full_like(step, seed & M32)) ^ (step & M32))
    h = mix32(h ^ rows)
    span = 2 * pad + 1
    return (mix32(h ^ 1) % span, mix32(h ^ 2) % span,
            (mix32(h ^ 3) & 1).bool())


def pad_crop_flip(x: torch.Tensor, seed: int, step: torch.Tensor,
                  pad: int = 4, min_size: int = 16,
                  row0: int = 0) -> torch.Tensor:
    """The CIFAR recipe on the device: reflect-pad ``pad``, a random
    crop back to H × W and a horizontal flip with p = 0.5, drawn by
    ``crop_flip_draw`` for the batch's rows from ``row0``. Images
    smaller than ``min_size`` pass through, as in the reference."""
    b, h, w, _ = x.shape
    if min(h, w) < min_size:
        return x
    ys, xs, flip = crop_flip_draw(seed, step, b, pad, row0)
    return crop_flip(x, ys, xs, flip, pad)


def _es_arrays(best_loss: float, bad_epochs: int) -> Dict[str, np.ndarray]:
    """The early-stop counters saved beside the state (ref :815-832)."""
    return {"es_best_loss": np.asarray(best_loss, np.float64),
            "es_bad_epochs": np.asarray(bad_epochs, np.int64)}


class _TrainSteps:
    """The optimizer steps of one ``train`` call.

    A step reads its batch's indices from this epoch's index table (one
    host-to-device copy an epoch) at a device row counter, gathers and
    normalises the batch on the device (``data`` and ``labels`` are
    only read: the gather makes new tensors; the int32 labels become
    int64 there, for the loss), and adds its loss and train
    accuracy to device sums that the host reads once per chunk. On the
    CPU every step runs eagerly. On the card the first ``WARMUP_STEPS``
    run eagerly on a side stream (the optimizer's state and the
    libraries' workspaces are created in them); then the step is
    captured once as a CUDA graph, whose replays run the same kernels on
    the same buffers with the lr read on the device
    (``ScheduledOptimizer.device_step``): eager PyTorch would spend
    about 50 launches through Python on every step of these small
    layers, and the card would wait on the host.
    """

    def __init__(self, model: "TorchModel", net: nn.Module,
                 opt: ScheduledOptimizer, data: torch.Tensor,
                 labels: torch.Tensor, steps_per_epoch: int,
                 batch_size: int,
                 images: Optional[Dict[torch.device, torch.Tensor]] = None):
        dev = model.device
        self.model, self.net, self.opt = model, net, opt
        self.labels = labels
        # The images on each device of the mesh; ``data`` is the model's.
        self.images = images if images is not None else {dev: data}
        self.order = torch.zeros((steps_per_epoch, batch_size),
                                 dtype=torch.int64, device=dev)
        self.row = torch.zeros((), dtype=torch.int64, device=dev)
        self.step_no = torch.zeros((), dtype=torch.int64, device=dev)
        self.sums = torch.zeros(2, dtype=torch.float32, device=dev)
        # Captured when every mesh entry is this card; over distinct
        # cards every step runs eagerly.
        self.on_card = dev.type == "cuda" and model.mesh.distinct() == 1
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.n_eager = 0

    def new_epoch(self, order: np.ndarray) -> None:
        self.order.copy_(torch.from_numpy(np.ascontiguousarray(order)))
        self.row.zero_()

    def _forward_backward(self) -> None:
        sel = self.order.index_select(0, self.row.view(1)).view(-1)
        y = self.labels[sel].long()
        logits = self.model._train_logits(self.net, self.images, sel,
                                          self.step_no).float()
        loss = F.cross_entropy(logits, y)
        loss.backward()
        acc = (logits.detach().argmax(-1) == y).float().mean()
        self.sums.add_(torch.stack([loss.detach(), acc]))
        self.row.add_(1)
        self.step_no.add_(1)

    def _eager(self) -> None:
        self.opt.zero_grad()
        self._forward_backward()
        self.opt.step()
        self.n_eager += 1

    def step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        elif not self.on_card:
            self._eager()
        elif self.n_eager < WARMUP_STEPS:
            with side_stream(self.model.device):
                self._eager()
        else:
            # Gradients set to None before the capture: the captured
            # backward allocates them in the graph's pool and every
            # replay overwrites them.
            self.opt.zero_grad()
            self.graph = torch.cuda.CUDAGraph()
            with graph_capture(self.graph):
                self._forward_backward()
                self.opt.device_step()
            self.graph.replay()

    def read_means(self, k: int) -> np.ndarray:
        """The mean loss and train accuracy of the last ``k`` steps: one
        device-to-host read."""
        means = (self.sums / k).cpu().numpy()
        self.sums.zero_()
        return means

    def close(self) -> None:
        self.graph = None


class _ChunkLoader:
    """The per-chunk path's copies into the head of the fixed device
    ``data`` and ``labels`` buffers.

    ``load(sel)`` gathers the images and labels of the rows ``sel`` (a
    chunk's ``(k, batch)`` slice of the epoch's order) into one host
    buffer, pinned on the card, and queues their copy on the current
    stream without waiting for it. The train loop calls it for chunk
    i + 1 once chunk i's steps are queued, so the host's gather runs
    while the device runs those steps; in the stream the copy comes
    after them (they read the buffers' previous contents) and before
    chunk i + 1's. The host buffer is written again only once the copy
    that read it has ended."""

    def __init__(self, ds: ImageDataset, data: torch.Tensor,
                 labels: torch.Tensor):
        self.ds, self.data, self.labels = ds, data, labels
        self.on_card = data.device.type == "cuda"
        self.host_x = torch.empty(data.shape, dtype=torch.uint8,
                                  pin_memory=self.on_card)
        self.host_y = torch.empty(labels.shape, dtype=torch.int32,
                                  pin_memory=self.on_card)
        self.copied: Optional[torch.cuda.Event] = None

    def load(self, sel: np.ndarray) -> None:
        flat = sel.reshape(-1)
        n = flat.size
        if self.copied is not None:
            self.copied.synchronize()
        np.take(self.ds.images, flat, axis=0, out=self.host_x.numpy()[:n],
                mode="clip")  # in range; "clip" writes without a buffer
        self.host_y.numpy()[:n] = self.ds.labels[flat]
        self.data[:n].copy_(self.host_x[:n], non_blocking=True)
        self.labels[:n].copy_(self.host_y[:n], non_blocking=True)
        if self.on_card:
            self.copied = torch.cuda.Event()
            self.copied.record()


# --- Serving: int8 products, quantisation and predict runners ---------

_INT8_MM: Optional[Any] = None


def _ceil(v: int, to: int) -> int:
    return -(-v // to) * to


def _int8_mm_impl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    if x.device.type != "cuda":
        return torch._int_mm(x, w)
    mp, kp, n_p = _ceil(m, 32), _ceil(k, 16), _ceil(n, 16)
    if (mp, kp) != (m, k):
        x = F.pad(x, (0, kp - k, 0, mp - m))
    if (kp, n_p) != (k, n):
        w = F.pad(w, (0, n_p - n, 0, kp - k))
    out = torch._int_mm(x.contiguous(), w.contiguous())
    return out if (mp, n_p) == (m, n) else out[:m, :n].contiguous()


def int8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(m, k)`` int8 × ``(k, n)`` int8 -> ``(m, n)`` int32, exactly:
    ``torch._int_mm`` (cuBLASLt's int8 product on the card, which the
    reference's ``lax.dot_general`` with an int32 accumulator is).

    ``_int_mm`` refuses m ≤ 16 and a k or n that is not a multiple of 8,
    and on the H100 cuBLASLt refused more: k = 104 at any m, and 17 rows
    at k = 112 and n = 32; the served shapes have such (bucket 1, a head
    of 10 classes). So on the card the rows are zero-padded to a
    multiple of 32, and k and the columns to multiples of 16, and the
    result is sliced back: zero rows and columns add nothing to the
    products that are kept. The CPU's ``_int_mm`` takes any shape.

    A custom op, so that ``torch.func.vmap`` over stacked members can
    take it: its batching rule runs one product a member."""
    global _INT8_MM
    if _INT8_MM is None:
        op = torch.library.custom_op("rafiki_torch::int8_mm",
                                     mutates_args=())(_int8_mm_impl)

        @op.register_fake
        def _(x, w):
            return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.int32)

        def batched(info, in_dims, x, w):
            xd, wd = in_dims
            xs = x.movedim(xd, 0) if xd is not None else None
            ws = w.movedim(wd, 0) if wd is not None else None
            return torch.stack([
                op(x if xs is None else xs[i], w if ws is None else ws[i])
                for i in range(info.batch_size)]), 0

        op.register_vmap(batched)
        _INT8_MM = op
    return _INT8_MM(x, w)


def dynamic_int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """The reference's ``dynamic_int8_matmul`` (``jax_model.py:260-276``):
    each row of ``x`` quantised by its own scale ``max|x| / 127``
    (clamped to 1e-8; ``round`` is half to even, as ``jnp.round``), an
    int8 × int8 product into int32 (``int8_mm``), rescaled to f32 once
    by the row's scale and the per-output-channel ``scale`` of the
    ``(in, out)`` int8 kernel ``wq``."""
    s_x = x.abs().amax(dim=-1, keepdim=True) / 127.0
    s_x = torch.clamp_min(s_x, 1e-8)
    xq = torch.clamp(torch.round(x / s_x), -127, 127).to(torch.int8)
    acc = int8_mm(xq, wq)
    return acc.to(torch.float32) * s_x * scale[None, :]


def conv_padding(padding, size: Tuple[int, int], kernel: Tuple[int, int],
                 strides: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    """lax's ``padding`` of a 2-D convolution as ((top, bottom), (left,
    right)): ``"VALID"``, ``"SAME"`` (the total ``max((⌈n/s⌉ − 1)·s + k
    − n, 0)``, the smaller half first) or explicit pairs."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        out = []
        for n, k, st in zip(size, kernel, strides):
            total = max((-(-n // st) - 1) * st + k - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, strides=(1, 1),
              padding="SAME") -> torch.Tensor:
    """The exact int32 NHWC convolution of int8 ``xq`` (B, H, W, cin) by
    the int8 HWIO kernel ``wq`` (kh, kw, cin, cout): an int8 im2col
    (zero padding, then strided views of the padded input, each patch
    laid out (kh, kw, cin) as the kernel's rows) and one ``int8_mm``.
    PyTorch has no int8 convolution on the card, and the product is
    exact: each output sums at most kh·kw·cin products of |·| ≤ 127²
    in int32, as the reference's ``preferred_element_type=int32``."""
    kh, kw, cin, cout = wq.shape
    b, h, w, _ = xq.shape
    (pt, pb), (pl, pr) = conv_padding(padding, (h, w), (kh, kw), strides)
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    # (B, Ho, Wo, cin, kh, kw) -> rows of (kh, kw, cin).
    patches = xp.unfold(1, kh, strides[0]).unfold(2, kw, strides[1])
    ho, wo = patches.shape[1], patches.shape[2]
    rows = patches.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo,
                                                     kh * kw * cin)
    acc = int8_mm(rows, wq.reshape(kh * kw * cin, cout))
    return acc.reshape(b, ho, wo, cout)


def dynamic_int8_conv(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor, strides=(1, 1),
                      padding="SAME") -> torch.Tensor:
    """The reference's ``dynamic_int8_conv`` (``jax_model.py:279-300``):
    each sample of the NHWC ``x`` quantised by one scale, ``max|x|``
    over h, w and c over 127 (clamped to 1e-8; ``round`` half to even),
    the int8 × int8 -> int32 convolution (``int8_conv``), rescaled to
    f32 once by the sample's scale and the per-``cout`` ``scale`` of the
    HWIO int8 kernel ``wq``."""
    s_x = x.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0
    s_x = torch.clamp_min(s_x, 1e-8)
    xq = torch.clamp(torch.round(x / s_x), -127, 127).to(torch.int8)
    acc = int8_conv(xq, wq, strides, padding)
    return acc.to(torch.float32) * s_x * scale


def quantize_flat(flat: Dict[str, np.ndarray]):
    """``(qvars, scales, fvars, layers)`` of a flat reference-layout
    dict, as the reference's ``_quant_host_arrays`` computes them: each
    floating ``…kernel`` of 2 or 4 dims becomes int8 with the symmetric
    per-output-channel scale ``max|W[..., j]| / 127`` over every other
    axis (1 where that is 0); every other leaf stays f32."""
    qvars: Dict[str, np.ndarray] = {}
    scales: Dict[str, np.ndarray] = {}
    fvars: Dict[str, np.ndarray] = {}
    layers: Dict[str, str] = {}
    for k, v in flat.items():
        arr = np.asarray(v)
        if k.endswith("kernel") and arr.ndim in (2, 4) and \
                np.issubdtype(arr.dtype, np.floating):
            w = arr.astype(np.float32)
            s = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
            s = np.where(s <= 0, 1.0, s).astype(np.float32)
            qvars[k] = np.clip(np.round(w / s), -127, 127).astype(np.int8)
            scales[k] = s
            layers[k] = "int8"
        else:
            fvars[k] = arr
            layers[k] = "f32"
    return qvars, scales, fvars, layers


def dequantized_state(qvars: Dict[str, torch.Tensor],
                      scales: Dict[str, torch.Tensor],
                      fvars: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The generic int8 fallback's module state (ref :1170-1195): each
    int8 kernel times its scales in f32, in the graph, and the f32
    leaves as they are, mapped to the port's layout."""
    flat = dict(fvars)
    for k, wq in qvars.items():
        flat[k] = wq.to(torch.float32) * scales[k]
    return dense_from_jax_tensors(flat)


class PredictRunner:
    """One predict runner: ``fn`` on inputs of one shape and dtype.

    On the CPU (and from ``eager``) a call runs ``fn`` eagerly. On the
    card the runner is
    built by one eager run of ``fn`` on a side stream (the libraries make
    their workspaces there) and a capture of ``fn`` as a CUDA graph on a
    static input, in the memory pool ``pool`` that its owner shares
    among all its runners; a call copies its input into the static input
    (``non_blocking``: a pinned staging buffer is read in the stream's
    order) and replays. A call returns a clone of the static output, so
    a later replay never overwrites a result not yet read."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 shape, dtype: torch.dtype, device: torch.device,
                 pool: Any = None):
        self.fn = fn
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        if device.type != "cuda":
            return
        self.static_in = torch.zeros(tuple(shape), dtype=dtype,
                                     device=device)
        with side_stream(device), torch.no_grad():
            fn(self.static_in)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), graph_capture(self.graph, pool):
            self.static_out = fn(self.static_in)

    @classmethod
    def eager(cls, fn: Callable[[torch.Tensor], torch.Tensor],
              device: torch.device) -> "PredictRunner":
        """A runner that runs ``fn`` eagerly at every call: a forward over
        a mesh of distinct cards, which one graph does not hold."""
        runner = cls.__new__(cls)
        runner.fn, runner.device, runner.graph = fn, device, None
        return runner

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            return self.fn(x.to(self.device))
        self.static_in.copy_(x, non_blocking=True)
        self.graph.replay()
        return self.static_out.clone()


class PredictRunners:
    """The predict runners of one model or stacked group, keyed
    ``(bucket, is_u8, quant)`` and built on first use; on the card all
    of them capture into one memory pool, so the rungs of the ladder
    and the dtypes do not each hold their own activations. A capture
    that fails leaves its pool marked as recording, where every later
    capture would raise: the next runner takes a fresh pool. ``captures``
    counts the CUDA graphs captured."""

    def __init__(self, device: torch.device):
        self.device = device
        self.runners: Dict[Any, PredictRunner] = {}
        self.captures = 0
        self._pool: Any = None
        self._lock = threading.Lock()

    def run(self, key: Any, x: torch.Tensor,
            make_fn: Callable[[], Callable[[torch.Tensor], torch.Tensor]],
            capture: bool = True) -> torch.Tensor:
        with self._lock:
            runner = self.runners.get(key)
            if runner is None:
                if self.device.type == "cuda" and self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                try:
                    runner = PredictRunner(
                        make_fn(), x.shape, x.dtype, self.device,
                        self._pool) if capture else PredictRunner.eager(
                            make_fn(), self.device)
                except Exception:
                    self._pool = None
                    raise
                self.captures += runner.graph is not None
                self.runners[key] = runner
            return runner(x)

    def clear(self) -> None:
        with self._lock:
            self.runners.clear()


def staged_chunk(buf: np.ndarray, n: int, shape,
                 bucket: Optional[int]) -> np.ndarray:
    """A staging buffer checked as ``predict_staged_submit`` takes it:
    rows of ``shape`` (a flat row of the same size is viewed so) and a
    leading dim of exactly ``bucket``; else ``ValueError``."""
    shape = tuple(shape)
    if buf.shape[1:] != shape:
        if int(np.prod(buf.shape[1:])) != int(np.prod(shape)):
            raise ValueError(f"staged rows {buf.shape[1:]} != {shape}")
        buf = buf.reshape((buf.shape[0], *shape))
    if bucket is None or buf.shape[0] != bucket:
        raise ValueError(f"staging buffer leading dim {buf.shape[0]} != "
                         f"bucket {bucket} for n={n}")
    return buf


def padded_to_bucket(chunk: np.ndarray, dp: int = 1) -> np.ndarray:
    """``chunk`` with zero rows up to its bucket."""
    n = chunk.shape[0]
    bucket = predict_bucket_of(n, dp)
    if n == bucket:
        return chunk
    return np.concatenate([chunk, np.zeros((bucket - n, *chunk.shape[1:]),
                                           chunk.dtype)])


def predict_bucket_of(n: int, dp: int = 1) -> int:
    """The predict bucket of ``n`` rows: the smallest of ``dp``,
    ``2·dp``, ``4·dp`` … at or above ``n``, so that the mesh's dp ranks
    take equal rows (ref :1086-1088, :1123-1126)."""
    bucket = dp
    while bucket < n:
        bucket *= 2
    return bucket


def host_input(chunk: np.ndarray) -> Tuple[torch.Tensor, bool]:
    """A bucket's host rows as a tensor (no copy where they are already
    contiguous uint8 or float32) and whether they are uint8."""
    if chunk.dtype != np.uint8 and chunk.dtype != np.float32:
        chunk = chunk.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(chunk)), \
        chunk.dtype == np.uint8


def probabilities(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.to(torch.float32), dim=-1)


def normalised(x: torch.Tensor, is_u8: bool) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf / 255.0 if is_u8 else xf


class TorchModel(BaseModel):
    """Base for module-backed image classifiers. Subclasses implement
    ``create_module(n_classes, image_shape)`` and may override
    ``create_optimizer`` and ``extra_apply_inputs``."""

    max_predict_batch: int = 512

    def __init__(self, device: DeviceLike = None, **knobs: Any):
        super().__init__(**knobs)
        self.device = resolve_device(device)
        self._net: Optional[nn.Module] = None
        self._meta: Dict[str, Any] = {}
        self._extra: Optional[Dict[str, torch.Tensor]] = None
        self._runners = PredictRunners(self.device)
        self._quant_mode: Optional[str] = None
        self._quant_host = None
        self._quant_dev = None
        self._quant_layers: Optional[Dict[str, str]] = None
        self._mesh: Optional[Mesh] = None
        self._pred_replicas: Optional[List[nn.Module]] = None

    # --- Subclass API ---

    def create_module(self, n_classes: int, image_shape) -> nn.Module:
        """A module on the CPU, initialised from the ``seed`` knob, with
        float32 parameters named as the reference's flax paths."""
        raise NotImplementedError

    #: The values of ``learning_rate`` and ``weight_decay`` when the
    #: knobs lack them: the reference's ``traced_knob_defaults``.
    traced_knob_defaults: Dict[str, float] = {}

    def traced_knob(self, name: str, default: float = 0.0) -> float:
        """Knob ``name``, else ``traced_knob_defaults[name]``, else
        ``default``: how the reference fills its traced hyperparameters
        (``jax_model.py:621-625``)."""
        return float(self.knobs.get(
            name, self.traced_knob_defaults.get(name, default)))

    def create_optimizer(self, params, steps_per_epoch: int,
                         max_epochs: int) -> ScheduledOptimizer:
        """``traced_hyperparam_optimizer(opt="adam", weight_decay=True)``
        (ref :412-448): Adam under a cosine decay to 0.01 over the run,
        times the ``learning_rate`` knob, with the ``weight_decay``
        knob's L2 decay coupled into Adam's moments (none when it is 0);
        in PyTorch the per-trial values are simply values."""
        return scheduled_adam(
            params, self.traced_knob("learning_rate", 1e-3),
            steps_per_epoch * max_epochs,
            weight_decay=self.traced_knob("weight_decay"))

    def extra_apply_inputs(self) -> Dict[str, np.ndarray]:
        """Extra inputs handed to every forward as keyword arguments
        (the knob masks of a supernet)."""
        return {}

    def augment_in_graph(self, x: torch.Tensor, step: torch.Tensor,
                         row0: int = 0) -> torch.Tensor:
        """Augments a normalised (B, H, W, C) train batch on the device;
        ``step`` is the device step counter (from 0 over the run), and
        ``row0`` the row of the whole batch where ``x`` starts (a
        data-parallel rank's rows). Identity by default."""
        return x

    # --- Plumbing ---

    def _extra_dev(self) -> Dict[str, torch.Tensor]:
        if self._extra is None:
            self._extra = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                           for k, v in self.extra_apply_inputs().items()}
        return self._extra

    def _new_net(self, n_classes: int, image_shape) -> nn.Module:
        self._meta = {"n_classes": int(n_classes),
                      "image_shape": [int(s) for s in image_shape]}
        return self.create_module(n_classes, image_shape).to(self.device)

    def _require_net(self) -> nn.Module:
        if self._net is None:
            raise RuntimeError("train() or load_parameters() first")
        return self._net

    def _logits(self, net: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """Normalised float32 images -> the module's logits."""
        return net(x, **self._extra_dev())

    # --- The mesh (ref :460-466) ---

    @property
    def mesh(self) -> Mesh:
        """The (dp, pp, ep, sp, tp) mesh over the devices of the group
        bound to the thread, ``tensor_parallel`` of them a data-parallel
        rank, or over the model's device alone when none is bound (a
        group that ``tensor_parallel`` does not divide raises)."""
        if self._mesh is None:
            self._mesh = group_mesh(
                self.device, tp=int(self.knobs.get("tensor_parallel", 1)))
        return self._mesh

    def _extra_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        return {k: v.to(device, non_blocking=True)
                for k, v in self._extra_dev().items()}

    def _replicas(self, net: nn.Module) -> List[nn.Module]:
        """Each dp rank's replica of ``net`` on the leaves it holds, for
        the eval-mode forwards (no rank writes, none sums)."""
        mesh = self.mesh
        placed = place_leaves(dict(net.named_parameters()), mesh)
        return [replica(net, placed, rank_coord(i))
                for i in range(mesh.shape["dp"])]

    def _train_logits(self, net: nn.Module,
                      images: Dict[torch.device, torch.Tensor],
                      sel: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        """The logits of a train step's rows ``sel`` of the staged
        ``images``, gathered and normalised on the device and augmented:
        on the model's device, or each dp rank's rows on its device
        through its replica (ref :518-535), gathered here."""
        mesh = self.mesh
        if mesh.size == 1:
            x = self.augment_in_graph(images[self.device][sel].float()
                                      / 255.0, step)
            return self._logits(net, x)

        def inputs(dev, lo, hi):
            src = images.get(dev, images[self.device])
            x = src[sel[lo:hi].to(src.device)].to(dev).float() / 255.0
            return (self.augment_in_graph(x, step.to(dev), row0=lo),)

        return mesh_apply(mesh, net, sel.shape[0], inputs, self.device,
                          kwargs=self._extra_on)

    def _macs(self, net: nn.Module, image_shape) -> int:
        """Multiply-adds of one example through the module's dense
        layers and every convolution its forward runs (each module with
        a ``macs(out)`` method, counted by a forward hook on one zero
        image in eval mode). A masked supernet computes every branch,
        so every branch counts."""
        total = [sum(m.in_features * m.out_features
                     for m in net.modules() if isinstance(m, nn.Linear))]

        def hook(mod, _inp, out):
            total[0] += mod.macs(out)

        handles = [m.register_forward_hook(hook) for m in net.modules()
                   if hasattr(m, "macs")]
        was_training = net.training
        try:
            net.eval()
            with torch.no_grad():
                self._logits(net, torch.zeros((1, *image_shape),
                                              device=self.device))
        finally:
            net.train(was_training)
            for h in handles:
                h.remove()
        return total[0]

    # --- BaseModel: train ---

    def train(self, dataset_path: str, *,
              shared_params: Optional[Params] = None, **kwargs: Any) -> None:
        t_load = time.monotonic()
        ds = load_image_dataset(dataset_path)
        _phases.observe_phase("load", time.monotonic() - t_load)
        net = self._new_net(ds.n_classes, ds.image_shape)
        if shared_params is not None:
            self._merge_shared(net, shared_params)

        dp = self.mesh.shape["dp"]
        # Never larger than the set, and a multiple of dp (ref :486-488).
        batch_size = min(int(self.knobs.get("batch_size", 128)), ds.size)
        batch_size = max(dp, (batch_size // dp) * dp)
        max_epochs = int(self.knobs.get("max_epochs", 5))
        if self.knobs.get("quick_train", False):
            max_epochs = min(max_epochs,
                             int(self.knobs.get("trial_epochs", 1)))
        steps_per_epoch = max(1, ds.size // batch_size)
        seed = int(self.knobs.get("seed", 0))
        opt = self.create_optimizer(list(net.parameters()),
                                    steps_per_epoch,
                                    schedule_epochs(kwargs, max_epochs))

        chunk_steps = max(1, min(steps_per_epoch, CHUNK_STEPS))
        # The whole dataset goes to the device once, as uint8, through
        # the staging cache; an oversized one a chunk at a time into a
        # fixed buffer that the steps index with identity tables.
        staged = ds.images.nbytes <= stage_bytes_limit()
        if staged:
            images, labels = self._stage(dataset_path, ds)
            data = images[self.device]
        else:
            rows = chunk_steps * batch_size
            data = torch.empty((rows, *ds.image_shape), dtype=torch.uint8,
                               device=self.device)
            labels = torch.empty((rows,), dtype=torch.int32,
                                 device=self.device)
            identity = ((np.arange(steps_per_epoch) % chunk_steps)[:, None]
                        * batch_size + np.arange(batch_size)[None, :])
            images = {self.device: data}
        steps = _TrainSteps(self, net, opt, data, labels, steps_per_epoch,
                            batch_size, images)
        loader = None if staged else _ChunkLoader(ds, data, labels)
        # Utilization is a card's: on the CPU the step cost stays
        # unknown, so no chip_util and no MFU gauge.
        meter = MfuMeter(
            6 * batch_size * self._macs(net, ds.image_shape)
            if self.device.type == "cuda" else None,
            n_devices=self.mesh.size, device=self.device)
        # The step-time histogram and the MFU gauge carry the labels the
        # caller bound (TrialRunner binds trial=<id>, and /status reads
        # the gauge by trial).
        mlabels = metrics.bound_labels()
        reg = metrics.registry()
        step_hist = reg.histogram(
            "rafiki_tpu_train_step_seconds",
            "Optimizer step wall time (chunk time / steps per chunk)")
        mfu_gauge = reg.gauge(
            "rafiki_tpu_train_mfu_ratio",
            "Model-FLOPs-utilization of the trial's chip group "
            "(published per epoch)")
        logger.define_plot("Training", ["loss", "train_acc", "chip_util"],
                           x_axis="epoch")
        early_stop = int(self.knobs.get("early_stop_epochs", 0))
        best_loss, bad_epochs = float("inf"), 0
        # Checkpoint resume (ref :693-712): the state is restored into
        # the parameters, the optimizer's state and counts and the step
        # counter before the first step, and so before the capture.
        ckpt = LoopCheckpointer(kwargs)
        state = TrainState(net, opt, steps.step_no) if ckpt.enabled \
            else None
        start_epoch = 0
        if state is not None:
            start_epoch, extras = ckpt.restore(state)
            if start_epoch:
                best_loss = float(np.asarray(extras.get(
                    "es_best_loss", np.inf)).reshape(-1)[0])
                bad_epochs = int(np.asarray(extras.get(
                    "es_bad_epochs", 0)).reshape(-1)[0])
                if early_stop and bad_epochs >= early_stop:
                    # The restored run had stopped early: an
                    # uninterrupted run trains nothing further.
                    start_epoch = max_epochs
        first_chunk = True
        net.train()
        t0 = time.time()
        step = 0
        last_epoch = None
        for epoch in range(start_epoch, max_epochs):
            order = epoch_rng(seed, epoch).permutation(ds.size)
            need = steps_per_epoch * batch_size
            if need > ds.size:
                # Tiny dataset: wrap so every epoch still takes full
                # batches.
                order = np.resize(order, need)
            sel_all = order[:need].reshape(steps_per_epoch, batch_size)
            steps.new_epoch(sel_all if staged else identity)
            ep_loss, ep_acc, nw = 0.0, 0.0, 0
            s = 0
            if loader is not None:
                loader.load(sel_all[:chunk_steps])
            while s < steps_per_epoch:
                k = min(chunk_steps, steps_per_epoch - s)
                t_chunk = time.monotonic()
                for _ in range(k):
                    steps.step()
                if loader is not None and s + k < steps_per_epoch:
                    # The next chunk, while the device runs this one.
                    loader.load(sel_all[s + k:s + k + chunk_steps])
                loss_acc = steps.read_means(k)
                # read_means is the chunk's sync, so this is wall time.
                step_hist.observe((time.monotonic() - t_chunk) / k,
                                  **mlabels)
                step += k
                s += k
                meter.tick(k)
                if first_chunk:
                    # The first chunk pays the card's first-use costs.
                    first_chunk = False
                    meter.reset()
                ep_loss += float(loss_acc[0]) * k
                ep_acc += float(loss_acc[1]) * k
                nw += k
            ep_loss /= max(nw, 1)
            ep_acc /= max(nw, 1)
            mfu = meter.mfu
            util = {"chip_util": round(mfu, 6)} if mfu is not None else {}
            if mfu is not None:
                mfu_gauge.set(mfu, **mlabels)
            logger.log(epoch=epoch, loss=ep_loss, train_acc=ep_acc,
                       steps_per_sec=step / (time.time() - t0), **util)
            last_epoch = epoch
            if early_stop:
                if ep_loss < best_loss - 1e-4:
                    best_loss, bad_epochs = ep_loss, 0
                else:
                    bad_epochs += 1
                    if bad_epochs >= early_stop:
                        break
            if state is not None:
                ckpt.after_epoch(epoch, state, max_epochs,
                                 _es_arrays(best_loss, bad_epochs))
        if state is not None:
            ckpt.after_loop(last_epoch, state,
                            _es_arrays(best_loss, bad_epochs))
        steps.close()
        net.eval()
        self._net = net
        self._invalidate_compiled()

    def _stage(self, dataset_path: str, ds: ImageDataset
               ) -> Tuple[Dict[torch.device, torch.Tensor], torch.Tensor]:
        """The whole set's uint8 images on each device of the mesh and
        its int32 labels on the model's device, from the staging cache,
        timed as the ``stage`` phase."""
        t_stage = time.monotonic()
        staged = staged_mesh_arrays(dataset_path, ds, self.mesh)
        _phases.observe_phase("stage", time.monotonic() - t_stage)
        return staged

    def _merge_shared(self, net: nn.Module, shared_params: Params) -> None:
        """Warm start: overlay the shared parameters whose flat name and
        shape match (ref ``_merge_shared``, :875-887)."""
        n = overlay_params(net, shared_params)
        logger.log(msg=f"warm-started {n} shared tensors")

    # --- BaseModel: evaluate ---

    @torch.no_grad()
    def evaluate(self, dataset_path: str) -> float:
        net = self._require_net()
        t_load = time.monotonic()
        ds = load_image_dataset(dataset_path)
        _phases.observe_phase("load", time.monotonic() - t_load)
        staged = ds.images.nbytes <= stage_bytes_limit()
        if staged:
            images, labels = self._stage(dataset_path, ds)
        mesh = self.mesh
        dp = mesh.shape["dp"]
        # dp-aligned batches, the last one padded (ref :903-904).
        bs = max(dp, (min(EVAL_BATCH, ds.size) // dp) * dp)
        reps = self._replicas(net) if mesh.size > 1 else None
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for start in range(0, ds.size, bs):
            n = min(bs, ds.size - start)
            rows = bs if reps is not None else n
            if staged:
                # Padding rows read row 0 and are not counted.
                sel = torch.zeros(rows, dtype=torch.int64,
                                  device=self.device)
                sel[:n] = torch.arange(start, start + n, device=self.device)
                yb = labels[sel[:n]]

                def inputs(dev, lo, hi, sel=sel):
                    src = images.get(dev, images[self.device])
                    return (src[sel[lo:hi].to(src.device)].to(dev).float()
                            / 255.0,)
            else:
                # An oversized set ships each batch (ref :955-971).
                host = np.zeros((rows, *ds.image_shape), np.uint8)
                host[:n] = ds.images[start:start + n]
                xb = torch.tensor(host, device=self.device)
                yb = torch.tensor(ds.labels[start:start + n],
                                  device=self.device)

                def inputs(dev, lo, hi, xb=xb):
                    return (xb[lo:hi].to(dev).float() / 255.0,)
            if reps is None:
                logits = self._logits(net, *inputs(self.device, 0, n))
            else:
                logits = mesh_apply(mesh, net, rows, inputs, self.device,
                                    replicas=reps, kwargs=self._extra_on)
            correct += (logits[:n].argmax(-1) == yb).sum()
        return float(int(correct) / ds.size)

    # --- BaseModel: predict ---

    def predict(self, queries: List[Any]) -> List[Any]:
        return self.predict_submit(queries)()

    def predict_submit(self, queries: List[Any]) -> Callable[[], List[Any]]:
        """Launch the prediction of ``queries`` and return a finisher
        that reads it back: the launches are asynchronous on the card,
        and only the finisher waits."""
        self._require_net()
        if not queries:
            return lambda: []
        imgs = self._stack_queries(queries)
        handles = [self._predict_bucket_submit(
            imgs[s:s + self.max_predict_batch])
            for s in range(0, imgs.shape[0], self.max_predict_batch)]

        def finish() -> List[Any]:
            probs = torch.cat([dev[:count] for dev, count in handles])
            return [p.tolist() for p in probs.cpu().numpy()]

        return finish

    def predict_proba(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, C) uint8 or normalised float32 images -> (N,
        n_classes) float32 probabilities, bucket by bucket."""
        self._require_net()
        if images.shape[0] == 0:
            return np.zeros((0, self._meta["n_classes"]), np.float32)
        handles = [self._predict_bucket_submit(
            images[s:s + self.max_predict_batch])
            for s in range(0, images.shape[0], self.max_predict_batch)]
        return torch.cat([dev[:count] for dev, count in handles]
                         ).cpu().numpy()

    #: Staging-buffer dtypes ``predict_staged_submit`` takes.
    predict_staged_dtypes = (np.uint8, np.float32)

    def predict_bucket(self, n: int,
                       dtype: Any = np.float32) -> Optional[int]:
        """The leading dim a staging buffer must have for an ``n``-query
        staged burst (``predict_bucket_of`` the mesh's dp), or None when
        the staged path cannot take it: ``n`` past ``max_predict_batch``,
        an unsupported dtype, or no loaded model."""
        if self._net is None or not self._meta.get("n_classes"):
            return None
        if n < 1 or n > self.max_predict_batch:
            return None
        if np.dtype(dtype) not in [np.dtype(d)
                                   for d in self.predict_staged_dtypes]:
            return None
        return predict_bucket_of(n, self.mesh.shape["dp"])

    def predict_staged_submit(self, buf: np.ndarray,
                              n: int) -> Callable[[], List[Any]]:
        """Launch one burst straight from a staging buffer: ``buf``'s
        leading dim is exactly ``predict_bucket(n, buf.dtype)`` and rows
        ``[n:]`` are padding (stale rows are fine: their outputs are
        sliced away). Returns a finisher as ``predict_submit`` does."""
        self._require_net()
        buf = staged_chunk(buf, n, self._meta["image_shape"],
                           self.predict_bucket(n, buf.dtype))
        dev, count = self._dispatch_bucket(buf, n)

        def finish() -> List[Any]:
            return [p.tolist() for p in dev[:count].cpu().numpy()]

        return finish

    def _predict_bucket_submit(self, chunk: np.ndarray):
        """``chunk`` zero-padded to its bucket and dispatched: ``(device
        probabilities of the bucket, n)``."""
        return self._dispatch_bucket(
            padded_to_bucket(chunk, self.mesh.shape["dp"]), chunk.shape[0])

    def _dispatch_bucket(self, chunk: np.ndarray, n: int):
        """``chunk``'s leading dim is exactly a bucket: run it on the
        runner of ``(bucket, is_u8, quant)``, built on first use.
        Returns ``(device probabilities, n)``."""
        x, is_u8 = host_input(chunk)
        return self._runners.run((chunk.shape[0], is_u8, self._quant_mode),
                                 x, lambda: self._predict_fn(is_u8),
                                 self.mesh.distinct() == 1), n

    @property
    def captures(self) -> int:
        """CUDA graphs this model captured for its predict runners."""
        return self._runners.captures

    def _predict_fn(self, is_u8: bool) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
        """The forward of one runner: input rows -> f32 probabilities,
        the rows over the mesh's dp ranks (ref :1144-1220); under
        serving quantisation, from the int8 weights, replicated on every
        rank as the reference keeps them (the model's
        ``quantized_apply``, or the generic fallback: the weights
        dequantised in the graph, the module unchanged)."""
        net = self._require_net()
        mesh = self.mesh
        if self._quant_mode is None:
            if mesh.size == 1:
                return lambda x: probabilities(
                    self._logits(net, normalised(x, is_u8)))
            if self._pred_replicas is None:
                self._pred_replicas = self._replicas(net)
            reps = self._pred_replicas

            def rows(x: torch.Tensor) -> torch.Tensor:
                return probabilities(mesh_apply(
                    mesh, net, x.shape[0], lambda dev, lo, hi: (normalised(
                        x[lo:hi].to(dev, non_blocking=True), is_u8),),
                    self.device, replicas=reps, kwargs=self._extra_on))

            return rows
        qvars, scales, fvars, _ = self._quant_device_arrays()
        by_dev = {d: tuple({k: v.to(d) for k, v in part.items()}
                           for part in (qvars, scales, fvars))
                  for d in mesh_devices(mesh)}

        def forward(xf: torch.Tensor) -> torch.Tensor:
            q, sc, f = by_dev[xf.device]
            extra = self._extra_on(xf.device)
            logits = self.quantized_apply(q, sc, f, xf, extra)
            if logits is None:
                logits = functional_call(net, dequantized_state(q, sc, f),
                                         (xf,), extra)
            return logits

        def fn(x: torch.Tensor) -> torch.Tensor:
            if mesh.size == 1:
                return probabilities(forward(normalised(x, is_u8)))
            outs = [forward(normalised(x[lo:hi].to(d, non_blocking=True),
                                       is_u8)).to(self.device)
                    for d, (lo, hi) in self._dp_blocks(x.shape[0])]
            return probabilities(torch.cat(outs))

        return fn

    def _dp_blocks(self, n: int) -> List[Tuple[torch.device,
                                               Tuple[int, int]]]:
        """Each dp rank's device and its rows of an ``n``-row batch."""
        mesh = self.mesh
        return [(mesh.device(rank_coord(i)), b) for i, b in
                enumerate(row_blocks(n, mesh.shape["dp"])) if b[0] < b[1]]

    def _stack_queries(self, queries: List[Any]) -> np.ndarray:
        """Stack queries for the device, keeping all-uint8 batches uint8
        (the device normalises them); otherwise uint8 queries are scaled
        here and float queries are taken as normalised."""
        shape = self._meta["image_shape"]
        raws = [self._query_to_raw(q, shape) for q in queries]
        if all(r.dtype == np.uint8 for r in raws):
            return np.stack(raws)
        return np.stack([
            r.astype(np.float32) / 255.0 if r.dtype == np.uint8 else r
            for r in raws])

    @staticmethod
    def _query_to_raw(q: Any, expected_shape) -> np.ndarray:
        arr = np.asarray(q)
        if arr.ndim == 2:
            arr = arr[..., None]
        if tuple(arr.shape) != tuple(expected_shape):
            raise ValueError(
                f"query shape {arr.shape} != {tuple(expected_shape)}")
        if arr.dtype == np.uint8:
            return arr
        return arr.astype(np.float32)

    # --- Serving quantisation (int8) ---

    def enable_serving_quant(self, mode: Optional[str] = "int8"
                             ) -> Dict[str, Any]:
        """Serve from int8 weights (ref :1222-1255): per-channel
        symmetric scales over every 2-D and 4-D ``kernel`` of the loaded
        parameters, computed once; predict runners are built anew for
        ``(bucket, dtype, "int8")``; training and evaluation are
        untouched. ``None`` or ``""`` turns it off; another mode than
        ``"int8"`` raises ``ValueError``. Returns ``quant_report()``."""
        if not mode:
            if self._quant_mode is not None:
                self._quant_mode = None
                self._drop_quant()
            return {"mode": None, "layers": {}}
        if mode != "int8":
            raise ValueError(f"unsupported serving quant mode {mode!r}")
        self._require_net()
        if self._quant_mode != mode:
            self._quant_mode = mode
            self._drop_quant()
        return self.quant_report()

    def _drop_quant(self) -> None:
        self._pred_replicas = None
        self._quant_dev = None
        self._quant_host = None
        self._quant_layers = None
        self._runners.clear()

    def quant_report(self) -> Dict[str, Any]:
        """``{"mode", "layers": {path: "int8" | "f32"}, "n_int8",
        "n_f32"}``, or mode None when serving is not quantised."""
        if self._quant_mode is None or self._net is None:
            return {"mode": None, "layers": {}}
        layers = self._quant_layers
        if layers is None:
            _, _, _, layers = self._quant_host_arrays()
        n_int8 = sum(1 for v in layers.values() if v == "int8")
        return {"mode": self._quant_mode, "layers": dict(layers),
                "n_int8": n_int8, "n_f32": len(layers) - n_int8}

    def _quant_host_arrays(self):
        """``(qvars, scales, fvars, layers)``: flat host dicts in the
        reference's layout (``quantize_flat`` of ``dense_to_jax`` of the
        module's state), computed once per loaded parameters."""
        if self._quant_host is None:
            self._quant_host = quantize_flat(
                dense_to_jax(self._require_net().state_dict()))
            self._quant_layers = self._quant_host[3]
        return self._quant_host

    def _quant_device_arrays(self):
        """The same on the model's device; the host copy is then
        dropped, as the reference's is."""
        if self._quant_dev is None:
            qvars, scales, fvars, layers = self._quant_host_arrays()

            def put(d):
                return {k: torch.from_numpy(np.ascontiguousarray(v))
                        .to(self.device) for k, v in d.items()}

            self._quant_dev = (put(qvars), put(scales), put(fvars), layers)
            self._quant_host = None
        return self._quant_dev

    def quantized_apply(self, qvars: Dict[str, torch.Tensor],
                        scales: Dict[str, torch.Tensor],
                        fvars: Dict[str, torch.Tensor], x: torch.Tensor,
                        extra: Dict[str, torch.Tensor]
                        ) -> Optional[torch.Tensor]:
        """A model's own int8 forward: logits from the int8 kernels
        (``dynamic_int8_matmul``), or None (the default) for the generic
        fallback. The dicts are flat, in the reference's layout; under
        a stacked group the call runs inside ``torch.func.vmap``."""
        return None

    # --- Stacked-ensemble congruence ---

    #: Whether members of this class may stack (``stack_members``).
    stack_compatible: bool = True

    def module_config(self) -> Any:
        """The module's static configuration: what flax's dataclass
        equality of the module compares in the reference (widths,
        depths, dtype). PyTorch modules do not compare so, so a model
        that declares none never stacks: the default is this instance's
        own."""
        return ("instance", id(self))

    def stack_signature(self) -> Any:
        """Two members stack only if their signatures are equal: the
        class, ``module_config()`` and the served output contract (ref
        :1328-1340)."""
        return (type(self).__name__, self.module_config(),
                int(self._meta.get("n_classes", 0)),
                tuple(self._meta.get("image_shape", ())))

    def warmup(self) -> None:
        """Build the smallest bucket's float32 and uint8 runners (and so
        capture their graphs) before serving traffic."""
        shape = self._meta.get("image_shape")
        if self._net is None or not shape:
            return
        self.predict_proba(np.zeros((1, *shape), np.float32))
        dev, _ = self._predict_bucket_submit(np.zeros((1, *shape),
                                                      np.uint8))
        dev.cpu()

    def _invalidate_compiled(self) -> None:
        """Runners and quantised weights follow the parameters; the
        asked-for quant mode stays."""
        self._runners.clear()
        self._pred_replicas = None
        self._extra = None
        self._quant_dev = None
        self._quant_host = None
        self._quant_layers = None

    # --- BaseModel: parameters ---

    def dump_parameters(self) -> Params:
        out = dense_to_jax(self._require_net().state_dict())
        out["_meta/n_classes"] = np.asarray(self._meta["n_classes"])
        out["_meta/image_shape"] = np.asarray(self._meta["image_shape"])
        return out

    def load_parameters(self, params: Params) -> None:
        meta_n = params.get("_meta/n_classes")
        meta_shape = params.get("_meta/image_shape")
        if meta_n is None or meta_shape is None:
            raise ValueError("params missing _meta entries")
        # A 0-d array may come back as shape (1,); accept both.
        net = self._new_net(int(np.asarray(meta_n).reshape(-1)[0]),
                            [int(x) for x in np.asarray(meta_shape)])
        net.load_state_dict(dense_from_jax(params))
        self._net = net.eval()
        self._invalidate_compiled()

    def destroy(self) -> None:
        self._invalidate_compiled()
        self._net = None


def __getattr__(name: str) -> Any:
    # Stacked ensembles live in ``stacked.py`` (which imports this
    # module) and are re-exported here, as the reference keeps them in
    # ``jax_model.py``.
    if name in ("StackedMembers", "stack_congruence", "stack_members"):
        from . import stacked
        return getattr(stacked, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
