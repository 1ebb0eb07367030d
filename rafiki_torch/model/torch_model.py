"""TorchModel: the PyTorch path of the BaseModel contract for image
classifiers.

The counterpart of ``JaxModel`` (``rafiki_tpu/model/jax_model.py:327``).
Zoo models declare a module (``create_module``) and knobs; this class
trains, evaluates, serves and (de)serialises it as the reference does:

- ``train`` (ref :476-813) stages the whole uint8 dataset on the device
  once; each step gathers its batch there by index and normalises it
  (``/255``), so the host sends index tensors, never images. Each
  epoch's order is ``epoch_rng(seed, epoch).permutation(size)``, wrapped
  with ``np.resize`` when the set is smaller than one epoch's steps. The
  loss is f32 softmax cross-entropy on f32-cast logits; loss and train
  accuracy stay on the device and are read back once per chunk of up to
  128 steps; one ``logger.log`` record per epoch carries ``epoch``,
  ``loss``, ``train_acc``, ``steps_per_sec`` and, on the card,
  ``chip_util`` (analytic FLOPs of the module's convolutions and dense
  layers over the H100's bf16 peak). ``augment_in_graph(x, step)``
  augments each normalised batch on the device (identity by default;
  the conv zoo's ``pad_crop_flip``, ref :231-257). The module runs in
  train mode, so a BatchNorm's running statistics update in place, in
  the captured graph too; ``evaluate`` and ``predict`` run it in eval
  mode, on the running statistics (ref :518-581). On one card there is
  no data-parallel rounding of the batch: it is only capped at the
  dataset's size. On the card the step is captured once as a CUDA graph
  and replayed (``_TrainSteps``), the counterpart of the reference's
  many steps per compiled dispatch.
- ``evaluate`` (ref :890-991): argmax accuracy over the staged set in
  batches of up to 1024.
- ``predict`` / ``predict_submit`` / ``predict_proba`` (ref :994-1070):
  a 2-D query gains a channel axis and a shape mismatch raises
  ``ValueError``; all-uint8 batches go to the device as uint8 and are
  normalised there, float queries are taken as already normalised; the
  output is an f32 softmax; queries go in chunks of
  ``max_predict_batch``.
- ``dump_parameters`` / ``load_parameters`` (ref :1363-1390) use the
  reference's flat flax names (``params/Dense_0/kernel``,
  ``batch_stats/.../mean`` …) and shapes plus ``_meta/n_classes`` and
  ``_meta/image_shape``, as host numpy, so the two packages' parameter
  files interchange (``bridge.dense_from_jax``).

Not ported yet: checkpoint resume (``checkpoint_dir`` raises), serving
quantisation, stacked ensembles, bucketed and staged predict, the
compiled-step cache, the host and device dataset caches and multi-chip
meshes.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..observe import H100_PEAK_BF16_FLOPS, MfuMeter
from ..torchenv import DeviceLike, resolve_device
from ..utils.hashing import M32, mix32
from .base import BaseModel, Params
from .bridge import dense_from_jax, dense_to_jax
from .dataset import load_image_dataset
from .logger import logger
from .loop_ckpt import epoch_rng
from .optim import ScheduledOptimizer, scheduled_adam

#: Steps per device round trip of the train loop (ref :666).
CHUNK_STEPS = 128
#: Rows per evaluation batch (ref :904).
EVAL_BATCH = 1024
#: Eager train steps on the card before the step is captured.
WARMUP_STEPS = 3


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


def crop_flip_draw(seed: int, step: torch.Tensor, b: int, pad: int = 4):
    """Row offsets, column offsets (each in [0, 2·pad]) and flips (p =
    0.5) of the ``b`` rows of train step ``step`` (a device int64
    scalar): a hash of (``seed``, ``step``, row), so no generator state
    is read, a captured step draws anew at every replay, and eager
    steps and replays draw the same. The draws are not ``jax.random``'s."""
    rows = torch.arange(b, device=step.device)
    h = mix32(mix32(torch.full_like(step, seed & M32)) ^ (step & M32))
    h = mix32(h ^ rows)
    span = 2 * pad + 1
    return (mix32(h ^ 1) % span, mix32(h ^ 2) % span,
            (mix32(h ^ 3) & 1).bool())


def pad_crop_flip(x: torch.Tensor, seed: int, step: torch.Tensor,
                  pad: int = 4, min_size: int = 16) -> torch.Tensor:
    """The CIFAR recipe on the device: reflect-pad ``pad``, a random
    crop back to H × W and a horizontal flip with p = 0.5, drawn by
    ``crop_flip_draw``. Images smaller than ``min_size`` pass through,
    as in the reference."""
    b, h, w, _ = x.shape
    if min(h, w) < min_size:
        return x
    ys, xs, flip = crop_flip_draw(seed, step, b, pad)
    return crop_flip(x, ys, xs, flip, pad)


class _TrainSteps:
    """The optimizer steps of one ``train`` call.

    A step reads its batch's indices from this epoch's index table (one
    host-to-device copy an epoch) at a device row counter, gathers and
    normalises the batch on the device, and adds its loss and train
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
                 batch_size: int):
        dev = model.device
        self.model, self.net, self.opt = model, net, opt
        self.data, self.labels = data, labels
        self.order = torch.zeros((steps_per_epoch, batch_size),
                                 dtype=torch.int64, device=dev)
        self.row = torch.zeros((), dtype=torch.int64, device=dev)
        self.step_no = torch.zeros((), dtype=torch.int64, device=dev)
        self.sums = torch.zeros(2, dtype=torch.float32, device=dev)
        self.on_card = dev.type == "cuda"
        self.side = torch.cuda.Stream(dev) if self.on_card else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.n_eager = 0

    def new_epoch(self, order: np.ndarray) -> None:
        self.order.copy_(torch.from_numpy(np.ascontiguousarray(order)))
        self.row.zero_()

    def _forward_backward(self) -> None:
        sel = self.order.index_select(0, self.row.view(1)).view(-1)
        x = self.model.augment_in_graph(self.data[sel].float() / 255.0,
                                        self.step_no)
        y = self.labels[sel]
        logits = self.model._logits(self.net, x).float()
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
            main = torch.cuda.current_stream()
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side):
                self._eager()
            main.wait_stream(self.side)
        else:
            # Gradients set to None before the capture: the captured
            # backward allocates them in the graph's pool and every
            # replay overwrites them.
            self.opt.zero_grad()
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: other threads of the process (an inference
            # worker) may keep using the card during the capture.
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
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

    # --- Subclass API ---

    def create_module(self, n_classes: int, image_shape) -> nn.Module:
        """A module on the CPU, initialised from the ``seed`` knob, with
        float32 parameters named as the reference's flax paths."""
        raise NotImplementedError

    def create_optimizer(self, params, steps_per_epoch: int,
                         max_epochs: int) -> ScheduledOptimizer:
        """Adam under a cosine decay to 0.01 over the run, times the
        ``learning_rate`` knob (AdamW when ``weight_decay`` > 0): the
        counterpart of ``JaxModel.create_optimizer`` and of
        ``traced_hyperparam_optimizer``, which compute the same update;
        in PyTorch the per-trial learning rate is simply a value."""
        return scheduled_adam(
            params, float(self.knobs.get("learning_rate", 1e-3)),
            steps_per_epoch * max_epochs,
            weight_decay=float(self.knobs.get("weight_decay", 0.0)))

    def extra_apply_inputs(self) -> Dict[str, np.ndarray]:
        """Extra inputs handed to every forward as keyword arguments
        (the knob masks of a supernet)."""
        return {}

    def augment_in_graph(self, x: torch.Tensor,
                         step: torch.Tensor) -> torch.Tensor:
        """Augments a normalised (B, H, W, C) train batch on the device;
        ``step`` is the device step counter (from 0 over the run).
        Identity by default."""
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
        if kwargs.get("checkpoint_dir"):
            raise NotImplementedError(
                "checkpoint resume of TorchModel.train is not ported yet "
                "(ROADMAP queue 1 item 6)")
        ds = load_image_dataset(dataset_path)
        net = self._new_net(ds.n_classes, ds.image_shape)
        if shared_params is not None:
            self._merge_shared(net, shared_params)

        batch_size = max(1, min(int(self.knobs.get("batch_size", 128)),
                                ds.size))
        max_epochs = int(self.knobs.get("max_epochs", 5))
        if self.knobs.get("quick_train", False):
            max_epochs = min(max_epochs,
                             int(self.knobs.get("trial_epochs", 1)))
        steps_per_epoch = max(1, ds.size // batch_size)
        seed = int(self.knobs.get("seed", 0))
        opt = self.create_optimizer(list(net.parameters()),
                                    steps_per_epoch, max_epochs)

        # The whole dataset goes to the device once, as uint8.
        steps = _TrainSteps(self, net, opt,
                            torch.from_numpy(ds.images).to(self.device),
                            torch.from_numpy(ds.labels).to(self.device),
                            steps_per_epoch, batch_size)
        on_card = self.device.type == "cuda"
        meter = MfuMeter(
            6 * batch_size * self._macs(net, ds.image_shape) if on_card
            else 0, H100_PEAK_BF16_FLOPS if on_card else None)
        logger.define_plot("Training", ["loss", "train_acc", "chip_util"],
                           x_axis="epoch")
        early_stop = int(self.knobs.get("early_stop_epochs", 0))
        best_loss, bad_epochs = float("inf"), 0
        chunk_steps = max(1, min(steps_per_epoch, CHUNK_STEPS))
        first_chunk = True
        net.train()
        t0 = time.time()
        step = 0
        for epoch in range(max_epochs):
            order = epoch_rng(seed, epoch).permutation(ds.size)
            need = steps_per_epoch * batch_size
            if need > ds.size:
                # Tiny dataset: wrap so every epoch still takes full
                # batches.
                order = np.resize(order, need)
            steps.new_epoch(order[:need].reshape(steps_per_epoch,
                                                 batch_size))
            ep_loss, ep_acc, nw = 0.0, 0.0, 0
            s = 0
            while s < steps_per_epoch:
                k = min(chunk_steps, steps_per_epoch - s)
                for _ in range(k):
                    steps.step()
                loss_acc = steps.read_means(k)
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
            util = ({"chip_util": round(meter.mfu, 6)}
                    if meter.mfu is not None else {})
            logger.log(epoch=epoch, loss=ep_loss, train_acc=ep_acc,
                       steps_per_sec=step / (time.time() - t0), **util)
            if early_stop:
                if ep_loss < best_loss - 1e-4:
                    best_loss, bad_epochs = ep_loss, 0
                else:
                    bad_epochs += 1
                    if bad_epochs >= early_stop:
                        break
        steps.close()
        net.eval()
        self._net = net

    def _merge_shared(self, net: nn.Module, shared_params: Params) -> None:
        """Warm start: overlay the shared parameters whose flat name and
        shape match (ref ``_merge_shared``, :875-887)."""
        own = dense_to_jax(net.state_dict())
        take = {k: v for k, v in shared_params.items()
                if not k.startswith("_") and k in own
                and tuple(own[k].shape) == tuple(np.shape(v))}
        if take:
            net.load_state_dict(dense_from_jax(take), strict=False)
        logger.log(msg=f"warm-started {len(take)} shared tensors")

    # --- BaseModel: evaluate ---

    @torch.no_grad()
    def evaluate(self, dataset_path: str) -> float:
        net = self._require_net()
        ds = load_image_dataset(dataset_path)
        data = torch.from_numpy(ds.images).to(self.device)
        labels = torch.from_numpy(ds.labels).to(self.device)
        bs = min(EVAL_BATCH, ds.size)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for start in range(0, ds.size, bs):
            x = data[start:start + bs].float() / 255.0
            logits = self._logits(net, x)
            correct += (logits.argmax(-1) == labels[start:start + bs]).sum()
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
        outs = [self._predict_chunk(imgs[s:s + self.max_predict_batch])
                for s in range(0, imgs.shape[0], self.max_predict_batch)]

        def finish() -> List[Any]:
            return [p.tolist() for p in torch.cat(outs).cpu().numpy()]

        return finish

    def predict_proba(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, C) uint8 or normalised float32 images -> (N,
        n_classes) float32 probabilities."""
        self._require_net()
        if images.shape[0] == 0:
            return np.zeros((0, self._meta["n_classes"]), np.float32)
        return torch.cat([
            self._predict_chunk(images[s:s + self.max_predict_batch])
            for s in range(0, images.shape[0], self.max_predict_batch)
        ]).cpu().numpy()

    @torch.no_grad()
    def _predict_chunk(self, chunk: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        return torch.softmax(self._logits(self._net, x).float(), dim=-1)

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

    def destroy(self) -> None:
        self._net = None
        self._extra = None
