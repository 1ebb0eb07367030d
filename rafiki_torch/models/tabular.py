"""TorchTabMlpClf and TorchTabMlpReg: the ports of ``JaxTabMlpClf`` and
``JaxTabMlpReg``.

The counterpart of ``rafiki_tpu/models/tabular.py:36-266``: the same
knob config; ``_Mlp``, ``depth`` hidden ``Dense`` layers of ``hidden``
units with ReLU and a ``Dense`` to the output, all in f32; features
standardised by the training set's mean and ``std + 1e-6``, kept in
``_meta/json`` with the output width and the feature names; Adam under
a cosine decay to ``alpha`` 0.01 with no weight decay (ref :134-135);
cross-entropy for the classifier and MSE for the regressor; the
schedule over ``schedule_total_epochs`` when given and checkpoint
resume under ``checkpoint_dir`` (``loop_ckpt``, ref :125, :161).
``train`` accepts ``shared_params`` and ignores it, as the reference
does: a trial starts from the model's own initialisation.
``evaluate`` is accuracy or R²; ``predict`` gives class probabilities or
one float a row, from batches padded to a power of two. The ``mesh``
(ref :76-79) is data-parallel over the devices of the group bound to the
thread, or the model's device alone: the batch is rounded down to a
multiple of dp (at least dp) and each rank runs its rows through its
replica of the MLP on its device, the loss the whole batch's mean.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..model import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.base import BaseModel, Params
from ..model.bridge import dense_from_jax, dense_to_jax
from ..model.dataset import load_tabular_dataset
from ..model.logger import logger
from ..model.loop_ckpt import (LoopCheckpointer, TrainState, epoch_rng,
                               schedule_epochs)
from ..model.optim import scheduled_adam
from ..parallel.data import group_mesh, mesh_apply, sum_grads
from ..parallel.mesh import Mesh
from ..torchenv import DeviceLike, resolve_device
from .layers import Dense


class _Mlp(nn.Module):
    def __init__(self, in_features: int, hidden: Sequence[int],
                 out_dim: int, seed: int):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        widths = [in_features, *hidden, out_dim]
        self.n = len(widths) - 1
        for i in range(self.n):
            setattr(self, f"Dense_{i}",
                    Dense(widths[i], widths[i + 1], gen, f32=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n - 1}")(x)


class _TabBase(BaseModel):
    """Shared train and predict code; subclasses fix the objective."""

    regression = False

    @staticmethod
    def get_knob_config():
        return {
            "hidden": IntegerKnob(16, 256),
            "depth": IntegerKnob(1, 3),
            "learning_rate": FloatKnob(1e-4, 3e-2, is_exp=True),
            "batch_size": CategoricalKnob([32, 64, 128]),
            "max_epochs": IntegerKnob(5, 40),
            "seed": FixedKnob(0),
        }

    def __init__(self, *, device: DeviceLike = None, **knobs: Any):
        super().__init__(**knobs)
        self.device = resolve_device(device)
        self._net: Optional[_Mlp] = None
        self._meta: Dict[str, Any] = {}
        self._mesh: Optional[Mesh] = None

    @property
    def mesh(self) -> Mesh:
        """The data-parallel mesh over the devices of the group bound to
        the thread, or over the model's device alone (ref :76-79)."""
        if self._mesh is None:
            self._mesh = group_mesh(self.device)
        return self._mesh

    def _apply(self, net: _Mlp, x: torch.Tensor) -> torch.Tensor:
        """``net`` on the rows of ``x``: on the model's device, or each
        dp rank's rows through its replica on its device (ref :160), the
        outputs gathered here."""
        if self.mesh.size == 1:
            return net(x)
        return mesh_apply(self.mesh, net, x.shape[0],
                          lambda dev, lo, hi: (x[lo:hi].to(
                              dev, non_blocking=True),), self.device)

    def _new_net(self) -> _Mlp:
        hidden = [int(self.knobs.get("hidden", 64))] \
            * int(self.knobs.get("depth", 2))
        return _Mlp(int(self._meta["n_features"]), hidden,
                    int(self._meta["out_dim"]),
                    int(self.knobs.get("seed", 0))).to(self.device)

    def _standardize(self, x: np.ndarray) -> np.ndarray:
        mean = np.asarray(self._meta["mean"], np.float32)
        std = np.asarray(self._meta["std"], np.float32)
        return (x - mean) / std

    def _require_net(self) -> _Mlp:
        if self._net is None:
            raise RuntimeError("train() or load_parameters() first")
        return self._net

    def train(self, dataset_path: str, *,
              shared_params: Optional[Params] = None, **kwargs: Any) -> None:
        ds = load_tabular_dataset(dataset_path)
        if self.regression:
            out_dim = 1
            targets = ds.targets.astype(np.float32)
        else:
            if ds.n_classes is None:
                raise ValueError("classification model given a "
                                 "regression-target dataset")
            out_dim = int(ds.n_classes)
            targets = ds.targets.astype(np.int64)
        mean = ds.features.mean(axis=0)
        std = ds.features.std(axis=0) + 1e-6
        self._meta = {"out_dim": out_dim, "n_features": ds.features.shape[1],
                      "mean": mean.tolist(), "std": std.tolist(),
                      "feature_names": list(ds.feature_names)}
        net = self._new_net()
        dev = self.device
        x = torch.from_numpy(self._standardize(ds.features)).to(dev)
        y = torch.from_numpy(targets).to(dev)

        dp = self.mesh.shape["dp"]
        # A multiple of dp, at least dp (ref :117-118).
        batch_size = min(int(self.knobs.get("batch_size", 64)), ds.size)
        batch_size = max(dp, (batch_size // dp) * dp)
        max_epochs = int(self.knobs.get("max_epochs", 20))
        if self.knobs.get("quick_train", False):
            max_epochs = min(max_epochs,
                             int(self.knobs.get("trial_epochs", 1)))
        steps = max(1, ds.size // batch_size)
        opt = scheduled_adam(list(net.parameters()),
                             float(self.knobs.get("learning_rate", 1e-3)),
                             steps * schedule_epochs(kwargs, max_epochs))
        seed = int(self.knobs.get("seed", 0))
        logger.define_plot("Training", ["loss"], x_axis="epoch")
        ckpt = LoopCheckpointer(kwargs)
        state = TrainState(net, opt) if ckpt.enabled else None
        start_epoch = ckpt.restore(state)[0] if state is not None else 0
        last_epoch = None
        for epoch in range(start_epoch, max_epochs):
            order = epoch_rng(seed, epoch).permutation(ds.size)
            if steps * batch_size > ds.size:
                order = np.resize(order, steps * batch_size)
            order_d = torch.from_numpy(
                order[:steps * batch_size].reshape(steps, batch_size)).to(dev)
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for s in range(steps):
                sel = order_d[s]
                opt.zero_grad()
                out = self._apply(net, x[sel])
                if self.regression:
                    loss = torch.mean((out[:, 0] - y[sel]) ** 2)
                else:
                    loss = F.cross_entropy(out, y[sel])
                loss.backward()
                sum_grads(self.mesh, net.parameters())
                opt.step()
                total += loss.detach()
            logger.log(epoch=epoch, loss=float(total) / steps)
            last_epoch = epoch
            if state is not None:
                ckpt.after_epoch(epoch, state, max_epochs)
        if state is not None:
            ckpt.after_loop(last_epoch, state)
        self._net = net

    @torch.no_grad()
    def _forward(self, features: np.ndarray) -> np.ndarray:
        """Probabilities (or regression values) of standardised rows,
        the batch padded with zero rows to a power of two."""
        net = self._require_net()
        x = self._standardize(np.asarray(features, np.float32))
        n = x.shape[0]
        bucket = 1
        while bucket < n:
            bucket *= 2
        if n < bucket:
            x = np.concatenate([x, np.zeros((bucket - n, x.shape[1]),
                                            x.dtype)])
        out = self._apply(net, torch.from_numpy(x).to(self.device))
        out = out[:, 0] if self.regression else torch.softmax(out, -1)
        return out[:n].cpu().numpy()

    def evaluate(self, dataset_path: str) -> float:
        ds = load_tabular_dataset(dataset_path)
        out = self._forward(ds.features)
        if self.regression:
            y = ds.targets.astype(np.float64)
            ss_res = float(((out - y) ** 2).sum())
            ss_tot = float(((y - y.mean()) ** 2).sum()) + 1e-12
            return 1.0 - ss_res / ss_tot  # R^2: higher is better
        return float((out.argmax(-1) == ds.targets).mean())

    def predict(self, queries: List[Any]) -> List[Any]:
        self._require_net()
        if not queries:
            return []
        out = self._forward(np.stack([np.asarray(q, np.float32).reshape(-1)
                                      for q in queries]))
        if self.regression:
            return [float(v) for v in out]
        return [p.tolist() for p in out]

    def dump_parameters(self) -> Params:
        out = dense_to_jax(self._require_net().state_dict())
        out["_meta/json"] = np.frombuffer(json.dumps(self._meta).encode(),
                                          np.uint8)
        return out

    def load_parameters(self, params: Params) -> None:
        blob = params.get("_meta/json")
        if blob is None:
            raise ValueError("params missing _meta/json")
        self._meta = json.loads(np.asarray(blob).tobytes().decode())
        net = self._new_net()
        net.load_state_dict(dense_from_jax(params))
        self._net = net

    def destroy(self) -> None:
        self._net = None


class TorchTabMlpClf(_TabBase):
    """MLP classifier over tabular rows (TABULAR_CLASSIFICATION)."""

    regression = False


class TorchTabMlpReg(_TabBase):
    """MLP regressor over tabular rows (TABULAR_REGRESSION)."""

    regression = True
