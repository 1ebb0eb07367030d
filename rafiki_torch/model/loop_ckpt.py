"""Checkpoint resume and data order of the port's train loops.

The port's copy of ``rafiki_tpu/model/loop_ckpt.py``: ``epoch_rng``,
``schedule_epochs`` and ``LoopCheckpointer``, the train-kwargs contract
``checkpoint_dir`` / ``checkpoint_every_epochs`` /
``checkpoint_final_epoch`` / ``schedule_total_epochs`` that
``TorchModel.train``, the corpus taggers and the tabular MLPs share, so
that ASHA's scoped rung resume (``advisor/asha.py``) and the runner's
crash resume work across the trainable zoo.

Where the reference checkpoints a pytree, the port's state is an
ordered list of tensors (``TrainState``): the module's ``state_dict``
(buffers included), the optimizer's state, ``ScheduledOptimizer``'s
update count and the loop's hash counter (the step number that the
augmentation and dropout draws hash). A resume copies the saved values
into those tensors in place, before the first step, so that a train
step captured afterwards as a CUDA graph reads them. The files are the
reference's format: positional ``leaf_<i>`` arrays written by
``store.CheckpointManager``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .logger import logger
from .optim import ScheduledOptimizer

_log = logging.getLogger(__name__)


def schedule_epochs(kwargs: Dict[str, Any], max_epochs: int) -> int:
    """The lr schedule's horizon in epochs: ``schedule_total_epochs``
    (ASHA pins it to the ladder's top budget, so that every rung steps
    on one schedule) floored at the run's ``max_epochs``."""
    return max(int(kwargs.get("schedule_total_epochs", 0) or 0),
               max_epochs)


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """Per-epoch host RNG: epoch k's data order is a pure function of
    (seed, k), so a run resumed at epoch k visits the same data as an
    uninterrupted run, and both packages cut the same windows."""
    return np.random.default_rng((int(seed) + 1) * 100003 + epoch)


class TrainState:
    """The tensors a train loop resumes from, in a fixed order: the
    module's ``state_dict`` values (aliases of its parameters and
    buffers), the optimizer's state (primed, so that it exists before
    the first step), its update count and, when given, the loop's
    device step counter."""

    def __init__(self, net: nn.Module, opt: ScheduledOptimizer,
                 counter: Optional[torch.Tensor] = None):
        self.opt = opt
        self.counter = counter
        self.tensors: List[torch.Tensor] = (
            list(net.state_dict().values()) + opt.state_tensors())

    def __len__(self) -> int:
        return len(self.tensors) + 1 + (self.counter is not None)

    def arrays(self) -> Dict[str, np.ndarray]:
        vals = [t.detach().cpu().numpy() for t in self.tensors]
        vals.append(np.asarray(self.opt.steps_taken(), np.int64))
        if self.counter is not None:
            vals.append(self.counter.detach().cpu().numpy())
        return {f"leaf_{i}": v for i, v in enumerate(vals)}

    @torch.no_grad()
    def load(self, arrays: Dict[str, np.ndarray]) -> None:
        """Copy ``leaf_<i>`` into the tensors in place; a leaf that does
        not reshape to its tensor's shape raises ``ValueError`` before
        any tensor is written. safetensors round-trips a 0-d array as
        shape () or (1,); both reshape."""
        targets = self.tensors + [None] + (
            [self.counter] if self.counter is not None else [])
        vals = []
        for i, t in enumerate(targets):
            a = np.asarray(arrays[f"leaf_{i}"])
            vals.append(a.reshape(()) if t is None else a.reshape(t.shape))
        for t, a in zip(targets, vals):
            if t is None:
                self.opt.set_steps_taken(int(a))
            else:
                t.copy_(torch.from_numpy(np.array(a)).to(t.dtype))


class LoopCheckpointer:
    """Save and restore of a ``TrainState`` for the port's train loops,
    with the reference's fallbacks: a snapshot of another structure (a
    different knob configuration reusing the directory) or one swept
    away mid-read logs a warning and starts fresh, and a failed save
    never errors the trial that trained fine. ``extras`` are arrays
    saved beside the leaves (``TorchModel``'s early-stop counters)."""

    def __init__(self, kwargs: Dict[str, Any]):
        self._dir = kwargs.get("checkpoint_dir")
        self._every = int(kwargs.get("checkpoint_every_epochs", 1))
        self._final = bool(kwargs.get("checkpoint_final_epoch"))
        self._mgr = None
        if self._dir and self._every > 0:
            from ..store.checkpoint import CheckpointManager

            self._mgr = CheckpointManager(self._dir)

    @property
    def enabled(self) -> bool:
        return self._mgr is not None

    def restore(self, state: TrainState
                ) -> Tuple[int, Dict[str, np.ndarray]]:
        """``(start_epoch, extras)``: the epoch after the snapshot's and
        its non-leaf arrays, or ``(0, {})`` for a fresh start."""
        if self._mgr is None or self._mgr.latest_step() is None:
            return 0, {}
        try:
            saved_epoch, arrays = self._mgr.restore()
        except OSError:
            _log.warning("checkpoint in %s vanished mid-restore; "
                         "starting fresh", self._dir)
            return 0, {}
        n_saved = sum(1 for k in arrays if k.startswith("leaf_"))
        if n_saved != len(state):
            _log.warning("checkpoint in %s has %d leaves, model has %d; "
                         "starting fresh", self._dir, n_saved, len(state))
            return 0, {}
        try:
            state.load(arrays)
        except (ValueError, KeyError):
            _log.warning("checkpoint in %s has incompatible leaf shapes; "
                         "starting fresh", self._dir)
            return 0, {}
        logger.log(msg=f"resumed from checkpoint epoch {saved_epoch}")
        return saved_epoch + 1, {k: v for k, v in arrays.items()
                                 if not k.startswith("leaf_")}

    def after_epoch(self, epoch: int, state: TrainState, max_epochs: int,
                    extras: Optional[Dict[str, np.ndarray]] = None) -> None:
        """The in-loop cadence save; it skips the last epoch (see
        ``after_loop``)."""
        if self._mgr is not None and (epoch + 1) % self._every == 0 \
                and epoch + 1 < max_epochs:
            self._save(epoch, state, extras)

    def after_loop(self, last_epoch: Optional[int], state: TrainState,
                   extras: Optional[Dict[str, np.ndarray]] = None) -> None:
        """The final save, only with ``checkpoint_final_epoch``: a
        successive-halving rung resumes exactly this state, and saving
        after the loop covers an early-stop break and a ``max_epochs``
        that is not a multiple of the cadence."""
        if self._mgr is not None and self._final and last_epoch is not None:
            self._save(last_epoch, state, extras)

    def _save(self, epoch: int, state: TrainState,
              extras: Optional[Dict[str, np.ndarray]]) -> None:
        arrays = state.arrays()
        arrays.update(extras or {})
        try:
            self._mgr.save(epoch, arrays)
        except OSError:
            # A checkpoint is an optimisation, never the result: losing
            # it means the next resume starts fresh.
            _log.warning("checkpoint save to %s failed; continuing "
                         "without it", self._dir, exc_info=True)
