"""The optimizers of the port's train loops.

The reference's language model trains with ``optax.adamw`` under
``optax.warmup_cosine_decay_schedule``. The port pairs
``torch.optim.AdamW`` at optax's defaults (``betas=(0.9, 0.999)``,
``eps=1e-8``, ``weight_decay=1e-4``; torch's own default decay is 0.01)
with the same schedule, evaluated at the update count from 0 as optax
evaluates it.

The reference's image models (``JaxModel``) train with Adam under a
cosine decay to ``alpha`` 0.01 over every step of the run, scaled by the
trial's learning rate (``jax_model.py:373-381`` and ``:412-448``).
``ScheduledOptimizer`` is their counterpart: optax's ``scale_by_adam``
puts eps outside the square root, as ``torch.optim.Adam`` does, and
``scale_by_schedule`` evaluates the schedule at the update count
*before* its increment (0 on the first step), so the lr of update ``k``
(from 0) is ``learning_rate * schedule(k)``. Their weight decay (ViT's,
the CNN's) is ``add_decayed_weights`` chained before ``scale_by_adam``:
L2 decay coupled into Adam's moments, ``torch.optim.Adam``'s
``weight_decay`` (``scheduled_adam``). The transformer tagger trains
with ``optax.adamw``, decoupled decay under the warm-up cosine:
``torch.optim.AdamW`` (``scheduled_adamw``).

The conv zoo trains with SGD under Nesterov momentum: DenseNet with
``traced_hyperparam_optimizer(opt="sgdm", warmup=True,
weight_decay=True)`` (``jax_model.py:412-448``), ENAS's child models
with ``add_decayed_weights(1e-4)`` and ``optax.sgd(momentum=0.9,
nesterov=True)`` under a cosine decay (``models/enas.py:254-264``).
optax's ``trace`` keeps ``t = g + 0.9·t`` and its Nesterov update is
``g + 0.9·t``, both on the decayed but unscaled gradient, and the
schedule multiplies after: ``NesterovSGD`` is that update, written out
(``scheduled_sgd`` puts it under a schedule).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (which counts the warmup), as optax defines it."""
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError("the cosine decay requires positive decay_steps, "
                         f"got {cosine_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``init_value`` times a cosine from 1 down to ``alpha`` over
    ``decay_steps``, then ``alpha``, as optax defines it."""
    if not decay_steps > 0:
        raise ValueError("the cosine decay requires positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


class ScheduledOptimizer:
    """A torch optimizer whose lr is ``peak_lr * schedule(count)``,
    set before each step from the number of steps taken so far.

    On the card the optimizer holds its lr as a device tensor
    (``fused`` and ``capturable``), so that a CUDA graph can capture
    ``device_step``: it reads the lr from a device table of the schedule
    at a device step counter. ``step`` writes the same f32 value into
    that tensor from the host, so both give the same updates."""

    def __init__(self, opt: torch.optim.Optimizer, peak_lr: float,
                 schedule: Schedule, total_steps: int):
        self.opt = opt
        self.peak_lr = float(peak_lr)
        self.schedule = schedule
        self.total_steps = int(total_steps)
        self.count = 0
        lr = opt.param_groups[0]["lr"]
        self._lr = lr if isinstance(lr, torch.Tensor) else None
        self._table: Optional[torch.Tensor] = None
        self._count: Optional[torch.Tensor] = None
        if self._lr is not None:
            # Made before any capture: a graph cannot copy from the host.
            self._table = torch.tensor(
                [self.peak_lr * schedule(k)
                 for k in range(self.total_steps + 1)],
                dtype=self._lr.dtype, device=self._lr.device)
            self._count = torch.zeros((), dtype=torch.int64,
                                      device=self._lr.device)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.peak_lr * self.schedule(self.count)
        if self._lr is None:
            for group in self.opt.param_groups:
                group["lr"] = lr
        else:
            self._lr.fill_(lr)
            self._count.add_(1)
        self.opt.step()
        self.count += 1

    def device_step(self) -> None:
        """``step`` with the count and the lr on the device, for capture
        in a CUDA graph; it continues from the steps taken by ``step``.
        The schedule is constant past ``total_steps``."""
        if self._lr is None:
            raise RuntimeError("the optimizer's lr is not a device tensor")
        at = torch.clamp(self._count, max=self.total_steps).view(1)
        self._lr.copy_(self._table.index_select(0, at).view(()))
        self.opt.step()
        self._count.add_(1)

    # --- Checkpoint state ---

    def steps_taken(self) -> int:
        """Updates so far: the device count on the card (replays of a
        captured ``device_step`` advance only that), else the host's."""
        return int(self._count) if self._count is not None else self.count

    def set_steps_taken(self, n: int) -> None:
        self.count = int(n)
        if self._count is not None:
            self._count.fill_(int(n))

    def state_tensors(self):
        """The inner optimizer's state tensors in a fixed order (by
        parameter, then by key), created first where no step has run
        yet (``prime_state``), so that a resume can copy into them
        before the first step and before a capture."""
        self.prime_state()
        out = []
        for group in self.opt.param_groups:
            for p in group["params"]:
                st = self.opt.state.get(p, {})
                out.extend(st[k] for k in sorted(st)
                           if isinstance(st[k], torch.Tensor))
        return out

    def prime_state(self) -> None:
        """The state each parameter's first step would create, made now:
        Adam's and AdamW's ``step`` (an f32 scalar, on the parameter's
        device when fused or capturable, else on the CPU) and zero
        moments for each parameter that takes gradients, as
        ``torch.optim.Adam._init_group`` makes them; ``NesterovSGD``'s
        zero ``trace`` for each parameter. A zero state is what the
        first step would start from, so a primed run steps as an
        unprimed one."""
        for group in self.opt.param_groups:
            for p in group["params"]:
                st = self.opt.state[p]
                if st:
                    continue
                if isinstance(self.opt, NesterovSGD):
                    st["trace"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                elif isinstance(self.opt, (torch.optim.Adam,
                                           torch.optim.AdamW)):
                    if not p.requires_grad:
                        del self.opt.state[p]
                        continue
                    on_dev = group["capturable"] or group["fused"]
                    st["step"] = torch.zeros(
                        (), dtype=torch.float32,
                        device=p.device if on_dev else "cpu")
                    for k in ("exp_avg", "exp_avg_sq") + (
                            ("max_exp_avg_sq",) if group["amsgrad"]
                            else ()):
                        st[k] = torch.zeros_like(
                            p, memory_format=torch.preserve_format)
                else:
                    raise TypeError(f"no checkpoint state for "
                                    f"{type(self.opt).__name__}")


def _adam_kwargs(params, peak_lr: float):
    """Adam's settings at optax's defaults and its lr: on the card a
    device tensor of a fused, capturable optimizer, else a value."""
    kw = dict(betas=(0.9, 0.999), eps=1e-8)
    device = params[0].device
    if device.type == "cuda":
        kw.update(fused=True, capturable=True)
        return torch.tensor(float(peak_lr), dtype=torch.float32,
                            device=device), kw
    return float(peak_lr), kw


def scheduled_adam(params: Iterable[torch.nn.Parameter], peak_lr: float,
                   total_steps: int, weight_decay: float = 0.0
                   ) -> ScheduledOptimizer:
    """``traced_hyperparam_optimizer(opt="adam")`` (``jax_model.py:
    412-448``): Adam at optax's defaults under the cosine decay to
    ``alpha`` 0.01 over ``total_steps``. With ``weight_decay`` it is the
    reference's ``weight_decay=True`` chain, ``add_decayed_weights(wd)``
    *before* ``scale_by_adam``: L2 decay added to the gradient, so it
    passes through Adam's moments. That is ``torch.optim.Adam``'s
    ``weight_decay``, not AdamW's decoupled decay (``scheduled_adamw``).
    On the card the update runs as torch's fused kernel, with the lr a
    device tensor that a CUDA graph can capture."""
    params = list(params)
    total_steps = max(1, total_steps)
    lr, kw = _adam_kwargs(params, peak_lr)
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay, **kw)
    return ScheduledOptimizer(
        opt, peak_lr, cosine_decay_schedule(1.0, total_steps, alpha=0.01),
        total_steps)


def scheduled_adamw(params: Iterable[torch.nn.Parameter], peak_lr: float,
                    schedule: Schedule, total_steps: int,
                    weight_decay: float) -> ScheduledOptimizer:
    """``optax.adamw(peak_lr · schedule, weight_decay=wd)``: decoupled
    decay, ``p -= lr_k · (adam(g) + wd · p)``, which is
    ``torch.optim.AdamW``'s update (``p · (1 − lr_k · wd)`` then the Adam
    step) with lr ``peak_lr * schedule(k)``; fused and capturable on the
    card, as ``scheduled_adam``."""
    params = list(params)
    lr, kw = _adam_kwargs(params, peak_lr)
    opt = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay, **kw)
    return ScheduledOptimizer(opt, peak_lr, schedule, max(1, total_steps))


class NesterovSGD(torch.optim.Optimizer):
    """optax's ``chain(add_decayed_weights(wd), trace(momentum,
    nesterov=True), <schedule>, scale(-1))``: ``g = grad + wd·p``,
    ``t = g + momentum·t`` (``t`` starts at zero), ``p -= lr·(g +
    momentum·t)``. ``lr`` may be a device tensor, which a CUDA graph
    reads at each replay. A parameter without a gradient steps as if
    its gradient were zero, as every leaf of an optax tree does."""

    def __init__(self, params, lr, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None) -> None:
        for group in self.param_groups:
            ps = group["params"]
            gs = [p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in ps]
            if group["weight_decay"]:
                gs = torch._foreach_add(gs, ps,
                                        alpha=group["weight_decay"])
            bufs = []
            for p in ps:
                st = self.state[p]
                if "trace" not in st:
                    st["trace"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                bufs.append(st["trace"])
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, gs)
            upd = torch._foreach_add(gs, bufs, alpha=group["momentum"])
            torch._foreach_mul_(upd, group["lr"])
            torch._foreach_sub_(ps, upd)


def scheduled_sgd(params: Iterable[torch.nn.Parameter], peak_lr: float,
                  schedule: Schedule, total_steps: int,
                  weight_decay: float = 0.0) -> ScheduledOptimizer:
    """``NesterovSGD`` (momentum 0.9) with lr ``peak_lr *
    schedule(count)``; on the card the lr is a device tensor, so that
    the step can be captured."""
    params = list(params)
    device = params[0].device
    lr = (torch.tensor(float(peak_lr), dtype=torch.float32, device=device)
          if device.type == "cuda" else float(peak_lr))
    return ScheduledOptimizer(
        NesterovSGD(params, lr, momentum=0.9, weight_decay=weight_decay),
        peak_lr, schedule, max(1, total_steps))


def adamw(params: Iterable[torch.nn.Parameter], lr: float
          ) -> torch.optim.AdamW:
    """AdamW with optax ``adamw``'s defaults."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
