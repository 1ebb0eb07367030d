"""Pipeline parallelism: a GPipe microbatch schedule over ``pp`` stages.

The counterpart of ``rafiki_tpu/ops/pipeline.py``. Stage ``s`` holds
its layer span's parameters; microbatches stream through the stages
tick by tick. Plain GPipe over ``M`` microbatches and ``S`` stages:
``M + S - 1`` ticks, in tick ``t`` stage ``s`` runs microbatch ``t -
s``, and its output moves to stage ``s + 1``'s devices (the reference's
``ppermute``, here a copy that autograd carries back, so the backward is
the reverse schedule). The reference runs every stage every tick, on
garbage outside the window, for static shapes; one controller has no
need of that and runs only the ticks in the window.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..parallel.mesh import PP_AXIS, Mesh


def pipeline_apply(stage_fn: Callable[..., Any], stage_params: Sequence[Any],
                   x: Any, *, place: Optional[Callable[[Any, int], Any]] = None,
                   stage_takes_tick: bool = False) -> Any:
    """Run ``x`` through ``len(stage_params)`` pipeline stages (ref
    :30-110).

    ``stage_fn(params, mb)`` (or ``stage_fn(params, mb, t)`` with
    ``stage_takes_tick``, ``t`` the tick, what a stochastic stage keys
    its draws by) is one stage's computation; ``mb`` may be a tensor or
    a tree of tensors, and the stage returns the same structure and
    shapes. ``stage_params[s]`` is stage ``s``'s parameters. ``x`` is
    the microbatched input, leaves (M, mb, ...). ``place(tree, s)`` puts
    a microbatch on stage ``s``'s devices (default: where it is).

    Returns the last stage's outputs in ``x``'s structure, leaves (M,
    mb, ...), on the last stage's devices. Bool leaves stack as they
    are (the reference casts them only for its scatter-add)."""
    s_count = len(stage_params)
    leaves, spec = pytree.tree_flatten(x)
    m = leaves[0].shape[0]
    if place is None:
        place = lambda tree, s: tree  # noqa: E731

    def micro(i):
        return pytree.tree_unflatten([leaf[i] for leaf in leaves], spec)

    arriving = [None] * s_count
    outs = [None] * m
    for t in range(m + s_count - 1):
        nxt = [None] * s_count
        for s in range(s_count):
            mb = t - s
            if not 0 <= mb < m:
                continue
            inp = place(micro(mb), 0) if s == 0 else arriving[s]
            out = (stage_fn(stage_params[s], inp, t) if stage_takes_tick
                   else stage_fn(stage_params[s], inp))
            if s == s_count - 1:
                outs[mb] = out
            else:
                nxt[s + 1] = place(out, s + 1)
        arriving = nxt
    flat = [pytree.tree_flatten(o)[0] for o in outs]
    return pytree.tree_unflatten(
        [torch.stack([f[k] for f in flat]) for k in range(len(flat[0]))],
        spec)


def pipelined(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
              mesh: Mesh, *, n_microbatches: int):
    """``stage_fn`` as a full-batch pipelined apply on ``mesh``'s ``pp``
    axis (ref :113-146).

    Returns ``apply(stacked_params, batch)``: ``stacked_params`` is a
    tree whose leaves carry a leading stage axis of exactly
    ``mesh.shape["pp"]`` (stage ``s`` takes slice ``s`` on the device of
    coordinate (0, s, 0, 0, 0)); the batch's leading axis must divide
    into ``n_microbatches``. The output is on the last stage's device."""
    s_count = mesh.shape[PP_AXIS]
    devices = [mesh.device((0, s, 0, 0, 0)) for s in range(s_count)]

    def apply(stacked_params, batch):
        def unstack(a):
            # Exactly one slice a stage: more would drop layers.
            if a.shape[0] != s_count:
                raise ValueError(
                    f"stacked params have {a.shape[0]} stages for a "
                    f"pp={s_count} mesh; stack exactly pp stages (fold "
                    f"multiple layers into stage_fn instead)")
            return [a[s].to(devices[s], non_blocking=True)
                    for s in range(s_count)]

        p_leaves, p_spec = pytree.tree_flatten(stacked_params)
        per_leaf = [unstack(a) for a in p_leaves]
        params = [pytree.tree_unflatten([pl[s] for pl in per_leaf], p_spec)
                  for s in range(s_count)]
        b = batch.shape[0]
        if b % n_microbatches:
            raise ValueError(f"batch {b} does not divide into "
                             f"{n_microbatches} microbatches")
        xs = batch.reshape(n_microbatches, b // n_microbatches,
                           *batch.shape[1:])
        out = pipeline_apply(
            stage_fn, params, xs,
            place=lambda tree, s: pytree.tree_map(
                lambda a: a.to(devices[s], non_blocking=True), tree))
        return out.reshape(b, *out.shape[2:])

    return apply
