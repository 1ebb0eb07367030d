"""Switch-style mixture-of-experts FFN, with expert parallelism.

The counterpart of ``rafiki_tpu/ops/moe.py``: a top-1 (Switch) routed
expert feed-forward written as products over a leading expert axis.

Routing is group-local (the GShard/Switch formulation): tokens go in
fixed-size groups, each with its own capacity ``ceil(capacity_factor ·
group / E)`` a expert. A token past its expert's capacity is dropped:
its output row is zero, and the caller's residual passes it through.
Padding tokens (``token_mask`` False) claim no capacity, leave the
router statistics alone and get zero rows.

The reference partitions the expert stack over ``ep`` by sharding
annotations, or inside a ``shard_map`` with ``expert_axis``. Here
``expert_axis`` is the list of the ep ranks' devices and the weights
are the ranks' slices: each rank routes every token over all E experts
on its device, computes its slice's outputs at ``offset = rank ·
E_local``, and the partials are summed on the tokens' device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _switch_group(x, mask, gate_w, w1, b1, w2, b2, offset: int, *,
                  capacity: int):
    """Route token groups. x (n_groups, G, D); mask (n_groups, G) float,
    1 for a real token. The leading group axis stands for the
    reference's ``vmap`` over groups.

    Routing runs over all ``gate_w.shape[1]`` experts; ``w1`` … ``b2``
    may be a slice of ``w1.shape[1]`` experts from ``offset`` (a rank of
    the expert-parallel path), else the whole stack at offset 0. Returns
    (out (n_groups, G, D) in x's dtype, aux (n_groups,))."""
    e = gate_w.shape[1]
    e_loc = w1.shape[0]
    logits = torch.einsum("gnd,de->gne", x.float(), gate_w.float())
    probs = torch.softmax(logits, dim=-1)                   # (g, G, E)
    expert = probs.argmax(dim=-1)                           # (g, G)
    gate = probs.gather(-1, expert[..., None])[..., 0]
    onehot = F.one_hot(expert, e).float() * mask[..., None]

    # Slot of each token within its expert (first come, first served).
    position = torch.cumsum(onehot, dim=1) * onehot - 1.0   # (g, G, E)
    in_cap = (position >= 0) & (position < capacity)
    dispatch = onehot * in_cap
    slots = F.one_hot(position.clamp(0, capacity - 1).long(),
                      capacity).float()                      # (g, G, E, C)
    disp = (slots * dispatch[..., None])[:, :, offset:offset + e_loc]

    xe = torch.einsum("gnec,gnd->gecd", disp, x.float()).to(x.dtype)
    h = torch.einsum("gecd,edf->gecf", xe, w1) + b1[None, :, None]
    h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("gecf,efd->gecd", h, w2) + b2[None, :, None]
    combine = disp * gate[..., None, None]
    out = torch.einsum("gnec,gecd->gnd", combine, ye.float()).to(x.dtype)

    # The Switch load-balance loss over real tokens: E · Σ_e (token
    # share) · (probability share); ≈ 1 at uniform routing.
    denom = mask.sum(dim=1).clamp_min(1.0)[:, None]
    frac_tokens = onehot.sum(dim=1) / denom
    frac_probs = (probs * mask[..., None]).sum(dim=1) / denom
    aux = e * (frac_tokens * frac_probs).sum(dim=-1)
    return out, aux


def switch_moe(x, gate_w, w1, b1, w2, b2, *, capacity_factor: float = 1.25,
               token_mask: Optional[torch.Tensor] = None,
               group_size: int = 1024,
               expert_axis: Optional[Sequence[torch.device]] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routed expert FFN over flattened tokens (ref :71-146).

    ``x`` (N, D) tokens; ``gate_w`` (D, E) router weights (routing in
    f32; E is the global expert count); ``w1``, ``b1`` (E, D, F), (E, F)
    and ``w2``, ``b2`` (E, F, D), (E, D), the products run in their
    dtype. ``token_mask`` (N,) bool, True for a real token. With
    ``expert_axis``, the devices of the ep ranks, ``w1`` … ``b2`` are
    sequences of the ranks' slices (E / ep experts each, on those
    devices).

    Returns ``(out, aux)``: (N, D) combined outputs (zero rows for
    dropped and masked tokens) and the mean load-balance loss over the
    groups."""
    n, d = x.shape
    e = gate_w.shape[1]
    if token_mask is None:
        token_mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    g = min(group_size, n)
    n_groups = -(-n // g)
    pad = n_groups * g - n
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        token_mask = F.pad(token_mask, (0, pad))
    capacity = max(1, math.ceil(capacity_factor * g / e))
    xg = x.reshape(n_groups, g, d)
    mg = token_mask.reshape(n_groups, g).float()
    if expert_axis is None:
        out, aux = _switch_group(xg, mg, gate_w, w1, b1, w2, b2, 0,
                                 capacity=capacity)
    else:
        parts = []
        for rank, dev in enumerate(expert_axis):
            ws = [w[rank] for w in (w1, b1, w2, b2)]
            part, aux_r = _switch_group(
                xg.to(dev, non_blocking=True), mg.to(dev, non_blocking=True),
                gate_w.to(dev, non_blocking=True), *ws,
                rank * ws[0].shape[0], capacity=capacity)
            parts.append(part.to(x.device, non_blocking=True))
            if rank == 0:
                # The router statistics are global: every rank's equal.
                aux = aux_r.to(x.device, non_blocking=True)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
    return out.reshape(n_groups * g, d)[:n], aux.mean()
