"""Attention ops of the port: the counterpart of ``ops/attention.py``.

All functions take ``(batch, heads, seq, head_dim)`` tensors, as the
reference does.

- ``naive_attention`` — the O(T²) numerical ground truth.
- ``flash_attention`` — flash attention with its gradient, the
  counterpart of the reference's ``_flash`` and its ``custom_vjp``. On
  CUDA tensors the forward launches K1 (``csrc/flash_fwd.cu``, the port
  of the Pallas ``_flash_kernel``; ``flash_forward_variant`` picks its
  variant by the shape) and the backward launches K2
  (``csrc/flash_bwd_dq.cu``, the port of ``_flash_dq_kernel``) and K3
  (``csrc/flash_bwd_dkv.cu``, the port of ``_flash_dkv_kernel``;
  ``flash_backward_variant`` picks the variant of both); on CPU tensors
  each runs its plain version. There is no fallback between the two: a
  CUDA tensor either reaches the kernels or the call raises.
- ``flash_attention_plain`` — the same function and gradient on the
  plain versions whatever the device, to hold the kernels' path against.
- ``flash_attention_reference`` — the plain version of K1: online softmax
  over kv tiles of ``BLOCK_KV`` keys, end-aligned causal masking, the
  same ``lse`` residual, the same tile skipping per ``BLOCK_Q`` query
  rows.
- ``flash_attention_dq_reference`` and ``flash_attention_dkv_reference``
  — the plain versions of K2 and K3: the softmax regenerated from the
  saved ``lse``, over the same tiles.

Masking follows the reference kernel. Out-of-range keys do not exist
for the softmax. A causally hidden key scores ``NEG_INF``; the
``kv_mask`` bias (0 or ``NEG_INF``) is added after that, so a key both
hidden and padded scores ``2·NEG_INF``. The running max starts at
``NEG_INF``. Hence a row whose every key is padded by ``kv_mask`` comes
out as the mean of ``v`` over the keys its causal window allows (all of
them when not causal), with ``lse ≈ NEG_INF``, exactly as the reference
kernel gives it where its blocks pad no key (its padded keys score
``NEG_INF`` and would join the mean). A row with no visible key for
another reason (left padding inside its causal window, or ``Tq > Tkv``)
depends on the tiling, in the reference as here.

The backward, like the reference's, keeps only the keys that are in
range, causally visible and kept by ``kv_mask``: on every other key the
regenerated ``p`` is zero (selected, never multiplied: there
``exp(s·scale − lse)`` may be ``inf``). So a row with no such key gets a
zero gradient and passes none to ``k`` and ``v``, where the naive
attention's gradient would spread its mean over them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# Large-negative instead of -inf: exp(NEG_INF - NEG_INF) must be finite
# for fully-masked rows (padding), where -inf would yield nan.
NEG_INF = -1e30

# The kernel's tiling (csrc/flash_fwd.cu: BQ, BKV; head dim <= 128). The
# plain version skips causal tiles at the same granularity, so the two
# agree even on the tiling-dependent rows described above.
BLOCK_Q = 64
BLOCK_KV = 64
MAX_HEAD_DIM = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The variants of K1, K2 and K3 (csrc/flash_*.cu), in the order of
# preference, with the codes their C entry points take: bf16 on `wgmma`
# fed by TMA, bf16 on `mma.sync` for what TMA cannot address, f32 on FMA.
VARIANTS = ("wgmma", "mma_sync", "f32")
_VARIANT_CODES = {"f32": 0, "mma_sync": 1, "wgmma": 2}


def naive_attention(q, k, v, *, causal: bool = False, kv_mask=None):
    """Reference O(T²) attention; the numerical ground truth for tests.

    ``kv_mask`` (B, Tkv) bool, True = real token.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        allowed = (torch.arange(tq, device=s.device)[:, None] + (tk - tq)
                   >= torch.arange(tk, device=s.device)[None, :])
        s = torch.where(allowed, s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.float()).to(q.dtype)


def _kv_bias(kv_mask) -> Optional[torch.Tensor]:
    """(B, Tkv) bool mask → f32 additive key bias, 0 or NEG_INF."""
    if kv_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=kv_mask.device)
    return torch.where(kv_mask, zero, NEG_INF).contiguous()


def _check(q, k, v, kv_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, T, D) tensors")
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    if k.shape != (b, h, tkv, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if tq < 1 or tkv < 1:
        raise ValueError("empty sequence")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside [1, {MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         "kernel takes float32 or bfloat16, all alike")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v on different devices")
    if kv_mask is not None:
        if kv_mask.shape != (b, tkv) or kv_mask.dtype != torch.bool:
            raise ValueError(f"kv_mask must be bool (B, Tkv) = {(b, tkv)}")
        if kv_mask.device != q.device:
            raise ValueError("kv_mask on another device than q")


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              kv_mask=None, return_lse: bool = False):
    """The plain PyTorch version of the K1 kernel.

    Online softmax over kv tiles of ``BLOCK_KV`` keys with f32 m/l/acc,
    scores ``q·k·scale`` in f32, ``p`` cast to ``v``'s dtype before
    ``p·v`` (f32 accumulate), ``o = acc / max(l, 1e-30)`` in ``q``'s
    dtype and ``lse = m + log(max(l, 1e-30))`` as (B, H, Tq) f32.
    Causal tiles are skipped per ``BLOCK_Q`` query rows as the kernel
    skips them.
    """
    _check(q, k, v, kv_mask)
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    shift = tkv - tq
    bias = _kv_bias(kv_mask)
    qf = q.float()
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    rows = torch.arange(tq, device=dev)
    # The last key any row of a row's q tile may see: the kernel walks
    # kv tiles up to it for the whole q tile.
    tile_last = torch.clamp((rows // BLOCK_Q + 1) * BLOCK_Q - 1,
                            max=tq - 1) + shift
    for j0 in range(0, tkv, BLOCK_KV):
        j1 = min(j0 + BLOCK_KV, tkv)
        need = None
        if causal:
            need = j0 <= tile_last                        # (Tq,)
            if not bool(need.any()):
                break
        s = torch.einsum("bhqd,bhkd->bhqk", qf,
                         k[:, :, j0:j1].float()) * scale
        if causal:
            cols = torch.arange(j0, j1, device=dev)
            s = torch.where(rows[:, None] + shift >= cols[None, :], s,
                            NEG_INF)
        if bias is not None:
            s = s + bias[:, None, None, j0:j1]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(),
            v[:, :, j0:j1].float())
        if need is None:
            m, l, acc = m_new, l_new, acc_new
        else:
            m = torch.where(need, m_new, m)
            l = torch.where(need, l_new, l)
            acc = torch.where(need[:, None], acc_new, acc)
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def _backward_tiles(q, k, v, do, lse, delta, causal: bool, kv_mask):
    """Per kv tile of ``BLOCK_KV`` keys ``j0:j1``: the regenerated
    softmax ``p = exp(s·scale − lse)`` and ``ds = p ⊙ (dp − delta)·scale``
    (f32) of query rows ``r0:`` against those keys, with ``dp = do·vᵀ``.
    ``p`` is zero on keys hidden by the causal mask or by ``kv_mask``.
    Under ``causal`` the rows start at the first ``BLOCK_Q`` tile that
    sees the kv tile, as the kernels skip tiles; yields
    ``(j0, j1, r0, p, ds)``."""
    _check(q, k, v, kv_mask)
    tq, d = q.shape[2], q.shape[3]
    tkv = k.shape[2]
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    shift = tkv - tq
    for j0 in range(0, tkv, BLOCK_KV):
        j1 = min(j0 + BLOCK_KV, tkv)
        r0 = 0
        if causal:
            # q tile i sees key j0 iff j0 <= (i + 1)·BLOCK_Q − 1 + shift.
            r0 = max(0, (j0 - shift) // BLOCK_Q) * BLOCK_Q
            if r0 >= tq:
                break
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:].float(),
                         k[:, :, j0:j1].float()) * scale
        p = torch.exp(s - lse[:, :, r0:, None])
        valid = None
        if causal:
            rows = torch.arange(r0, tq, device=dev)
            cols = torch.arange(j0, j1, device=dev)
            valid = rows[:, None] + shift >= cols[None, :]
        if kv_mask is not None:
            keep = kv_mask[:, None, None, j0:j1]
            valid = keep if valid is None else valid & keep
        if valid is not None:
            p = torch.where(valid, p, torch.zeros((), device=dev))
        dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, r0:].float(),
                          v[:, :, j0:j1].float())
        yield j0, j1, r0, p, p * (dp - delta[:, :, r0:, None]) * scale


def flash_attention_dq_reference(q, k, v, do, lse, delta, *,
                                 causal: bool = False, kv_mask=None):
    """The plain PyTorch version of the K2 kernel: ``dq`` in q's dtype,
    ``dq = Σ_tiles ds·k`` with ``ds`` cast to k's dtype and f32 sums."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j0, j1, r0, _, ds in _backward_tiles(q, k, v, do, lse, delta,
                                             causal, kv_mask):
        dq[:, :, r0:] += torch.einsum("bhqk,bhkd->bhqd",
                                      ds.to(k.dtype).float(),
                                      k[:, :, j0:j1].float())
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, *,
                                  causal: bool = False, kv_mask=None):
    """The plain PyTorch version of the K3 kernel: ``(dk, dv)`` in k's
    and v's dtypes, ``dv = pᵀ·do`` with ``p`` cast to do's dtype and
    ``dk = dsᵀ·q`` with ``ds`` cast to q's dtype, f32 sums."""
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for j0, j1, r0, p, ds in _backward_tiles(q, k, v, do, lse, delta,
                                             causal, kv_mask):
        dv[:, :, j0:j1] = torch.einsum("bhqk,bhqd->bhkd",
                                       p.to(do.dtype).float(),
                                       do[:, :, r0:].float())
        dk[:, :, j0:j1] = torch.einsum("bhqk,bhqd->bhkd",
                                       ds.to(q.dtype).float(),
                                       q[:, :, r0:].float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _launch(name: str, ins, bias, outs, causal: bool, extra=()) -> None:
    """Launch the kernel of ``csrc/<name>.cu`` on the current stream.

    ``ins`` are (name, tensor) pairs, q and k first; the C entry point
    takes the inputs, the bias, the outputs, then B, H, Tq, Tkv, D,
    causal, dtype, the ints of ``extra`` and the stream."""
    from ._build import load_kernel

    for what, t in ins:
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous for the kernel")
    q, k = ins[0][1], ins[1][1]
    b, h, tq, d = q.shape
    lib = load_kernel(name)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            *(t.data_ptr() for _, t in ins),
            None if bias is None else bias.data_ptr(),
            *(t.data_ptr() for t in outs),
            b, h, tq, k.shape[2], d, int(bool(causal)),
            _DTYPE_CODES[q.dtype], *extra,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _on_card(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _variant_takes(variant: str, q, *tensors) -> bool:
    """Whether a kernel's ``variant`` can take q and the other inputs it
    reads (k, v for K1; k, v, do for K2 and K3). TMA, which feeds the
    wgmma variants, needs 16-byte row strides (D % 8 == 0 in bf16) and
    16-byte aligned bases; the outputs come from the allocator, aligned."""
    if variant == "f32":
        return q.dtype == torch.float32
    if q.dtype != torch.bfloat16:
        return False
    if variant == "mma_sync":
        return True
    return q.shape[-1] % 8 == 0 and all(t.data_ptr() % 16 == 0
                                        for t in (q, *tensors))


def _pick(kernel: str, variant, q, *tensors) -> str:
    """``variant`` if ``kernel`` can take the inputs on it (``ValueError``
    if not), else the first of ``VARIANTS`` that can: the shape's own
    choice. Head dims up to ``MAX_HEAD_DIM`` (checked by every entry
    point) fit all three."""
    if variant is None:
        return next(x for x in VARIANTS if _variant_takes(x, q, *tensors))
    if variant not in VARIANTS or not _variant_takes(variant, q, *tensors):
        raise ValueError(f"{kernel} variant {variant!r} cannot take "
                         f"{q.dtype} head_dim {q.shape[-1]} at these "
                         "addresses")
    return variant


def flash_forward_variant(q, k, v) -> str:
    """The variant of K1 that ``flash_attention`` takes for these inputs."""
    return _pick("K1", None, q, k, v)


def flash_backward_variant(q, k, v, do) -> str:
    """The variant of K2 and K3 that ``flash_attention``'s backward takes
    for these inputs: the same rule, over q, k, v and do."""
    return _pick("K2/K3", None, q, k, v, do)


def _count(fn, variant: str) -> None:
    fn.launches += 1
    fn.variant_launches[variant] += 1


def _flash_forward(q, k, v, causal: bool, kv_mask, variant=None):
    """(o, lse): K1 on CUDA tensors, its plain version on CPU tensors.

    ``variant`` forces one of ``VARIANTS`` (for checks on the card); one
    that cannot take the inputs raises ``ValueError``. By default
    ``flash_forward_variant`` picks it."""
    variant = _pick("K1", variant, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         kv_mask=kv_mask, return_lse=True)
    _on_card(q)
    b, h, tq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", [("q", q), ("k", k), ("v", v)], _kv_bias(kv_mask),
            [o, lse], causal, (_VARIANT_CODES[variant],))
    _count(flash_attention, variant)
    return o, lse


def _check_backward(q, do, lse, delta) -> None:
    b, h, tq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must have q's shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (B, H, Tq)")


def _flash_dq(q, k, v, do, lse, delta, causal: bool, kv_mask,
              variant=None):
    """``dq``: K2 on CUDA tensors, its plain version on CPU tensors.
    ``variant`` forces one of ``VARIANTS``, as ``_flash_forward``'s does;
    by default ``flash_backward_variant`` picks it."""
    _check(q, k, v, kv_mask)
    _check_backward(q, do, lse, delta)
    variant = _pick("K2", variant, q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta,
                                            causal=causal, kv_mask=kv_mask)
    _on_card(q)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", [("q", q), ("k", k), ("v", v), ("do", do),
                             ("lse", lse), ("delta", delta)],
            _kv_bias(kv_mask), [dq], causal, (_VARIANT_CODES[variant],))
    _count(flash_attention_dq, variant)
    return dq


def _flash_dkv(q, k, v, do, lse, delta, causal: bool, kv_mask,
               variant=None):
    """``(dk, dv)``: K3 on CUDA tensors, its plain version on CPU
    tensors; ``variant`` as for ``_flash_dq``."""
    _check(q, k, v, kv_mask)
    _check_backward(q, do, lse, delta)
    variant = _pick("K3", variant, q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                             causal=causal, kv_mask=kv_mask)
    _on_card(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", [("q", q), ("k", k), ("v", v), ("do", do),
                              ("lse", lse), ("delta", delta)],
            _kv_bias(kv_mask), [dk, dv], causal, (_VARIANT_CODES[variant],))
    _count(flash_attention_dkv, variant)
    return dk, dv


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                       kv_mask=None):
    """``dq`` of flash attention from the forward's ``lse`` and
    ``delta = rowsum(do ⊙ o)``: the Hopper kernel K2 on CUDA tensors, on
    the variant ``flash_backward_variant`` picks
    (``flash_attention_dq.launches`` counts its launches, and by variant
    ``flash_attention_dq.variant_launches``), its plain version on CPU
    tensors."""
    return _flash_dq(q, k, v, do, lse, delta, causal, kv_mask)


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                        kv_mask=None):
    """``(dk, dv)`` of flash attention: the Hopper kernel K3 on CUDA
    tensors, on the variant ``flash_backward_variant`` picks
    (``flash_attention_dkv.launches`` and ``.variant_launches``), its
    plain version on CPU tensors."""
    return _flash_dkv(q, k, v, do, lse, delta, causal, kv_mask)


class _Flash(torch.autograd.Function):
    """Flash attention with its gradient, the counterpart of the
    reference's ``_flash`` and its ``custom_vjp``: the forward saves
    ``o`` and ``lse``, the backward regenerates the softmax from them.
    ``plain`` runs the plain versions whatever the device."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, plain):
        if plain:
            o, lse = flash_attention_reference(q, k, v, causal=causal,
                                               kv_mask=kv_mask,
                                               return_lse=True)
        else:
            o, lse = _flash_forward(q, k, v, causal, kv_mask)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.causal, ctx.plain = causal, plain
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        do = do.contiguous()
        # delta = rowsum(do ⊙ o) in f32, outside the kernels as in the
        # reference's ``_flash_backward``.
        delta = (do.float() * o.float()).sum(-1)
        if ctx.plain:
            dq_fn = flash_attention_dq_reference
            dkv_fn = flash_attention_dkv_reference
        else:
            dq_fn, dkv_fn = flash_attention_dq, flash_attention_dkv
        dq = dq_fn(q, k, v, do, lse, delta, causal=ctx.causal,
                   kv_mask=kv_mask)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, causal=ctx.causal,
                        kv_mask=kv_mask)
        # No gradient for the mask, as the reference gives none.
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, kv_mask=None,
                    return_lse: bool = False):
    """Flash attention: ``(o, lse)`` if ``return_lse`` else ``o``, with
    a gradient to q, k and v.

    CUDA tensors go to the Hopper kernels: K1 for the forward
    (``flash_attention.launches``, and by variant
    ``flash_attention.variant_launches``), K2 and K3 for the backward
    (counted on ``flash_attention_dq`` and ``flash_attention_dkv``); CPU
    tensors go to their plain versions. Any other device, dtype or shape
    the kernels do not take raises.
    """
    _check(q, k, v, kv_mask)
    o, lse = _Flash.apply(q, k, v, kv_mask, causal, False)
    return (o, lse) if return_lse else o


def flash_attention_plain(q, k, v, *, causal: bool = False, kv_mask=None,
                          return_lse: bool = False):
    """``flash_attention`` on the plain versions of K1, K2 and K3 on any
    device: what a check holds the kernels' path against."""
    _check(q, k, v, kv_mask)
    o, lse = _Flash.apply(q, k, v, kv_mask, causal, True)
    return (o, lse) if return_lse else o


for _fn in (flash_attention, flash_attention_dq, flash_attention_dkv):
    _fn.launches = 0
    _fn.variant_launches = dict.fromkeys(VARIANTS, 0)
