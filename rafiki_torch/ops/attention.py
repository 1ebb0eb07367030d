"""Attention ops of the port: the counterpart of ``ops/attention.py``.

All functions take ``(batch, heads, seq, head_dim)`` tensors, as the
reference does.

- ``naive_attention`` — the O(T²) numerical ground truth.
- ``flash_attention`` — the flash-attention forward. On a CUDA tensor it
  launches the hand-written Hopper kernel ``csrc/flash_fwd.cu`` (K1, the
  port of the reference's Pallas ``_flash_kernel``); on a CPU tensor it
  runs ``flash_attention_reference``, the same algorithm in PyTorch ops.
  There is no fallback between the two: a CUDA tensor either reaches the
  kernel or the call raises.
- ``flash_attention_reference`` — the plain version of K1: online softmax
  over kv tiles of ``BLOCK_KV`` keys, end-aligned causal masking, the
  same ``lse`` residual, the same tile skipping per ``BLOCK_Q`` query
  rows.

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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _launch(q, k, v, bias, causal: bool) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Launch K1 on the current stream; returns (o, lse)."""
    from ._build import load_kernel

    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    lib = load_kernel("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            b, h, tq, tkv, d, int(bool(causal)), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, *, causal: bool = False, kv_mask=None,
                    return_lse: bool = False):
    """Flash-attention forward: ``(o, lse)`` if ``return_lse`` else ``o``.

    CUDA tensors go to the Hopper kernel K1 (``flash_attention.launches``
    counts its launches); CPU tensors go to the plain version. Any other
    device, dtype or shape the kernel does not take raises.
    """
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         kv_mask=kv_mask,
                                         return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    o, lse = _launch(q, k, v, _kv_bias(kv_mask), causal)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
