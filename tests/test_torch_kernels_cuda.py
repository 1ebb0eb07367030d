"""The port's Hopper kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

K1 has three variants (``attention.K1_VARIANTS``); bf16 inputs run on
both of theirs: ``wgmma``, which ``flash_attention`` picks for every bf16
shape with D % 8 == 0 and aligned bases, and ``mma_sync``, forced here
(``_flash_forward(..., variant=)``) and picked by ``flash_attention``
for D % 8 != 0 or a misaligned base.

Tolerances as in ``chip_smoke.py``: |kernel - plain| <= atol + rtol·|plain|
with bf16 (1e-3, 1.6e-2) (two bf16 ulps: the sums run in another order
before rounding), f32 (1e-5, 1e-5), lse (1e-4, 1e-6). The gradients of
K2 and K3 are sums over up to Tkv (or Tq) terms of products with p or ds
rounded to bf16; where the kernel's exp and the plain version's round an
intermediate to neighbouring bf16 values, a term moves by one bf16 ulp.
So bf16 gradients are held to |err| <= 1e-2·max|plain| + 1.6e-2·|plain|,
f32 gradients to 1e-5·max|plain| + 1e-4·|plain| (summation order only).
"""

import pytest
import torch

from rafiki_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: (1e-3, 1.6e-2), torch.float32: (1e-5, 1e-5)}
# Gradients: (fraction of max|plain|, rtol).
GRAD_TOL = {torch.bfloat16: (1e-2, 1.6e-2), torch.float32: (1e-5, 1e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(a, b, atol, rtol):
    return bool(((a.float() - b.float()).abs()
                 <= atol + rtol * b.float().abs()).all())


def _k1(q, k, v, causal, mask, variant):
    """K1's ``variant`` on q, k, v, through ``flash_attention`` where the
    shape picks that variant, forced otherwise; checks that the launch
    went to it."""
    total = attn.flash_attention.launches
    counts = dict(attn.flash_attention.variant_launches)
    if attn.flash_forward_variant(q, k, v) == variant:
        o, lse = attn.flash_attention(q, k, v, causal=causal, kv_mask=mask,
                                      return_lse=True)
    else:
        o, lse = attn._flash_forward(q, k, v, causal, mask, variant=variant)
    torch.cuda.synchronize()
    counts[variant] += 1
    assert attn.flash_attention.launches == total + 1
    assert attn.flash_attention.variant_launches == counts
    return o, lse


def _fwd_inputs(card, shape, dtype, masked, offset=0):
    b, h, tq, tkv, d = shape
    gen = torch.Generator(device=card).manual_seed(tq * 7 + d)
    q, k, v = (torch.randn(b, h, t, d, device=card, generator=gen).to(dtype)
               for t in (tq, tkv, tkv))
    if offset:
        # The same values, `offset` elements past an aligned allocation.
        q = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(
            q.shape)
    mask = None
    if masked:
        lengths = torch.tensor([tkv, tkv // 3][:b], device=card)
        mask = torch.arange(tkv, device=card)[None, :] < lengths[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("shape", [(1, 4, 256, 256, 128), (2, 3, 77, 200, 64),
                                   (2, 2, 200, 77, 32), (1, 2, 65, 65, 80)])
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.bfloat16, "mma_sync"),
                                           (torch.float32, "f32")])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_fwd_matches_plain(card, shape, dtype, variant, causal, masked):
    q, k, v, mask = _fwd_inputs(card, shape, dtype, masked)
    # Every bf16 shape here has D % 8 == 0 and aligned bases: wgmma.
    auto = "wgmma" if dtype == torch.bfloat16 else "f32"
    assert attn.flash_forward_variant(q, k, v) == auto
    o, lse = _k1(q, k, v, causal, mask, variant)
    ro, rl = attn.flash_attention_reference(q, k, v, causal=causal,
                                            kv_mask=mask, return_lse=True)
    assert o.dtype == dtype and o.shape == q.shape
    assert _close(o, ro, *TOL[dtype])
    assert _close(lse, rl, 1e-4, 1e-6)


@pytest.mark.parametrize("shape,offset", [((2, 2, 90, 150, 36), 0),
                                          ((1, 3, 130, 70, 128), 1)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_fwd_tma_cannot_address_goes_to_mma_sync(card, shape, offset,
                                                       causal, masked):
    """D % 8 != 0 (72-byte rows) or a q 2 bytes off alignment: TMA cannot
    address it, ``flash_attention`` takes the mma.sync variant, and a
    forced wgmma raises before any launch."""
    q, k, v, mask = _fwd_inputs(card, shape, torch.bfloat16, masked, offset)
    assert attn.flash_forward_variant(q, k, v) == "mma_sync"
    o, lse = _k1(q, k, v, causal, mask, "mma_sync")
    ro, rl = attn.flash_attention_reference(q, k, v, causal=causal,
                                            kv_mask=mask, return_lse=True)
    assert _close(o, ro, *TOL[torch.bfloat16])
    assert _close(lse, rl, 1e-4, 1e-6)
    total = attn.flash_attention.launches
    with pytest.raises(ValueError, match="cannot take"):
        attn._flash_forward(q, k, v, causal, mask, variant="wgmma")
    assert attn.flash_attention.launches == total


def test_k1_variant_launches_add_up_to_the_total(card):
    q, k, v, _ = _fwd_inputs(card, (1, 2, 128, 128, 64), torch.bfloat16,
                             False)
    for variant in ("wgmma", "mma_sync"):
        _k1(q, k, v, True, None, variant)
    assert (sum(attn.flash_attention.variant_launches.values())
            == attn.flash_attention.launches)


def test_flash_fwd_rejects_non_contiguous(card):
    q = torch.randn(1, 2, 64, 128, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                             q.transpose(1, 2))


def _grad_close(a, b, dtype):
    scale, rtol = GRAD_TOL[dtype]
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= scale * b.abs().max() + rtol * b.abs())
                .all())


def _inputs(card, shape, dtype, lengths=None):
    b, h, tq, tkv, d = shape
    gen = torch.Generator(device=card).manual_seed(tq * 5 + tkv + d)
    q, do = (torch.randn(b, h, tq, d, device=card, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, tkv, d, device=card, generator=gen).to(dtype)
            for _ in range(2))
    mask = None
    if lengths is not None:
        mask = (torch.arange(tkv, device=card)[None, :]
                < torch.tensor(lengths, device=card)[:, None])
    return q, k, v, do, mask


# (B, H, Tq, Tkv, D), kv_mask lengths or None
BWD_SHAPES = [((1, 4, 256, 256, 128), None), ((2, 3, 1000, 1000, 128), None),
              ((2, 2, 77, 200, 64), None), ((2, 2, 200, 77, 32), None),
              ((3, 2, 130, 130, 80), [130, 41, 0]),
              ((2, 2, 65, 300, 128), [300, 0])]


@pytest.mark.parametrize("shape,lengths", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_matches_plain(card, shape, lengths, dtype, causal):
    q, k, v, do, mask = _inputs(card, shape, dtype, lengths)
    o, lse = attn.flash_attention_reference(q, k, v, causal=causal,
                                            kv_mask=mask, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    dq_before = attn.flash_attention_dq.launches
    dkv_before = attn.flash_attention_dkv.launches
    dq = attn.flash_attention_dq(q, k, v, do, lse, delta, causal=causal,
                                 kv_mask=mask)
    dk, dv = attn.flash_attention_dkv(q, k, v, do, lse, delta, causal=causal,
                                      kv_mask=mask)
    torch.cuda.synchronize()
    assert attn.flash_attention_dq.launches == dq_before + 1
    assert attn.flash_attention_dkv.launches == dkv_before + 1
    rq = attn.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                           causal=causal, kv_mask=mask)
    rk, rv = attn.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                                causal=causal, kv_mask=mask)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(torch.isfinite(got.float()).all())
        assert _grad_close(got, ref, dtype)


def test_backward_reaches_q_k_v_through_k2_and_k3(card):
    """The gradient of a CUDA ``flash_attention`` reaches q, k and v, and
    the backward runs K2 and K3 once each (K1 once for the forward)."""
    q, k, v, do, _ = _inputs(card, (2, 4, 300, 300, 128), torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (attn.flash_attention.launches,
              attn.flash_attention_dq.launches,
              attn.flash_attention_dkv.launches)
    attn.flash_attention(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    assert (attn.flash_attention.launches - counts[0],
            attn.flash_attention_dq.launches - counts[1],
            attn.flash_attention_dkv.launches - counts[2]) == (1, 1, 1)
    qp, kp, vp = (t.detach().clone().requires_grad_() for t in (q, k, v))
    attn.flash_attention_plain(qp, kp, vp, causal=True).backward(do)
    for got, ref in ((q.grad, qp.grad), (k.grad, kp.grad), (v.grad, vp.grad)):
        assert got is not None and _grad_close(got, ref, torch.bfloat16)


def test_no_grad_forward_launches_k1_alone(card):
    q, k, v, _, _ = _inputs(card, (1, 2, 128, 128, 64), torch.bfloat16)
    counts = (attn.flash_attention.launches,
              attn.flash_attention_dq.launches,
              attn.flash_attention_dkv.launches)
    with torch.no_grad():
        o = attn.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert o.grad_fn is None
    assert (attn.flash_attention.launches - counts[0],
            attn.flash_attention_dq.launches - counts[1],
            attn.flash_attention_dkv.launches - counts[2]) == (1, 0, 0)
