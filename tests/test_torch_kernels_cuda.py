"""The port's Hopper kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances as in ``chip_smoke.py``: |kernel - plain| <= atol + rtol·|plain|
with bf16 (1e-3, 1.6e-2) (two bf16 ulps: the sums run in another order
before rounding), f32 (1e-5, 1e-5), lse (1e-4, 1e-6).
"""

import pytest
import torch

from rafiki_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: (1e-3, 1.6e-2), torch.float32: (1e-5, 1e-5)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(a, b, atol, rtol):
    return bool(((a.float() - b.float()).abs()
                 <= atol + rtol * b.float().abs()).all())


@pytest.mark.parametrize("shape", [(1, 4, 256, 256, 128), (2, 3, 77, 200, 64),
                                   (2, 2, 200, 77, 32), (1, 2, 65, 65, 80)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_fwd_matches_plain(card, shape, dtype, causal, masked):
    b, h, tq, tkv, d = shape
    gen = torch.Generator(device=card).manual_seed(tq * 7 + d)
    q, k, v = (torch.randn(b, h, t, d, device=card, generator=gen).to(dtype)
               for t in (tq, tkv, tkv))
    mask = None
    if masked:
        lengths = torch.tensor([tkv, tkv // 3][:b], device=card)
        mask = torch.arange(tkv, device=card)[None, :] < lengths[:, None]
    before = attn.flash_attention.launches
    o, lse = attn.flash_attention(q, k, v, causal=causal, kv_mask=mask,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    ro, rl = attn.flash_attention_reference(q, k, v, causal=causal,
                                            kv_mask=mask, return_lse=True)
    assert o.dtype == dtype and o.shape == q.shape
    assert _close(o, ro, *TOL[dtype])
    assert _close(lse, rl, 1e-4, 1e-6)


def test_flash_fwd_rejects_non_contiguous(card):
    q = torch.randn(1, 2, 64, 128, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                             q.transpose(1, 2))
