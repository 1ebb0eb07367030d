"""Which variant of K2 (``csrc/flash_bwd_dq.cu``) and K3
(``csrc/flash_bwd_dkv.cu``) the port's flash-attention backward takes,
checked on the CPU.

``flash_backward_variant`` decides for both by dtype, head dim and
alignment: bf16 with D % 8 == 0 and 16-byte aligned q, k, v and do goes
to the ``wgmma`` variants (TMA needs 16-byte row strides and bases), other
bf16 to ``mma_sync``, f32 to ``f32``. A forced variant that cannot take
the inputs raises ``ValueError``. On CPU tensors every variant runs the
plain version, so a forced one still agrees with the JAX backward,
``_flash_backward`` with its two Pallas kernels in interpret mode, on the
same numpy inputs: bf16 gradients within two bf16 ulps (atol 1e-2, rtol
1.6e-2), as in ``tests/test_torch_attention_grad.py``.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_torch.ops import attention as tattn
from test_torch_attention import BF16_TOL, _qkv
from test_torch_attention_grad import _jax_grads

BACKWARD = (tattn._flash_dq, tattn._flash_dkv)


def _tensor(shape, dtype, offset=0):
    """Zeros of ``shape``, contiguous, ``offset`` elements past an
    aligned allocation."""
    flat = torch.zeros(math.prod(shape) + offset, dtype=dtype)
    return flat[offset:].view(shape)


def _inputs(d, dtype, offsets=(0, 0, 0, 0)):
    """q, k, v, do (offset as given), lse and delta."""
    q, k, v, do = (_tensor((1, 2, 16, d), dtype, off) for off in offsets)
    return q, k, v, do, torch.zeros(1, 2, 16), torch.zeros(1, 2, 16)


@pytest.mark.parametrize("dtype,d,offsets,expected", [
    (torch.bfloat16, 128, (0, 0, 0, 0), "wgmma"),
    (torch.bfloat16, 80, (0, 0, 0, 0), "wgmma"),
    (torch.bfloat16, 64, (0, 0, 0, 0), "wgmma"),
    (torch.bfloat16, 8, (0, 0, 0, 0), "wgmma"),
    (torch.bfloat16, 64, (8, 8, 8, 8), "wgmma"),     # 16 bytes off: aligned
    (torch.bfloat16, 36, (0, 0, 0, 0), "mma_sync"),  # 72-byte rows
    (torch.bfloat16, 12, (0, 0, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, (1, 0, 0, 0), "mma_sync"),  # q 2 bytes off
    (torch.bfloat16, 128, (0, 4, 0, 0), "mma_sync"),  # k 8 bytes off
    (torch.bfloat16, 128, (0, 0, 2, 0), "mma_sync"),  # v 4 bytes off
    (torch.bfloat16, 128, (0, 0, 0, 1), "mma_sync"),  # do 2 bytes off
    (torch.float32, 128, (0, 0, 0, 0), "f32"),
    (torch.float32, 36, (0, 0, 0, 0), "f32"),
    (torch.float32, 128, (1, 1, 1, 1), "f32"),
])
def test_variant_follows_dtype_head_dim_and_alignment(dtype, d, offsets,
                                                      expected):
    q, k, v, do, _, _ = _inputs(d, dtype, offsets)
    assert q.is_contiguous() and do.is_contiguous()
    assert tattn.flash_backward_variant(q, k, v, do) == expected


def test_only_do_misaligned_sends_the_backward_alone_to_mma_sync():
    """do is an input of K2 and K3 only: the forward keeps wgmma."""
    q, k, v, do, _, _ = _inputs(64, torch.bfloat16, (0, 0, 0, 4))
    assert tattn.flash_forward_variant(q, k, v) == "wgmma"
    assert tattn.flash_backward_variant(q, k, v, do) == "mma_sync"


@pytest.mark.parametrize("fn", BACKWARD, ids=["K2", "K3"])
@pytest.mark.parametrize("dtype,d,offsets,variant", [
    (torch.bfloat16, 36, (0, 0, 0, 0), "wgmma"),
    (torch.bfloat16, 128, (0, 0, 0, 1), "wgmma"),
    (torch.bfloat16, 128, (0, 0, 0, 0), "f32"),
    (torch.float32, 128, (0, 0, 0, 0), "wgmma"),
    (torch.float32, 128, (0, 0, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, (0, 0, 0, 0), "simt"),
])
def test_forced_variant_that_cannot_take_the_inputs_raises(fn, dtype, d,
                                                           offsets, variant):
    q, k, v, do, lse, delta = _inputs(d, dtype, offsets)
    with pytest.raises(ValueError, match="cannot take"):
        fn(q, k, v, do, lse, delta, True, None, variant=variant)


def test_every_variant_takes_its_own_choice():
    for dtype, d, offsets in ((torch.bfloat16, 128, (0, 0, 0, 0)),
                              (torch.bfloat16, 36, (0, 0, 0, 0)),
                              (torch.bfloat16, 64, (0, 0, 0, 1)),
                              (torch.float32, 20, (0, 0, 0, 0))):
        q, k, v, do, _, _ = _inputs(d, dtype, offsets)
        chosen = tattn.flash_backward_variant(q, k, v, do)
        assert tattn._variant_takes(chosen, q, k, v, do)
        # Earlier variants in the order of preference cannot take them.
        for other in tattn.VARIANTS[:tattn.VARIANTS.index(chosen)]:
            assert not tattn._variant_takes(other, q, k, v, do)


@pytest.mark.parametrize("fn", [tattn.flash_attention_dq,
                                tattn.flash_attention_dkv],
                         ids=["K2", "K3"])
def test_variant_launch_counts_add_up_to_the_total(fn):
    assert set(fn.variant_launches) == set(tattn.VARIANTS)
    assert sum(fn.variant_launches.values()) == fn.launches


def _counts():
    return [(fn.launches, dict(fn.variant_launches))
            for fn in (tattn.flash_attention_dq, tattn.flash_attention_dkv)]


@pytest.mark.parametrize("variant", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("causal", [False, True])
def test_forced_variant_on_cpu_matches_jax_flash_backward(variant, causal):
    """A CPU tensor runs the plain K2 and K3 whichever variant is forced,
    and counts no launch; dq, dk, dv agree with the reference's backward
    on a ragged cross shape (Tq 70, Tkv 90: neither a multiple of a
    tile)."""
    b, h, tq, tkv, d = 2, 2, 70, 90, 32
    q, k, v = _qkv(21, b=b, h=h, t=tq, d=d, tkv=tkv)
    g = np.random.default_rng(22).standard_normal(q.shape).astype(np.float32)
    ref = _jax_grads(q, k, v, g, causal, None, dtype=jnp.bfloat16)
    tq_, tk_, tv_, tg_ = (torch.from_numpy(a).to(torch.bfloat16)
                          for a in (q, k, v, g))
    o, lse = tattn._flash_forward(tq_, tk_, tv_, causal, None)
    delta = (tg_.float() * o.float()).sum(-1)
    before = _counts()
    args = (tq_, tk_, tv_, tg_, lse, delta, causal, None)
    dq = tattn._flash_dq(*args, variant=variant)
    dk, dv = tattn._flash_dkv(*args, variant=variant)
    assert _counts() == before
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
