"""Which variant of K1 (``csrc/flash_fwd.cu``) the port's flash attention
takes, checked on the CPU.

``flash_forward_variant`` decides by dtype, head dim and alignment: bf16
with D % 8 == 0 and 16-byte aligned q, k, v goes to the ``wgmma``
variant (TMA needs 16-byte row strides and bases), other bf16 to
``mma_sync``, f32 to ``f32``. A forced variant that cannot take the
inputs raises ``ValueError``. On CPU tensors every variant runs the
plain version, so a forced one still agrees with the JAX kernel, run in
interpret mode on the same numpy inputs (bf16 outputs within two bf16
ulps, atol 1e-2 and rtol 1.6e-2; lse, f32 in both, within 1e-5).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.ops import attention as jattn
from rafiki_torch.ops import attention as tattn


def _tensor(shape, dtype, offset=0):
    """Zeros of ``shape``, contiguous, ``offset`` elements past an
    aligned allocation."""
    flat = torch.zeros(math.prod(shape) + offset, dtype=dtype)
    return flat[offset:].view(shape)


def _qkv(d, dtype, offsets=(0, 0, 0)):
    return [_tensor((1, 2, 16, d), dtype, off) for off in offsets]


@pytest.mark.parametrize("dtype,d,offsets,expected", [
    (torch.bfloat16, 128, (0, 0, 0), "wgmma"),
    (torch.bfloat16, 80, (0, 0, 0), "wgmma"),
    (torch.bfloat16, 64, (0, 0, 0), "wgmma"),
    (torch.bfloat16, 32, (0, 0, 0), "wgmma"),
    (torch.bfloat16, 8, (0, 0, 0), "wgmma"),
    (torch.bfloat16, 64, (8, 8, 8), "wgmma"),     # 16 bytes off: aligned
    (torch.bfloat16, 36, (0, 0, 0), "mma_sync"),  # 72-byte rows
    (torch.bfloat16, 12, (0, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, (1, 0, 0), "mma_sync"),  # q 2 bytes off
    (torch.bfloat16, 128, (0, 4, 0), "mma_sync"),  # k 8 bytes off
    (torch.bfloat16, 128, (0, 0, 2), "mma_sync"),  # v 4 bytes off
    (torch.float32, 128, (0, 0, 0), "f32"),
    (torch.float32, 36, (0, 0, 0), "f32"),
    (torch.float32, 128, (1, 1, 1), "f32"),
])
def test_variant_follows_dtype_head_dim_and_alignment(dtype, d, offsets,
                                                      expected):
    q, k, v = _qkv(d, dtype, offsets)
    assert q.is_contiguous()
    assert tattn.flash_forward_variant(q, k, v) == expected


@pytest.mark.parametrize("dtype,d,offsets,variant", [
    (torch.bfloat16, 36, (0, 0, 0), "wgmma"),
    (torch.bfloat16, 128, (1, 0, 0), "wgmma"),
    (torch.bfloat16, 128, (0, 0, 0), "f32"),
    (torch.float32, 128, (0, 0, 0), "wgmma"),
    (torch.float32, 128, (0, 0, 0), "mma_sync"),
    (torch.bfloat16, 128, (0, 0, 0), "simt"),
])
def test_forced_variant_that_cannot_take_the_inputs_raises(dtype, d, offsets,
                                                           variant):
    q, k, v = _qkv(d, dtype, offsets)
    with pytest.raises(ValueError, match="cannot take"):
        tattn._flash_forward(q, k, v, True, None, variant=variant)


def test_every_variant_takes_its_own_choice():
    for dtype, d, offsets in ((torch.bfloat16, 128, (0, 0, 0)),
                              (torch.bfloat16, 36, (0, 0, 0)),
                              (torch.bfloat16, 64, (0, 1, 0)),
                              (torch.float32, 20, (0, 0, 0))):
        q, k, v = _qkv(d, dtype, offsets)
        chosen = tattn.flash_forward_variant(q, k, v)
        assert tattn._variant_takes(chosen, q, k, v)
        # Earlier variants in the order of preference cannot take them.
        for other in tattn.VARIANTS[:tattn.VARIANTS.index(chosen)]:
            assert not tattn._variant_takes(other, q, k, v)


def test_variant_launch_counts_add_up_to_the_total():
    counts = tattn.flash_attention.variant_launches
    assert set(counts) == set(tattn.VARIANTS)
    assert sum(counts.values()) == tattn.flash_attention.launches


@pytest.mark.parametrize("variant", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("causal", [False, True])
def test_forced_variant_on_cpu_matches_jax_flash(variant, causal):
    """A CPU tensor runs the plain version whichever variant is forced,
    and counts no launch."""
    rng = np.random.default_rng(13)
    b, h, tq, tkv, d = 2, 2, 70, 90, 32
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for t in (tq, tkv, tkv))
    jo, jl = jattn._flash_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), None, causal,
        1024, 1024, True, return_lse=True)
    jo = np.asarray(jo.astype(jnp.float32))
    jl = np.asarray(jl)[:, :tq, 0].reshape(b, h, tq)
    before = (tattn.flash_attention.launches,
              dict(tattn.flash_attention.variant_launches))
    to, tl = tattn._flash_forward(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal, None, variant=variant)
    assert (tattn.flash_attention.launches,
            tattn.flash_attention.variant_launches) == before
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), jo, atol=1e-2, rtol=1.6e-2)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5, rtol=1e-5)
