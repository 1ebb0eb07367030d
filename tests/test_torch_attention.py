"""The port's attention (``rafiki_torch.ops.attention``) against the JAX
reference on the CPU.

The port's ``flash_attention`` takes its plain path for CPU tensors (the
Hopper kernel runs only on the card; ``chip_smoke.py`` holds it against
the same plain version there). The JAX side runs its Pallas kernel in
interpret mode. Inputs come from a seeded numpy generator and go to both
as the same arrays.

Tolerances: f32 1e-5 (the two sum in different orders); bf16 outputs may
differ by up to two bf16 ulps (atol 1e-2, rtol 1.6e-2); lse is f32 in
both, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.ops import attention as jattn
from rafiki_torch.ops import attention as tattn

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)


def _qkv(seed, b=2, h=2, t=64, d=32, tkv=None):
    rng = np.random.default_rng(seed)
    tkv = t if tkv is None else tkv
    return (rng.standard_normal((b, h, t, d)).astype(np.float32),
            rng.standard_normal((b, h, tkv, d)).astype(np.float32),
            rng.standard_normal((b, h, tkv, d)).astype(np.float32))


def _mask(b, tkv, lengths):
    return np.arange(tkv)[None, :] < np.asarray(lengths)[:, None]


def _jax_flash(q, k, v, causal, mask, block_q=1024, block_kv=1024,
               dtype=jnp.float32):
    """JAX flash forward in interpret mode: (o, lse as (B, H, Tq)). The
    reference's default blocks pad no key at these lengths, which keeps
    its fully padded rows free of block padding."""
    b, h, tq, _ = q.shape
    bias = None if mask is None else jnp.where(
        jnp.asarray(mask), 0.0, jattn.NEG_INF).astype(jnp.float32)
    o, lse = jattn._flash_forward(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        bias, causal, block_q, block_kv, True, return_lse=True)
    lse = np.asarray(lse)[:, :tq, 0].reshape(b, h, tq)
    return np.asarray(o.astype(jnp.float32)), lse


def _torch_flash(q, k, v, causal, mask, dtype=torch.float32):
    o, lse = tattn.flash_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask),
        return_lse=True)
    assert o.dtype == dtype and lse.dtype == torch.float32
    return o.float().numpy(), lse.numpy()


# name -> (b, h, tq, tkv, d, causal, kv_mask lengths or None)
CASES = {
    "square": (2, 2, 48, 48, 32, False, None),
    "square causal": (2, 2, 48, 48, 32, True, None),
    "cross": (2, 2, 16, 40, 8, False, None),
    "cross causal end-aligned": (2, 2, 8, 24, 16, True, None),
    "ragged kv": (2, 2, 24, 50, 32, False, None),
    "ragged causal past a tile": (1, 2, 150, 150, 32, True, None),
    "kv_mask": (3, 2, 32, 32, 16, False, [32, 7, 19]),
    "kv_mask causal": (3, 2, 32, 32, 16, True, [32, 7, 19]),
    "kv_mask all padded": (2, 2, 20, 20, 16, False, [20, 0]),
    "kv_mask all padded causal": (2, 2, 20, 20, 16, True, [20, 0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_jax_flash(name):
    b, h, tq, tkv, d, causal, lengths = CASES[name]
    q, k, v = _qkv(len(name), b=b, h=h, t=tq, d=d, tkv=tkv)
    mask = None if lengths is None else _mask(b, tkv, lengths)
    jo, jl = _jax_flash(q, k, v, causal, mask)
    to, tl = _torch_flash(q, k, v, causal, mask)
    assert to.shape == (b, h, tq, d) and tl.shape == (b, h, tq)
    np.testing.assert_allclose(to, jo, **F32_TOL)
    np.testing.assert_allclose(tl, jl, **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_matches_jax_flash(causal):
    q, k, v = _qkv(7, t=64, d=32)
    jo, jl = _jax_flash(q, k, v, causal, None, block_q=32, block_kv=32,
                        dtype=jnp.bfloat16)
    to, tl = _torch_flash(q, k, v, causal, None, dtype=torch.bfloat16)
    np.testing.assert_allclose(to, jo, **BF16_TOL)
    np.testing.assert_allclose(tl, jl, **F32_TOL)


def test_fully_padded_example_is_the_mean_of_v():
    """An example whose kv_mask is all False comes out as the mean of v
    over all keys (not causal), in the reference kernel as in the port,
    with lse at NEG_INF."""
    q, k, v = _qkv(3, b=2, t=20, d=16)
    mask = _mask(2, 20, [20, 0])
    to, tl = _torch_flash(q, k, v, False, mask)
    np.testing.assert_allclose(to[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), to[1].shape), **F32_TOL)
    assert np.all(tl[1] == np.float32(jattn.NEG_INF))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_naive_matches_jax_naive(causal, masked):
    q, k, v = _qkv(11, b=3, t=24, d=16, tkv=40)
    mask = _mask(3, 40, [40, 9, 25]) if masked else None
    ref = jattn.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask))
    out = tattn.naive_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_naive(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, t=130, d=64))
    np.testing.assert_allclose(
        tattn.flash_attention(q, k, v, causal=causal).numpy(),
        tattn.naive_attention(q, k, v, causal=causal).numpy(), **F32_TOL)


def test_cpu_path_does_not_count_launches():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, t=8, d=8))
    before = tattn.flash_attention.launches
    tattn.flash_attention(q, k, v, causal=True)
    assert tattn.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "mask",
                                 "shape"])
def test_flash_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, t=8, d=8))
    mask = None
    if bad == "head_dim":
        q = k = v = torch.zeros(1, 1, 4, 129)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "mask":
        mask = torch.ones(2, 8)               # not bool
    else:
        v = v[:, :1]
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v, kv_mask=mask)
