"""The zoo's attention dispatch of the port against the JAX package on
the CPU: ``blockwise_attention``, ``default_attention`` and K1's batching
rule under ``torch.func.vmap``.

The same numpy inputs go through both packages. Tolerances: the
blockwise formulation in f32 sums the same terms in another order,
within 1e-5 (outputs of magnitude below 4); in bf16 (q, k, v rounded to
bf16 alike on both sides, the output rounded once) two bf16 ulps of the
output, 2^-7 relative plus 1e-3. The plain version of K1
(``flash_attention_plain``) against the reference's ``flash_attention``
in interpret mode: the same tiling of online softmax, 1e-5 in f32. The
vmap rule folds the members into the batch: on the CPU's plain path a
member's rows are bit for bit a loop's.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from rafiki_torch.ops import attention as attn
from rafiki_tpu.ops import attention as ref

F32_ATOL = 1e-5


def _qkv(b, h, tq, tkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, tq, d)).astype(np.float32),
            rng.standard_normal((b, h, tkv, d)).astype(np.float32),
            rng.standard_normal((b, h, tkv, d)).astype(np.float32))


def _mask(b, tkv, seed=1, full_row=None):
    lengths = np.random.default_rng(seed).integers(1, tkv + 1, b)
    lengths[0] = tkv
    if full_row is not None:
        lengths[full_row] = 0
    return np.arange(tkv)[None, :] < lengths[:, None]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tq,tkv,block", [(65, 65, 256), (40, 300, 64),
                                          (300, 300, 128)])
def test_blockwise_matches_the_reference(causal, masked, tq, tkv, block):
    """Ragged Tkv past ``block_kv`` pads the last block with ids of -1
    on both sides."""
    q, k, v = _qkv(2, 3, tq, tkv, 32)
    mask = _mask(2, tkv) if masked else None
    want = np.asarray(ref.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_kv=block,
        kv_mask=None if mask is None else jnp.asarray(mask)))
    got = attn.blockwise_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, block_kv=block,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_blockwise_bf16_and_a_fully_masked_row_match_the_reference():
    """bf16 inputs; row 1 of the batch has every key masked, where both
    blockwise versions give the mean of v over the padded block."""
    q, k, v = _qkv(2, 2, 65, 65, 32, seed=3)
    mask = _mask(2, 65, full_row=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref.blockwise_attention(
        jq, jk, jv, kv_mask=jnp.asarray(mask)).astype(jnp.float32))
    tq_, tk_, tv_ = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in (q, k, v))
    got = attn.blockwise_attention(tq_, tk_, tv_,
                                   kv_mask=torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3,
                               rtol=2 ** -7)


@pytest.mark.parametrize("causal", [False, True])
def test_default_attention_on_the_cpu_is_blockwise(causal):
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 70, 70, 16, seed=4))
    mask = torch.from_numpy(_mask(2, 70))
    fn = attn.default_attention(causal=causal)
    got = fn(q, k, v, mask)
    assert torch.equal(got, attn.blockwise_attention(
        q, k, v, causal=causal, kv_mask=mask))
    before = attn.flash_attention.launches
    fn(q, k, v, None)
    assert attn.flash_attention.launches == before


def test_default_attention_sends_other_devices_to_the_kernel():
    """No fallback: a tensor off the CPU goes to ``flash_attention``,
    which raises for a device it cannot take (here meta)."""
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        attn.default_attention(causal=False)(q, q, q, None)


@pytest.mark.parametrize("shape,masked", [
    ((2, 4, 65, 65, 32), False),   # ViT: 65 tokens, head_dim 32
    ((2, 4, 128, 128, 64), True),  # the tagger: kv_mask, head_dim 64
])
def test_flash_plain_matches_the_reference_flash_at_the_zoo_shapes(
        shape, masked):
    b, h, t, _, d = shape
    q, k, v = _qkv(b, h, t, t, d, seed=5)
    mask = _mask(b, t, seed=6) if masked else None
    want = np.asarray(ref.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=False,
        kv_mask=None if mask is None else jnp.asarray(mask),
        interpret=True))
    got = attn.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)),
        kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("shared_kv", [False, True])
def test_k1s_vmap_rule_equals_a_loop_over_members(shared_kv):
    """``flash_attention`` under ``torch.func.vmap`` over 3 members (a
    stacked forward) folds them into the batch: one call on (3·B, ...),
    each member's rows the loop's, with the mask folded alike; q alone
    may carry the member axis."""
    m, b, h, t, d = 3, 2, 2, 65, 32
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((m, b, h, t, d))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(rng.random((m, b, t)) > 0.3)
    calls = []
    real = attn._flash_forward

    def spy(q_, *args, **kw):
        calls.append(tuple(q_.shape))
        return real(q_, *args, **kw)

    attn._flash_forward = spy
    try:
        if shared_kv:
            got = vmap(lambda q_: attn.flash_attention(q_, k[0], v[0]))(q)
        else:
            got = vmap(lambda *a: attn.flash_attention(
                a[0], a[1], a[2], kv_mask=a[3]))(q, k, v, mask)
    finally:
        attn._flash_forward = real
    assert calls == [(m * b, h, t, d)]
    for i in range(m):
        want = (attn.flash_attention(q[i], k[0], v[0]) if shared_kv else
                attn.flash_attention(q[i], k[i], v[i], kv_mask=mask[i]))
        assert torch.equal(got[i], want)


def test_the_vmap_rule_keeps_the_gradient():
    """The folded call is the autograd function itself, so a gradient
    through the vmapped attention is the loop's."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 1, 2, 20, 8))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = vmap(lambda a, b_, c: attn.flash_attention(a, b_, c))(q, k, v)
    g = torch.autograd.grad(out.square().sum(), (q, k, v))
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    loop = torch.stack([attn.flash_attention(q2[i], k2[i], v2[i])
                        for i in range(2)])
    g2 = torch.autograd.grad(loop.square().sum(), (q2, k2, v2))
    for a, b_ in zip(g, g2):
        torch.testing.assert_close(a, b_, atol=1e-6, rtol=1e-6)


def test_reference_default_attention_is_blockwise_on_the_cpu():
    """What the port's CPU dispatch mirrors."""
    assert jax.default_backend() == "cpu"
    q, k, v = (jnp.asarray(a) for a in _qkv(1, 1, 9, 9, 8, seed=9))
    np.testing.assert_array_equal(
        np.asarray(ref.default_attention(causal=True)(q, k, v, None)),
        np.asarray(ref.blockwise_attention(q, k, v, causal=True)))
