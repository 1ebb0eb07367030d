"""The port's attention gradient (the plain versions of K2 and K3, and
the autograd Function around K1, K2 and K3) against the JAX reference on
the CPU.

On CPU tensors ``flash_attention``'s backward runs the plain versions
``flash_attention_dq_reference`` and ``flash_attention_dkv_reference``
(the Hopper kernels run only on the card; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them against the same plain
versions there). The JAX side runs ``_flash_backward``, its two Pallas
kernels in interpret mode, on the forward's ``o`` and ``lse``. Inputs
come from a seeded numpy generator and go to both as the same arrays.

Tolerances: f32 1e-5 (the two sum in different orders); bf16 gradients
within two bf16 ulps (atol 1e-2, rtol 1.6e-2, as the forward's test
states), since each side rounds its bf16 output once after f32 sums.
Against autograd through ``naive_attention`` (f32), 1e-4: the naive
softmax normalises by a sum where flash subtracts ``lse``, so the two
differ by a few f32 ulps of each of the ~T terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.ops import attention as jattn
from rafiki_torch.ops import attention as tattn
from test_torch_attention import BF16_TOL, CASES, F32_TOL, _mask, _qkv

NAIVE_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_grads(q, k, v, g, causal, mask, dtype=jnp.float32, block=1024):
    bias = None if mask is None else jnp.where(
        jnp.asarray(mask), 0.0, jattn.NEG_INF).astype(jnp.float32)
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, lse = jattn._flash_forward(*args, bias, causal, block, block, True,
                                    return_lse=True)
    grads = jattn._flash_backward(*args, bias, out, lse,
                                  jnp.asarray(g, dtype), causal, block,
                                  block, True)
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _torch_grads(q, k, v, g, causal, mask, dtype=torch.float32,
                 fn=tattn.flash_attention):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = fn(*ts, causal=causal,
           kv_mask=None if mask is None else torch.from_numpy(mask))
    o.backward(torch.from_numpy(g).to(dtype))
    for t in ts:
        assert t.grad is not None and t.grad.dtype == dtype
    return [t.grad.float().numpy() for t in ts]


def _case(name):
    b, h, tq, tkv, d, causal, lengths = CASES[name]
    q, k, v = _qkv(len(name), b=b, h=h, t=tq, d=d, tkv=tkv)
    g = np.random.default_rng(len(name) + 100).standard_normal(
        q.shape).astype(np.float32)
    mask = None if lengths is None else _mask(b, tkv, lengths)
    return q, k, v, g, causal, mask


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_flash_backward(name):
    """dq, dk, dv of the port's plain K2/K3 against the reference's
    Pallas backward, on the CASES of the forward's test: causal and not,
    cross attention end-aligned, ragged kv and q past a tile, kv_mask
    with partly and fully padded examples."""
    q, k, v, g, causal, mask = _case(name)
    ref = _jax_grads(q, k, v, g, causal, mask)
    out = _torch_grads(q, k, v, g, causal, mask)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_bf16_matches_jax_flash_backward(causal):
    q, k, v = _qkv(8, t=64, d=32)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    ref = _jax_grads(q, k, v, g, causal, None, dtype=jnp.bfloat16, block=32)
    out = _torch_grads(q, k, v, g, causal, None, dtype=torch.bfloat16)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, **BF16_TOL)


# (b, tq, tkv, d, causal, kv_mask lengths or None)
NAIVE_CASES = {
    "square": (2, 70, 70, 16, False, None),
    "square causal": (2, 130, 130, 16, True, None),
    "cross causal": (2, 40, 100, 16, True, None),
    "kv_mask": (3, 33, 90, 16, False, [90, 20, 0]),
    "kv_mask causal": (3, 90, 90, 16, True, [90, 20, 0]),
}


@pytest.mark.parametrize("name", sorted(NAIVE_CASES))
def test_flash_gradient_matches_naive_autograd(name):
    """Autograd through ``naive_attention`` as the ground truth. A row
    with no kept key (a fully padded example) gets a zero gradient in the
    reference's backward and a mean-of-v gradient in the naive one, so
    those rows carry no upstream gradient here."""
    b, tq, tkv, d, causal, lengths = NAIVE_CASES[name]
    q, k, v = _qkv(len(name), b=b, t=tq, d=d, tkv=tkv)
    g = np.random.default_rng(len(name)).standard_normal(
        q.shape).astype(np.float32)
    mask = None if lengths is None else _mask(b, tkv, lengths)
    if mask is not None:
        g[~mask.any(axis=1)] = 0.0
    ref = _torch_grads(q, k, v, g, causal, mask, fn=tattn.naive_attention)
    out = _torch_grads(q, k, v, g, causal, mask)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, **NAIVE_TOL)


def test_fully_padded_example_gets_no_gradient():
    """As in the reference's backward: no kept key, no gradient, for q
    of that example and for its k and v."""
    q, k, v, g, causal, mask = _case("kv_mask all padded")
    dq, dk, dv = _torch_grads(q, k, v, g, causal, mask)
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert dq[0].any() and dk[0].any() and dv[0].any()


def test_plain_function_gives_the_same_gradient():
    """``flash_attention_plain`` is the same Function on the plain
    versions whatever the device; on the CPU the two coincide."""
    q, k, v, g, causal, mask = _case("kv_mask causal")
    a = _torch_grads(q, k, v, g, causal, mask)
    b = _torch_grads(q, k, v, g, causal, mask, fn=tattn.flash_attention_plain)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_no_grad_forward_builds_no_graph():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(4, t=16))
    with torch.no_grad():
        o = tattn.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is None
    assert tattn.flash_attention(q, k, v, causal=True).grad_fn is not None


def test_cpu_backward_does_not_count_launches():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, t=8))
    before = (tattn.flash_attention_dq.launches,
              tattn.flash_attention_dkv.launches)
    tattn.flash_attention(q, k, v, causal=True).sum().backward()
    assert (tattn.flash_attention_dq.launches,
            tattn.flash_attention_dkv.launches) == before


@pytest.mark.parametrize("bad", ["do shape", "do dtype", "lse dtype",
                                 "delta shape"])
def test_backward_rejects_what_the_kernels_do_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, t=8, d=8))
    do = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:3])
    delta = torch.zeros(q.shape[:3])
    if bad == "do shape":
        do = do[:, :, :4]
    elif bad == "do dtype":
        do = do.to(torch.bfloat16)
    elif bad == "lse dtype":
        lse = lse.double()
    else:
        delta = delta[:, :1]
    for fn in (tattn.flash_attention_dq, tattn.flash_attention_dkv):
        with pytest.raises(ValueError):
            fn(q, k, v, do, lse, delta, causal=True)
