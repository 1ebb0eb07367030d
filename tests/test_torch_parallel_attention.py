"""The port's sequence-parallel attention against the reference's, on
the CPU: ``sequence_sharded_attention`` in both schedules, as
values and as gradients of q, k and v, causal and not, with a
``kv_mask`` of ragged lengths. The shard-list forms are held in
``test_torch_parallel_attention_shards.py``.

The reference runs under ``shard_map`` on its 8 virtual CPU devices
(``tests/conftest.py``), where its Ulysses schedule attends with the
blockwise formulation, as the port's ``default_attention`` does off the
card. The port's mesh names the CPU once an entry. Inputs come from a
numpy seed. Tolerances: float32 values within 1e-5 absolute and
relative (the online softmax folds in another order), gradients within
1e-4, as the reference's own ring and Ulysses tests hold theirs.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_torch.ops import attention as tattn
from rafiki_torch.parallel import build_mesh
from rafiki_tpu.ops import sequence_sharded_attention as jax_sharded
from rafiki_tpu.parallel import build_mesh as jax_build_mesh

CPU = torch.device("cpu")
B, H, T, D = 4, 4, 32, 8
LENGTHS = (32, 7, 19, 1)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                     for _ in range(4))
    mask = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    return q, k, v, dout, mask


def _reference(q, k, v, dout, mask, *, sp, causal, mode, batch_axis):
    mesh = jax_build_mesh(jax.devices(), sp=sp)
    m = jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jax_sharded(q_, k_, v_, mesh, causal=causal, kv_mask=m,
                          mode=mode, batch_axis=batch_axis)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(fn, q, k, v, dout):
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*xs)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


def _close(got, want):
    out, grads = got
    np.testing.assert_allclose(out, want[0], atol=1e-5, rtol=1e-5)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["ring", "alltoall"])
def test_sequence_sharded_attention_matches_the_reference(mode, causal):
    """Batch over dp 2, sequence over sp 4: the 8 entries of each mesh."""
    q, k, v, dout, mask = _inputs(0)
    want = _reference(q, k, v, dout, mask, sp=4, causal=causal, mode=mode,
                      batch_axis="dp")
    mesh = build_mesh([CPU] * 8, sp=4)
    assert dict(mesh.shape)["dp"] == 2
    got = _port(lambda q_, k_, v_: tattn.sequence_sharded_attention(
        q_, k_, v_, mesh, causal=causal, kv_mask=torch.from_numpy(mask),
        mode=mode), q, k, v, dout)
    _close(got, want)


def test_sequence_sharded_attention_keeps_the_reference_s_errors():
    q = torch.zeros((2, 2, 16, 8))
    mesh = build_mesh([CPU] * 4, sp=4)
    with pytest.raises(ValueError, match="unknown sequence-parallel mode"):
        tattn.sequence_sharded_attention(q, q, q, mesh, mode="tree")
    with pytest.raises(ValueError, match="heads % sp == 0; got 2 % 4"):
        tattn.sequence_sharded_attention(q, q, q, mesh, mode="alltoall")
