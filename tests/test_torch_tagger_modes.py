"""The transformer tagger's parallel modes outside the pipeline: logits
against the reference's tagger on the same weights, on meshes of 4
entries (the pipeline's in ``test_torch_tagger_pp_modes.py``).

The reference runs on 4 of its 8 virtual CPU devices, the port on 4
CPU entries (``_torch_modes.bound``); both taggers attend with the
blockwise formulation on the CPU (the reference's ``ulysses_attention``
takes it off the TPU, the port's ``default_attention`` off the card).
Size: d_model 32, 4 heads, 2 layers, max_len 16, a batch of 8 with
ragged lengths, vocabulary 300, 5 tags. Tolerance: the bf16 logits
within 2^-5 (as ``test_torch_tagger.py``), two bf16 ulps of a logit
below 4. The invalid combinations raise the reference's errors.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_modes import BASE, MODES, N_TAGS, bound, ids, start_params, unflat
from rafiki_torch.model.bridge import dense_from_jax
from rafiki_torch.models import TorchTransformerTagger
from rafiki_tpu.models.transformer import JaxTransformerTagger


def _jax_logits(jm, variables, x):
    if jm.mesh.shape["pp"] == 1:
        return np.asarray(jm._module.apply(variables, x, jm._attn_fn()))
    fn = jm._pp_logits_fn(N_TAGS, train=False)
    return np.asarray(fn(jm._pp_split(variables["params"]), x,
                         jnp.int32(0))[0])


def logits_match(mode):
    _, flat = start_params(mode, dtype=jnp.bfloat16)
    x = ids(1)
    with bound():
        jm = JaxTransformerTagger(**BASE, **MODES[mode])
        jm._ensure_module(N_TAGS)
        want = _jax_logits(jm, unflat(flat), jnp.asarray(x))
        tm = TorchTransformerTagger(device="cpu", **BASE, **MODES[mode])
        net = tm.create_module(N_TAGS)
        net.load_state_dict(dense_from_jax(flat))
        with torch.no_grad():
            got = tm.logits(net, torch.from_numpy(x), None)
        assert dict(tm.mesh.shape) == dict(jm.mesh.shape)
    assert got.shape == (8, BASE["max_len"], N_TAGS)
    np.testing.assert_allclose(got.numpy(), want, atol=2 ** -5, rtol=0)


@pytest.mark.parametrize("mode", ["dp", "sp_ring", "sp_alltoall", "ep_moe"])
def test_a_mode_s_logits_match_the_reference_s(mode):
    logits_match(mode)


def test_a_mode_s_mesh_follows_the_bound_group():
    """Without a group the tagger's mesh is its device alone; bound, it
    is the group's entries, the rest of them data-parallel."""
    tm = TorchTransformerTagger(device="cpu", **BASE)
    assert tm.mesh.size == 1
    with bound():
        tm = TorchTransformerTagger(device="cpu", **BASE,
                                    **MODES["pp_sp"])
        assert dict(tm.mesh.shape) == {"dp": 1, "pp": 2, "ep": 1, "sp": 2,
                                       "tp": 1}
        assert tm.batch_multiple() == 1
        tm = TorchTransformerTagger(device="cpu", **BASE, **MODES["sp_ring"])
        assert tm.mesh.shape["dp"] == 2 and tm.batch_multiple() == 2


@pytest.mark.parametrize("knobs,match", [
    ({"sequence_parallel": 2}, "1 devices not divisible by pp\\*ep\\*sp"),
    ({"expert_parallel": 2}, "needs moe_experts set and divisible"),
    ({"moe_experts": 3, "expert_parallel": 2},
     "needs moe_experts set and divisible"),
    ({"pipeline_parallel": 2, "n_layers": 3}, "must divide n_layers"),
])
def test_invalid_combinations_raise_the_reference_s_errors(knobs, match):
    for cls, kw in ((JaxTransformerTagger, {}),
                    (TorchTransformerTagger, {"device": "cpu"})):
        m = cls(**dict(BASE, **knobs), **kw)
        if cls is JaxTransformerTagger and "sequence_parallel" in knobs:
            from rafiki_tpu.parallel.chips import ChipGroup

            ChipGroup(indices=(0,)).bind_to_thread()
            try:
                with pytest.raises(ValueError, match=match):
                    m.mesh
            finally:
                ChipGroup.unbind_thread()
            continue
        with pytest.raises(ValueError, match=match):
            m.mesh


def test_ulysses_needs_heads_divisible_by_sp():
    with bound():
        tm = TorchTransformerTagger(device="cpu", **dict(
            BASE, n_heads=2), sequence_parallel=4, sp_schedule="alltoall")
        net = tm.create_module(N_TAGS)
        with pytest.raises(ValueError, match="heads % sp == 0"):
            tm.logits(net, torch.from_numpy(ids()), None)
