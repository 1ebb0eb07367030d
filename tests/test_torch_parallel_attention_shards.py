"""The port's ``ring_attention`` and ``ulysses_attention`` on their
shard lists against the reference's schedules, on the CPU: values and
gradients of q, k and v, causal and not, with a ``kv_mask`` of ragged
lengths. Inputs, reference and tolerances as in
``test_torch_parallel_attention.py``: float32 values within 1e-5
absolute and relative, gradients within 1e-4.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest
import torch

from rafiki_torch.ops import attention as tattn
from test_torch_parallel_attention import (B, D, H, T, _close, _inputs,
                                           _port, _reference)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fn,mode", [(tattn.ring_attention, "ring"),
                                     (tattn.ulysses_attention, "alltoall")])
def test_the_shard_list_forms_match_the_reference(fn, mode, causal):
    """``ring_attention`` and ``ulysses_attention`` called on sp 4 shard
    lists of the whole batch, the reference's with the batch
    replicated."""
    q, k, v, dout, mask = _inputs(1)
    want = _reference(q, k, v, dout, mask, sp=4, causal=causal, mode=mode,
                      batch_axis=None)
    tl = T // 4
    masks = [torch.from_numpy(mask[:, j * tl:(j + 1) * tl])
             for j in range(4)]

    def run(q_, k_, v_):
        outs = fn(*[[x[:, :, j * tl:(j + 1) * tl] for j in range(4)]
                    for x in (q_, k_, v_)], causal=causal, kv_masks=masks)
        assert [o.shape for o in outs] == [(B, H, tl, D)] * 4
        return torch.cat(outs, dim=2)

    _close(_port(run, q, k, v, dout), want)
