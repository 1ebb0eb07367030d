"""The transformer tagger's pipeline modes (pp, pp × sp): logits
against the reference's tagger on the same weights, on meshes of 4
entries, as ``test_torch_tagger_modes.py`` (the bf16 logits within
2^-5; pp × ep in ``test_torch_tagger_pp_ep_modes.py``); and the pp
layout's split and merge.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import pytest
import torch

from _torch_modes import BASE, MODES, N_TAGS, bound
from rafiki_torch.models import TorchTransformerTagger
from test_torch_tagger_modes import logits_match


@pytest.mark.parametrize("mode", ["pp", "pp_sp"])
def test_a_mode_s_logits_match_the_reference_s(mode):
    logits_match(mode)


def test_pp_split_and_merge_are_inverse():
    with bound():
        tm = TorchTransformerTagger(device="cpu", **dict(BASE, n_layers=4),
                                    **MODES["pp_ep"])
        net = tm.create_module(N_TAGS)
    params = dict(net.named_parameters())
    split = tm._pp_split(params)
    assert sorted(split["stages"]) == ["stage0", "stage1"]
    w = split["stages"]["stage1"]["expert_w1"]
    assert w.shape == (2, 4, 32, 128)
    assert torch.equal(w[1], params["_EncoderBlock_3.expert_w1"])
    merged = tm._pp_merge(split)
    assert set(merged) == set(params)
    for k in params:
        assert torch.equal(merged[k], params[k]), k
