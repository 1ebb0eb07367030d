"""The zoo's attention and int8 convolution on the card: K1, K2 and K3
at the ViT and tagger shapes against their plain versions, K1 launched
once for a stacked ViT forward, and ``int8_conv`` exact.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_zoo2_cuda.py

Tolerances (|kernel − plain| ≤ atol + rtol·|plain|). K1's ``o`` in bf16:
each ``p`` is rounded to bf16 before ``p·v``, and where the kernel's exp
and the plain version's round one ``p`` to neighbouring bf16 values the
row moves by up to 2^-8·|v|; ``o`` is rounded once more. So atol is
2^-8 · max|v| plus 1e-3, rtol 1.6e-2 (two bf16 ulps). ``lse`` 1e-4 +
1e-6 relative. K2 and K3 as ``chip_smoke.py`` holds them: 1e-2 of the
largest plain gradient plus 1.6e-2 relative. In f32: 1e-5.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch
from torch.func import vmap

from rafiki_torch.model.torch_model import int8_conv
from rafiki_torch.models import TorchViT
from rafiki_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

# name, B, H, T, D, kv_mask
SHAPES = [("vit", 256, 4, 65, 32, False),
          ("tagger", 64, 4, 128, 64, True)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rafiki_torch.ops import _build
    _build.build_all()
    return torch.device("cuda")


def _inputs(b, h, t, d, masked, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, t, d, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    mask = None
    if masked:
        lengths = torch.randint(1, t + 1, (b,), device="cuda", generator=g)
        lengths[0] = 0   # a fully padded row, as predict pads a batch
        mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
    return q, k, v, do, mask


def _close(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,b,h,t,d,masked", SHAPES)
def test_k1_k2_k3_match_plain_at_the_zoo_shapes(card, name, b, h, t, d,
                                                masked, dtype):
    q, k, v, do, mask = _inputs(b, h, t, d, masked, dtype)
    ro, rl = attn.flash_attention_reference(q, k, v, kv_mask=mask,
                                            return_lse=True)
    before = attn.flash_attention.launches
    o, lse = attn.flash_attention(q, k, v, kv_mask=mask, return_lse=True)
    assert attn.flash_attention.launches == before + 1
    bf16 = dtype == torch.bfloat16
    if bf16:
        assert attn.flash_forward_variant(q, k, v) == "wgmma"
        atol = 2 ** -8 * float(v.float().abs().max()) + 1e-3
        assert _close(o, ro, atol, 1.6e-2)
    else:
        assert _close(o, ro, 1e-5, 1e-5)
    assert _close(lse, rl, 1e-4, 1e-6)
    delta = (do.float() * ro.float()).sum(-1)
    args = (q, k, v, do, rl, delta)
    dq = attn.flash_attention_dq(*args, kv_mask=mask)
    dk, dv = attn.flash_attention_dkv(*args, kv_mask=mask)
    rq = attn.flash_attention_dq_reference(*args, kv_mask=mask)
    rk, rv = attn.flash_attention_dkv_reference(*args, kv_mask=mask)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        a = (1e-2 if bf16 else 1e-5) * float(want.float().abs().max())
        assert _close(got, want, a, 1.6e-2 if bf16 else 1e-4)


def test_a_stacked_vit_forward_launches_k1_once_per_block(card):
    """Two ViT members under ``torch.func.vmap``: one K1 launch a block
    on the members folded into the batch, each member's logits its own
    forward's (bf16 products of the same values in the same order)."""
    ms = []
    for seed in (0, 1):
        m = TorchViT(device="cuda", seed=seed, depth=6)
        m._new_net(10, (32, 32, 3))
        m._net = m.create_module(10, (32, 32, 3)).to("cuda").eval()
        ms.append(m)
    states = [dict(m._net.named_parameters()) for m in ms]
    stacked = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    depth = torch.ones(6, device="cuda")
    x = torch.rand(8, 32, 32, 3, device="cuda")
    net = ms[0]._net
    before = attn.flash_attention.launches
    with torch.no_grad():
        out = vmap(lambda p: torch.func.functional_call(
            net, p, (x, depth)))(stacked)
    assert attn.flash_attention.launches == before + 6
    with torch.no_grad():
        for i, m in enumerate(ms):
            own = m._net(x, depth)
            assert float((out[i] - own).abs().max()) <= 2 ** -5


@pytest.mark.parametrize("xs,ws,strides,padding", [
    ((256, 32, 32, 3), (3, 3, 3, 64), (1, 1), ((1, 1), (1, 1))),
    ((256, 4, 4, 256), (3, 3, 256, 256), (1, 1), ((1, 1), (1, 1))),
    ((1, 32, 32, 3), (4, 4, 3, 128), (4, 4), "VALID"),
    ((17, 8, 8, 128), (3, 3, 128, 256), (1, 1), ((1, 1), (1, 1)))])
def test_int8_conv_is_exact_on_the_card(card, xs, ws, strides, padding):
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, xs, dtype=torch.int8, generator=g)
    wq = torch.randint(-127, 128, ws, dtype=torch.int8, generator=g)
    got = int8_conv(xq.cuda(), wq.cuda(), strides, padding).cpu()
    (pt, pb), (pl, pr) = ((0, 0), (0, 0)) if padding == "VALID" else padding
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xq.double().permute(0, 3, 1, 2),
                                (pl, pr, pt, pb)),
        wq.double().permute(3, 2, 0, 1), stride=strides).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), want.round().long())
    assert np.isfinite(got.numpy()).all()
