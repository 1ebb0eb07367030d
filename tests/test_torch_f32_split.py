"""The arithmetic of K1's f32 variant, emulated in plain torch on the CPU.

K1's f32 variant (``rafiki_torch/ops/csrc/flash_fwd.cu``) multiplies on
TF32 tensor cores (``mma.sync`` m16n8k8). A TF32 operand keeps 10 of
f32's 23 mantissa bits, about 5e-4 relative, so one pass would leave the
f32 tolerance that the kernel is held to on the card, (1e-5, 1e-5) on
``o`` (``TOL_O["float32"]`` in ``chip_smoke.py``) and (1e-4, 1e-6) on
``lse``, far behind. The kernel splits each operand x into
big = tf32(x) and small = x - big, rounded to TF32 as well for q and k
and read with its low 13 bits dropped for p and v, and takes three
products, small·big', big·small', then big·big'; small·small' (2^-22
relative) is dropped. For the scores the three go into a fresh
accumulator at each 8-deep step, added to the running scores in f32;
for p·v they go straight into the running sums. The last test shows
that one pass misses.

``emulate`` repeats that arithmetic here: ``cvt.rna.tf32.f32`` as
``(bits + 0x1000) & ~0x1FFF`` on the int32 pattern (the kernel rounds
the bit pattern so), the dropped bits, the three products of each step,
f32 sums, and the kernel's own tiling: warps of 16 query
rows (80 rows for 65), head dims padded to 32, 64 or 128, 64-key tiles
with the last trimmed to a multiple of 8 (72 keys for 65), each 8-key
chunk's keys taken as the kernel takes them (2t, then 2t + 1), each
warp walking the kv tiles of its 64-row group. It is held against
``flash_attention_reference``, the plain version, on inputs from a
seeded numpy generator. The kernel itself runs only on the card, where
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` hold it
against the same plain version.
"""

import math

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch

from rafiki_torch.ops import attention as attn

TOL_O = (1e-5, 1e-5)
TOL_LSE = (1e-4, 1e-6)
NEG_INF = attn.NEG_INF
# The order in which the kernel's k index visits 8 head dims or 8 keys:
# k = t is element 2t, k = t + 4 is element 2t + 1.
ORDER = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32(x):
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def dropped(x):
    """What the tensor cores read of an f32 operand: its low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def add_product(acc, a, b, passes, small):
    """``acc`` plus one 8-deep step ``a @ b`` as the kernel adds it: the
    three TF32 products of the split operands, small·big', big·small',
    big·big', each added in f32, ``small`` (``tf32`` or ``dropped``)
    taking the small parts to TF32; or, with ``passes`` 1, the one
    product of the operands rounded to TF32."""
    if passes == 1:
        return acc + tf32(a) @ tf32(b)
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    acc = acc + a_small @ b_big
    acc = acc + a_big @ b_small
    return acc + a_big @ b_big


def kv_tiles(q0, tq, tkv, causal):
    """``kv_tiles`` of ``flash_common.cuh``: the 64-key tiles that the
    64-row group from ``q0`` walks."""
    n = -(-tkv // 64)
    if causal:
        last = min(q0 + 63, tq - 1) + tkv - tq
        n = 0 if last < 0 else min(n, last // 64 + 1)
    return n


def emulate(q, k, v, causal=False, kv_mask=None, passes=3):
    """(o, lse) of K1's f32 variant, in its arithmetic and its tiling."""
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    rows = -(-tq // 16) * 16
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    qp = torch.zeros(b, h, rows, dp)
    qp[:, :, :tq, :d] = q
    keys = -(-tkv // 8) * 8
    kp, vp = torch.zeros(b, h, keys, dp), torch.zeros(b, h, keys, dp)
    kp[:, :, :tkv, :d], vp[:, :, :tkv, :d] = k, v
    bias = None
    if kv_mask is not None:
        bias = torch.zeros(b, keys)
        bias[:, :tkv] = torch.where(kv_mask, 0.0, NEG_INF)
    row = torch.arange(rows)
    # The kv tiles each row's warp walks: those of its 64-row group.
    walks = torch.tensor([kv_tiles(r // 64 * 64, tq, tkv, causal)
                          for r in range(rows)])
    m = torch.full((b, h, rows), NEG_INF)
    lanes = torch.zeros(b, h, rows, 4)  # each lane's share of l
    acc = torch.zeros(b, h, rows, dp)
    for j in range(int(walks.max())):
        kv0 = j * 64
        n = min(64, -(-(tkv - kv0) // 8) * 8)
        kt, vt = kp[:, :, kv0:kv0 + n], vp[:, :, kv0:kv0 + n]
        s = torch.zeros(b, h, rows, n)
        for kk in range(dp // 8):
            cols = 8 * kk + ORDER
            s = s + add_product(torch.zeros_like(s), qp[..., cols],
                                kt[..., cols].transpose(-1, -2), passes,
                                tf32)
        x = s * scale
        col = kv0 + torch.arange(n)
        if causal:
            hidden = row[:, None] + (tkv - tq) < col[None, :]
            x = torch.where(hidden, torch.tensor(NEG_INF), x)
        if bias is not None:
            x = x + bias[:, None, None, kv0:kv0 + n]
        x = torch.where(col >= tkv, torch.tensor(2 * NEG_INF), x)
        mx = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(x - mx[..., None])
        # Lane t holds keys 8c + 2t and 8c + 2t + 1 of every chunk c.
        share = p.view(b, h, rows, n // 8, 4, 2).sum((-3, -1))
        new_acc = acc * alpha[..., None]
        for c in range(n // 8):
            ks = 8 * c + ORDER
            new_acc = add_product(new_acc, p[..., ks], vt[:, :, ks], passes,
                                  dropped)
        walk = (j < walks)[:, None]
        m = torch.where(walk[:, 0], mx, m)
        lanes = torch.where(walk, lanes * alpha[..., None] + share, lanes)
        acc = torch.where(walk, new_acc, acc)
    l = torch.clamp((lanes[..., 0] + lanes[..., 1])
                    + (lanes[..., 2] + lanes[..., 3]), min=1e-30)
    o = acc[:, :, :tq, :d] / l[:, :, :tq, None]
    return o, (m + torch.log(l))[:, :, :tq]


def _inputs(seed, shape, lengths=None):
    b, h, tq, tkv, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                .astype(np.float32))
               for t in (tq, tkv, tkv))
    mask = None
    if lengths is not None:
        mask = torch.arange(tkv)[None, :] < torch.tensor(lengths)[:, None]
    return q, k, v, mask


def _within(x, ref, tol):
    return bool(((x - ref).abs() <= tol[0] + tol[1] * ref.abs()).all())


# The int8 ViT shape (in batch); chip_smoke.py's two f32 kernel cases
# ("f32 causal", "f32 kv_mask" with an example fully padded), the first
# cut in batch; Tq > Tkv under causal (rows before the first key).
CASES = {
    "vit": ((4, 4, 65, 65, 32), False, None),
    "f32 causal": ((1, 4, 500, 500, 128), True, None),
    "f32 kv_mask": ((3, 2, 257, 300, 48), False, [300, 100, 0]),
    "tq > tkv causal": ((2, 2, 200, 77, 36), True, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_tf32_passes_hold_the_f32_tolerance(name):
    shape, causal, lengths = CASES[name]
    q, k, v, mask = _inputs(13, shape, lengths)
    o, lse = emulate(q, k, v, causal, mask)
    ro, rl = attn.flash_attention_reference(q, k, v, causal=causal,
                                            kv_mask=mask, return_lse=True)
    assert bool(torch.isfinite(o).all())
    assert _within(o, ro, TOL_O)
    assert _within(lse, rl, TOL_LSE)


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why three passes: one TF32 product of the scores and one of p·v
    leave o tens of times outside (1e-5, 1e-5) (about 56 times on these
    inputs, where three passes use about a twentieth of it)."""
    q, k, v, _ = _inputs(13, (4, 4, 65, 65, 32))
    ro = attn.flash_attention_reference(q, k, v)
    bound = TOL_O[0] + TOL_O[1] * ro.abs()
    o3, _ = emulate(q, k, v)
    o1, _ = emulate(q, k, v, passes=1)
    assert float(((o3 - ro).abs() / bound).max()) < 0.2
    assert float(((o1 - ro).abs() / bound).max()) > 20
