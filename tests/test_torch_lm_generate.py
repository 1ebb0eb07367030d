"""The port's paged-KV engine (``rafiki_torch/models/lm_generate.py``)
against the reference's ``LMGenerator`` on the CPU.

Both packages load the same seeded numpy parameters at the TINY shape
(d 256, 2 layers, seq_len 256, vocab 512) through ``load_parameters``.
The JAX engine runs its flash kernel in interpret mode; the port's
prefill runs the plain version of K1 and its decode step the eager
torch function that the card captures as a CUDA graph.

Tolerances are the reference's own decode tolerance
(``tests/test_lm_generate.py``): atol 0.08, rtol 0.05 on the logits.
Greedy tokens of the two packages must agree at every step up to the
first one at which the JAX logits' top-2 gap is below 0.16, twice the
logit tolerance: past a near-tie the two may pick different tokens and
then decode different sequences.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch

from rafiki_torch.models import TorchTransformerLM
from rafiki_torch.models.lm_generate import (PREFILL_BUCKETS, PagePool,
                                             PoolExhausted, gumbel_noise,
                                             _mix32, prefix_digest)

TINY = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 2,
        "learning_rate": 1e-3, "train_steps": 20, "vocab_size": 512,
        "quick_train": False}
ENGINE = dict(page_size=4, n_pages=64, decode_batch=2, max_new_cap=16,
              prefix_cache_entries=4)
ATOL, RTOL = 0.08, 0.05
NEAR_TIE = 0.16


def _params(seed=0, d=256, L=2, V=512):
    rng = np.random.default_rng(seed)
    p = {"embed": 0.02 * rng.standard_normal((V, d)),
         "lnf": 1 + 0.1 * rng.standard_normal(d)}
    for name, shape in {"qkv": (L, d, 3 * d), "proj": (L, d, d),
                        "w1": (L, d, 4 * d), "w2": (L, 4 * d, d)}.items():
        p[f"layers/{name}"] = rng.standard_normal(shape) / np.sqrt(shape[-2])
    for name in ("ln1", "ln2"):
        p[f"layers/{name}"] = 1 + 0.1 * rng.standard_normal((L, d))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _torch_lm(params=None):
    m = TorchTransformerLM(device="cpu",
                           **TorchTransformerLM.validate_knobs(TINY))
    m.load_parameters(params if params is not None else _params())
    return m


@pytest.fixture(scope="module")
def lm():
    m = _torch_lm()
    yield m
    m.destroy()


@pytest.fixture(scope="module")
def gen(lm):
    g = lm.make_generator(**ENGINE)
    yield g
    g.close()


@pytest.fixture(scope="module")
def jax_gen():
    from rafiki_tpu.models import JaxTransformerLM

    m = JaxTransformerLM(**JaxTransformerLM.validate_knobs(TINY))
    m.load_parameters(_params())
    g = m.make_generator(**ENGINE)
    yield g
    g.close()
    m.destroy()


def _drain(gen, live):
    """Decode steps until the given seq_ids all finish; returns
    {seq_id: [tokens...]} (the admit-time token excluded)."""
    out = {}
    live = set(live)
    for _ in range(200):
        if not live:
            return out
        results, evicted = gen.step()
        assert not evicted
        for sid, tok, fin in results:
            out.setdefault(sid, []).append(tok)
            if fin is not None and sid in live:
                live.remove(sid)
    raise AssertionError("decode loop did not converge")


# ---- PagePool ---------------------------------------------------------


def _pool_roundtrip():
    pool = PagePool(8)
    assert pool.free_pages == 7  # page 0 reserved
    pages = [pool.alloc() for _ in range(7)]
    assert 0 not in pages and sorted(pages) == list(range(1, 8))
    assert pool.used_pages == 7
    for p in pages:
        pool.free(p)
    assert pool.free_pages == 7 and pool.used_pages == 0


def _pool_exhaustion():
    pool = PagePool(4)
    got = [pool.alloc() for _ in range(3)]
    with pytest.raises(PoolExhausted):
        pool.alloc()
    pool.free(got[1])
    assert pool.alloc() == got[1]  # any free page serves any request


def _pool_refcount():
    pool = PagePool(4)
    p = pool.alloc()
    pool.retain(p)
    assert pool.refcount(p) == 2
    pool.free(p)           # one holder left — page stays allocated
    assert pool.refcount(p) == 1 and pool.free_pages == 2
    pool.free(p)           # last holder — page recycled
    assert pool.refcount(p) == 0 and pool.free_pages == 3


def _pool_churn():
    """After any interleaving of allocs and frees, every free page is
    usable."""
    pool = PagePool(16)
    held = [pool.alloc() for _ in range(15)]
    for p in held[::2]:    # free every other page (worst-case holes)
        pool.free(p)
    refill = [pool.alloc() for _ in range(8)]
    assert pool.free_pages == 0 and len(set(refill)) == 8
    with pytest.raises(PoolExhausted):
        pool.alloc()


def _pool_misuse():
    pool = PagePool(4)
    with pytest.raises(ValueError):
        pool.free(3)       # never allocated
    with pytest.raises(ValueError):
        pool.retain(2)
    with pytest.raises(ValueError):
        PagePool(1)        # page 0 alone is not a pool


@pytest.mark.parametrize("case", [_pool_roundtrip, _pool_exhaustion,
                                  _pool_refcount, _pool_churn,
                                  _pool_misuse],
                         ids=lambda f: f.__name__[6:])
def test_page_pool(case):
    case()


def test_prefix_digest_is_the_references():
    from rafiki_tpu.models.lm_generate import prefix_digest as jax_digest

    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    assert prefix_digest(toks) == jax_digest(toks)
    assert prefix_digest(np.asarray(toks)) == prefix_digest(toks)
    assert prefix_digest(toks) != prefix_digest(toks[:-1])


# ---- against the reference's engine ---------------------------------


@pytest.mark.parametrize("n_prompt", [11, 33])
def test_decode_matches_the_reference_engine(gen, jax_gen, n_prompt):
    """The same prompt admitted in both engines, page-unaligned (11 ids,
    page_size 4) and past the first prefill bucket (33 ids: bucket 64,
    31 rows of padding to the scratch page). The logits agree at every
    step; the greedy tokens up to the first near-tie of the JAX logits.
    """
    prompt = np.random.default_rng(n_prompt).integers(
        0, 512, n_prompt).tolist()
    assert (next(b for b in PREFILL_BUCKETS if b >= n_prompt)
            == (32 if n_prompt <= 32 else 64))
    sid, tok = gen.admit(prompt, max_new=10, temperature=0.0)
    jsid, jtok = jax_gen.admit(prompt, max_new=10, temperature=0.0)
    tied = False
    for step in range(10):
        ref = np.asarray(jax_gen.last_logits[jsid])
        np.testing.assert_allclose(gen.last_logits[sid], ref,
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {step}")
        top2 = np.sort(ref)[-2:]
        tied = tied or top2[1] - top2[0] < NEAR_TIE
        if tok != jtok:
            assert tied, f"greedy tokens differ at step {step}"
            break
        if step == 9:
            break
        (r,), _ = gen.step()
        (jr,), _ = jax_gen.step()
        (_, tok, fin), (_, jtok, jfin) = r, jr
        assert fin == jfin
    gen.finish(sid)
    jax_gen.finish(jsid)


# ---- the reference's engine tests, on the port ----------------------


def test_decode_parity_with_full_forward(lm, gen):
    """At every step the paged-KV decode's logits match a full forward
    over the whole prefix, and the greedy chain is the full forward's
    argmax chain. Prompt length 11 is page-unaligned (page_size 4)."""
    prompt = np.random.default_rng(7).integers(0, 512, size=11).tolist()
    sid, first = gen.admit(prompt, max_new=8, temperature=0.0)

    def full_logits(toks):
        return lm._forward(torch.tensor([toks]))[0, -1].numpy()

    ref = full_logits(prompt)
    np.testing.assert_allclose(gen.last_logits[sid], ref,
                               atol=ATOL, rtol=RTOL)
    assert first == int(np.argmax(ref))
    toks = list(prompt) + [first]
    done = False
    while not done:
        before = list(toks)
        results, evicted = gen.step()
        assert not evicted
        (rsid, tok, fin), = results
        assert rsid == sid
        ref = full_logits(before)
        np.testing.assert_allclose(gen.last_logits[sid], ref,
                                   atol=ATOL, rtol=RTOL)
        assert tok == int(np.argmax(ref)), \
            f"greedy divergence at position {len(before)}"
        toks.append(tok)
        done = fin is not None
    assert len(toks) == len(prompt) + 8  # max_new honored


def test_continuous_admission_mid_decode(gen):
    """A second prompt joins while the first is mid-decode, and both
    finish with the tokens they give alone."""
    rng = np.random.default_rng(11)
    p1 = rng.integers(0, 512, size=9).tolist()
    p2 = rng.integers(0, 512, size=6).tolist()

    sid1, t1 = gen.admit(p1, max_new=6, temperature=0.0)
    solo1 = [t1] + _drain(gen, [sid1])[sid1]

    sid1, t1 = gen.admit(p1, max_new=6, temperature=0.0)
    r1, _ = gen.step()  # sid1 decodes alone for a step...
    pre = [tok for s, tok, _ in r1 if s == sid1]
    sid2, _ = gen.admit(p2, max_new=3, temperature=0.0)
    mixed = _drain(gen, [sid1, sid2])
    assert [t1] + pre + mixed[sid1] == solo1
    assert len(mixed[sid2]) + 1 == 3  # max_new incl. the admit token


def test_prefix_cache_skips_prefill(gen):
    """The same prompt twice: the second admission skips prefill,
    shares the full pages by refcount and gives the same greedy
    continuation."""
    prompt = np.random.default_rng(13).integers(0, 512, size=11).tolist()
    skipped0 = gen.prefill_skipped_total
    prefills0 = gen.prefills_total
    sid_a, ta = gen.admit(prompt, max_new=4, temperature=0.0)
    toks_a = [ta] + _drain(gen, [sid_a])[sid_a]
    assert gen.prefills_total == prefills0 + 1
    sid_b, tb = gen.admit(prompt, max_new=4, temperature=0.0)
    assert gen.prefill_skipped_total == skipped0 + 1
    assert gen.prefills_total == prefills0 + 1  # no second prefill
    seq = gen._seqs[sid_b]
    for page in seq.pages[:len(prompt) // gen.page_size]:
        assert gen.pool.refcount(page) >= 2
    # The partial tail page is a copy, with the same K/V rows.
    tail, src = seq.pages[-1], gen._prefix[prefix_digest(prompt)][0][-1]
    ps = gen.page_size
    assert tail != src
    assert torch.equal(gen._k_pool[:, tail * ps:tail * ps + 3],
                       gen._k_pool[:, src * ps:src * ps + 3])
    toks_b = [tb] + _drain(gen, [sid_b])[sid_b]
    assert toks_a == toks_b


def test_eviction_under_pool_pressure():
    """A pool too small for two growing sequences: the YOUNGEST is
    preempted with its full token trail, the older one decodes to
    completion."""
    m = _torch_lm()
    g = m.make_generator(page_size=4, n_pages=6, decode_batch=2,
                         max_new_cap=16, prefix_cache_entries=0)
    try:
        rng = np.random.default_rng(17)
        p1 = rng.integers(0, 512, size=4).tolist()
        p2 = rng.integers(0, 512, size=4).tolist()
        sid1, _ = g.admit(p1, max_new=12, temperature=0.0)
        sid2, _ = g.admit(p2, max_new=12, temperature=0.0)
        assert g.pool.free_pages == 1  # 2 pages each, 5 usable
        evicted_all = []
        for _ in range(40):
            _, evicted = g.step()
            evicted_all.extend(evicted)
            if not g._seqs:
                break
        assert evicted_all, "pool pressure never triggered preemption"
        ev = evicted_all[0]
        assert ev["seq_id"] == sid2  # youngest goes first
        assert ev["tokens"][:4] == [int(t) for t in p2]
        assert ev["n_done"] >= 1 and ev["max_new"] == 12
        assert g.evictions_total >= 1
        assert sid1 not in g._seqs  # the survivor ran to completion
    finally:
        g.close()
        m.destroy()


def test_admission_gate_reclaims_prefix_cache():
    """Live sequences outrank cached prefixes: with the pool full of
    cache-held pages, can_admit spills the cache instead of refusing."""
    m = _torch_lm()
    g = m.make_generator(page_size=4, n_pages=6, decode_batch=2,
                         max_new_cap=8, prefix_cache_entries=4)
    try:
        rng = np.random.default_rng(19)
        p1 = rng.integers(0, 512, size=6).tolist()
        sid1, _ = g.admit(p1, max_new=2, temperature=0.0)
        _drain(g, [sid1])
        assert g.pool.used_pages > 0 and not g._seqs
        p2 = rng.integers(0, 512, size=12).tolist()  # needs 4 pages
        assert g.can_admit(len(p2))  # spilled the cache to say yes
        sid2, _ = g.admit(p2, max_new=2, temperature=0.0)
        assert sid2 in g._seqs
    finally:
        g.close()
        m.destroy()


def test_generator_close_returns_all_pages():
    m = _torch_lm()
    g = m.make_generator(page_size=4, n_pages=16, decode_batch=2,
                         max_new_cap=8)
    g.admit(list(range(1, 8)), max_new=4, temperature=0.0)
    g.admit(list(range(1, 8)), max_new=4, temperature=0.0)  # prefix hit
    g.step()
    assert g.pool.used_pages > 0
    g.close()
    assert g.pool.used_pages == 0
    m.destroy()


def test_make_generator_needs_parameters():
    m = TorchTransformerLM(device="cpu",
                           **TorchTransformerLM.validate_knobs(TINY))
    with pytest.raises(RuntimeError, match="load_parameters"):
        m.make_generator(**ENGINE)


def test_pools_and_geometry(gen):
    """Two bf16 pools (L, n_pages·page_size, d) on the model's device;
    enough page slots per lane for seq_len plus the generation cap."""
    for pool in (gen._k_pool, gen._v_pool):
        assert pool.shape == (2, 64 * 4, 256)
        assert pool.dtype == torch.bfloat16 and pool.device.type == "cpu"
    assert gen.pages_per_seq == (256 + 16) // 4
    assert gen.max_tokens == gen.pages_per_seq * 4
    assert gen._graph is None  # the CPU runs the eager step


def test_first_token_is_sampled_as_the_reference_samples_it():
    from rafiki_tpu.models.lm_generate import LMGenerator as JaxGen
    from rafiki_torch.models.lm_generate import LMGenerator

    logits = np.random.default_rng(3).standard_normal(512).astype(
        np.float32)
    for temp, seed, pos in [(0.0, 0, 5), (0.8, 3, 11), (1.5, 99, 300)]:
        assert (LMGenerator._sample_host(logits, temp, seed, pos)
                == JaxGen._sample_host(logits, temp, seed, pos))


# ---- sampling -------------------------------------------------------


def test_gumbel_noise_is_a_function_of_seed_and_position():
    vm = _mix32(torch.arange(512, dtype=torch.int64))
    seeds = torch.tensor([5, 7, 5, 5, -3, 2 ** 40])
    pos = torch.tensor([10, 10, 10, 11, 10, 10])
    g = gumbel_noise(seeds, pos, vm)
    assert g.shape == (6, 512) and g.dtype == torch.float32
    assert torch.isfinite(g).all()
    assert torch.equal(g[0], g[2])          # same (seed, position)
    assert not torch.equal(g[0], g[1])      # another seed
    assert not torch.equal(g[0], g[3])      # another position
    # Alone or in another batch, the same lane gets the same draw.
    assert torch.equal(gumbel_noise(seeds[3:4], pos[3:4], vm)[0], g[3])
    # Standard Gumbel: mean ≈ Euler's γ, variance ≈ π²/6.
    big = gumbel_noise(torch.arange(64), torch.zeros(64, dtype=torch.int64),
                       _mix32(torch.arange(4096, dtype=torch.int64)))
    assert abs(float(big.mean()) - 0.5772) < 0.02
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.05


def test_sampled_tokens_are_the_same_alone_and_packed():
    """The same (seed, prompt) at temperature 0.8 gives the same tokens
    decoding alone and packed with other sequences, whatever their
    lanes."""
    m = _torch_lm()
    g = m.make_generator(page_size=4, n_pages=64, decode_batch=3,
                         max_new_cap=16, prefix_cache_entries=0)
    try:
        rng = np.random.default_rng(23)
        prompt = rng.integers(0, 512, size=10).tolist()
        sid, t = g.admit(prompt, max_new=12, temperature=0.8, seed=42)
        alone = [t] + _drain(g, [sid])[sid]
        others = [g.admit(rng.integers(0, 512, size=n).tolist(),
                          max_new=12, temperature=0.8, seed=n)[0]
                  for n in (5, 14)]
        sid, t = g.admit(prompt, max_new=12, temperature=0.8, seed=42)
        assert g._seqs[sid].lane == 2   # another lane than alone
        packed = [t] + _drain(g, [sid, *others])[sid]
        assert packed == alone
        # Sampling moved off the greedy chain somewhere.
        sid, t = g.admit(prompt, max_new=12, temperature=0.0)
        assert [t] + _drain(g, [sid])[sid] != alone
    finally:
        g.close()
        m.destroy()
