"""The generative engine on the card: the captured decode graph against
the eager decode step, and K1 at the prefill buckets' edge shapes.

These tests need a CUDA device and skip without one. On a machine with a
card and without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_generate_cuda.py

Tolerances: K1 against its plain version as in
``tests/test_torch_kernels_cuda.py`` (bf16 (1e-3, 1.6e-2), lse (1e-4,
1e-6)). The graph replays the kernels the eager step launches on the
same inputs, so its tokens and logits must be the same bits.
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import numpy as np
import pytest
import torch

from rafiki_torch.models import TorchTransformerLM
from rafiki_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

KNOBS = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 2,
         "learning_rate": 1e-3, "train_steps": 20, "vocab_size": 512,
         "quick_train": False}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


@pytest.fixture
def engine(card):
    m = TorchTransformerLM(device=card,
                           **TorchTransformerLM.validate_knobs(KNOBS))
    m.load_parameters(_params())
    g = m.make_generator(page_size=16, n_pages=64, decode_batch=4,
                         max_new_cap=32, prefix_cache_entries=4)
    yield g
    g.close()
    m.destroy()


def test_decode_graph_matches_the_eager_step(engine):
    assert engine._graph is not None    # captured at construction
    rng = np.random.default_rng(5)
    for n, temp in ((9, 0.0), (40, 0.8), (17, 0.0)):
        engine.admit(rng.integers(0, 512, n).tolist(), max_new=20,
                     temperature=temp, seed=n)
    for _ in range(3):
        engine._stage_inputs()
        eager_ids, eager_logits = engine._decode(*engine._decode_args())
        graph_ids, graph_logits = engine._run_decode()
        torch.cuda.synchronize()
        assert torch.equal(graph_ids, eager_ids)
        assert torch.equal(graph_logits, eager_logits)
        engine.step()


def test_prefill_launches_k1_per_layer_and_decode_none(engine):
    prompt = list(range(1, 30))
    k1 = attn.flash_attention
    n0, w0 = k1.launches, k1.variant_launches["wgmma"]
    sid, _ = engine.admit(prompt, max_new=4)
    assert k1.launches - n0 == 2 and k1.variant_launches["wgmma"] - w0 == 2
    engine.step()
    engine.admit(prompt, max_new=4)        # a prefix hit
    assert k1.launches - n0 == 2
    engine.step()
    assert k1.launches - n0 == 2


@pytest.mark.parametrize("t", [32, 4096])
def test_k1_at_the_edge_buckets_takes_wgmma(card, t):
    gen = torch.Generator(device=card).manual_seed(t)
    q, k, v = (torch.randn(1, 16, t, 128, device=card, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    assert attn.flash_forward_variant(q, k, v) == "wgmma"
    w0 = attn.flash_attention.variant_launches["wgmma"]
    o, lse = attn.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert attn.flash_attention.variant_launches["wgmma"] == w0 + 1
    ro, rl = attn.flash_attention_reference(q, k, v, causal=True,
                                            return_lse=True)
    assert bool(((o.float() - ro.float()).abs()
                 <= 1e-3 + 1.6e-2 * ro.float().abs()).all())
    assert bool(((lse - rl).abs() <= 1e-4 + 1e-6 * rl.abs()).all())


def test_out_of_vocabulary_query_leaves_the_worker_serving(card):
    """F1 on the card: a scored query with an id past the vocabulary
    answers nan without a launch, and the same worker then still scores
    a query as before and still generates."""
    from rafiki_torch.worker import InferenceWorker

    gen = {"page_size": 16, "n_pages": 64, "decode_batch": 4,
           "max_new_cap": 32, "prefix_cache_entries": 4}
    worker = InferenceWorker(TorchTransformerLM, KNOBS, _params(),
                             device=card, generate=gen).start()
    try:
        good = list(range(1, 40))
        before = worker.predict([good], timeout=120)[0]
        bad = worker.predict([[1, 2, 600], [600, 1, 2], [1, -513, 3]],
                             timeout=120)
        torch.cuda.synchronize()
        assert np.isnan(bad[0]) and np.isnan(bad[2])
        assert np.isfinite(bad[1])
        assert worker.predict([good], timeout=120)[0] == before
        qid = worker.generate(good, max_new=8)
        frames = []
        while not (frames and frames[-1].get("done")):
            got = worker.frames.pop_token_frames(qid, timeout=60)
            assert got, "no token frame within 60 s"
            frames.extend(got)
        assert frames[-1]["finish"] == "length"
        assert sum(len(f["tok"]) for f in frames) == 8
    finally:
        worker.stop()
