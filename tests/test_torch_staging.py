"""The port's device staging cache, the per-chunk path and the LM's
staged evaluation on the CPU.

A ``TorchModel`` trial must end bit for bit the same with the caches on
or off and on the per-chunk path or the staged one: all of them feed the
same rows to the same steps in the same order. The staged tensors are
copies, never views of the host cache's read-only arrays. The runner's
``stage_owner`` makes the cache keep a job's own entries under budget
pressure as the reference's cache does on the same sequence. The LM's
evaluation on the staged stream gathers the host path's windows and
gives its logits, bit for bit; its logits and accuracy are the
reference's within ``tests/test_torch_lm.py``'s bounds (atol 3e-2, 4 of
the 4096 scored positions).
"""

import _torch_threads  # noqa: F401  (caps torch threads under xdist)
import hashlib

import numpy as np
import pytest
import torch

from rafiki_torch.advisor import make_advisor
from rafiki_torch.constants import BudgetOption
from rafiki_torch.datasets import make_synthetic_image_dataset
from rafiki_torch.model import dataset as pds
from rafiki_torch.model import torch_model
from rafiki_torch.model.dataset import (load_image_dataset,
                                        write_token_dataset)
from rafiki_torch.models import TorchFeedForward, TorchTransformerLM
from rafiki_torch.observe import phases
from rafiki_torch.store import MetaStore, ParamStore
from rafiki_torch.worker.runner import TrialRunner
from rafiki_tpu.model import dataset as rds

KNOBS = {"hidden_layer_count": 2, "hidden_layer_units": 32,
         "learning_rate": 3e-3, "batch_size": 8, "max_epochs": 2}
ENVS = (pds.DATASET_CACHE_ENV, torch_model.STAGE_CACHE_ENV,
        torch_model.STAGE_BYTES_ENV)


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)
    pds.clear_dataset_cache()
    torch_model.clear_stage_cache()
    yield
    pds.clear_dataset_cache()
    torch_model.clear_stage_cache()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return make_synthetic_image_dataset(
        str(tmp_path_factory.mktemp("stage")), n_train=50, n_val=20,
        image_shape=(6, 6, 1), n_classes=3, seed=0)


def _trial(path, val, **knobs):
    m = TorchFeedForward(device="cpu", **dict(KNOBS, **knobs))
    m.train(path)
    score = m.evaluate(val)
    return m.dump_parameters(), score


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _counts(cache):
    c = phases.cache_counts(cache)
    return {e: c.get(e, 0) for e in ("hit", "miss", "evict")}


def _delta(after, before):
    return {e: after[e] - before[e] for e in after}


def test_caches_on_and_off_train_bit_for_bit(images, monkeypatch):
    on = _trial(*images)
    again = _trial(*images)  # both caches hit now
    monkeypatch.setenv(pds.DATASET_CACHE_ENV, "0")
    monkeypatch.setenv(torch_model.STAGE_CACHE_ENV, "0")
    off = _trial(*images)
    for other in (again, off):
        _same(on[0], other[0])
        assert on[1] == other[1]


@pytest.mark.parametrize("chunk_steps", [3, 4, 128])
def test_the_per_chunk_path_trains_bit_for_bit_the_staged(
        images, monkeypatch, chunk_steps):
    """6 steps an epoch (2 of the 50 rows left over) in chunks of 3, of
    4 and 2, or of all 6; the per-chunk trial stages nothing into the
    cache."""
    monkeypatch.setattr(torch_model, "CHUNK_STEPS", chunk_steps)
    staged = _trial(*images)
    torch_model.clear_stage_cache()
    before = _counts("stage")
    monkeypatch.setenv(torch_model.STAGE_BYTES_ENV, "1")
    chunked = _trial(*images)
    _same(staged[0], chunked[0])
    assert staged[1] == chunked[1]
    assert torch_model.stage_cache_info() == {"entries": 0, "bytes": 0}
    assert _delta(_counts("stage"), before) == {"hit": 0, "miss": 0,
                                                "evict": 0}


def test_malformed_byte_counts_read_as_their_defaults(images,
                                                      monkeypatch):
    """All three byte counts are read per call, and one that is not an
    integer reads as its default (``NodeConfig.validate`` refuses it):
    a trial still trains on the staged path and caches its set."""
    for env in ENVS:
        monkeypatch.setenv(env, "junk")
    assert pds.dataset_cache_budget() == pds.DATASET_CACHE_DEFAULT
    assert torch_model.stage_cache_budget() == \
        torch_model.STAGE_CACHE_DEFAULT
    assert torch_model.stage_bytes_limit() == \
        torch_model.STAGE_BYTES_DEFAULT
    before = _counts("stage")
    _trial(*images)
    assert _delta(_counts("stage"), before) == {"hit": 0, "miss": 2,
                                                "evict": 0}
    assert torch_model.stage_cache_info()["entries"] == 2


def _digest(ds):
    return hashlib.sha256(ds.images.tobytes() + ds.labels.tobytes()
                          ).hexdigest()


def test_a_trial_and_an_evaluation_leave_the_cached_set_unchanged(images):
    """The staged tensors are copies: on the CPU ``torch.from_numpy``
    would alias the host cache's read-only arrays, and a write to a
    staged tensor would change every later trial's data."""
    train, val = images
    ds, vs = load_image_dataset(train), load_image_dataset(val)
    digests = (_digest(ds), _digest(vs))
    m = TorchFeedForward(device="cpu", **KNOBS)
    m.train(train)
    m.evaluate(val)
    assert load_image_dataset(train) is ds
    assert (_digest(ds), _digest(vs)) == digests
    data, labels = torch_model.staged_dataset_arrays(train, ds, "cpu")
    assert data.data_ptr() != ds.images.ctypes.data
    assert labels.dtype == torch.int32
    data.add_(1)
    labels.add_(1)
    assert (_digest(ds), _digest(vs)) == digests
    assert not ds.images.flags.writeable


def test_a_runner_job_counts_two_misses_then_hits(images, tmp_path):
    """4 trials of one sub-train job: the train and val files miss once
    in each cache, then hit; the gauges hold both sets."""
    train, val = images
    d0, s0 = _counts("dataset"), _counts("stage")
    advisor = make_advisor(TorchFeedForward.get_knob_config(), seed=0,
                           advisor_type="random")
    runner = TrialRunner(TorchFeedForward, advisor, train, val,
                         MetaStore(":memory:"),
                         ParamStore(str(tmp_path / "p")), "job-a",
                         budget={BudgetOption.MODEL_TRIAL_COUNT: 4},
                         device="cpu")
    for _ in range(4):
        assert runner.run_one()["status"] == "COMPLETED"
    assert _delta(_counts("dataset"), d0) == {"hit": 6, "miss": 2,
                                              "evict": 0}
    assert _delta(_counts("stage"), s0) == {"hit": 6, "miss": 2,
                                            "evict": 0}
    ds, vs = load_image_dataset(train), load_image_dataset(val)
    gauges = phases._reg()
    assert gauges["dataset_cache_bytes"].samples()[0][1] == sum(
        x.images.nbytes + x.labels.nbytes for x in (ds, vs))
    assert gauges["stage_cache_bytes"].samples()[0][1] == sum(
        x.images.nbytes + 4 * x.size for x in (ds, vs))


def test_the_runner_s_stage_owner_keeps_a_job_s_own_entries(
        tmp_path, monkeypatch):
    """Jobs A, B, A on four sets of one size, under a budget of three
    entries: B's val evicts A's train, not its own; A's next trial
    evicts B's train and keeps A's val (plain LRU would drop A's val).
    The reference's cache, fed the same gets and puts under the same
    owners, ends with the same entries in the same order."""
    sets = {j: make_synthetic_image_dataset(
        str(tmp_path / j), n_train=40, n_val=40, image_shape=(5, 5, 1),
        n_classes=2, seed=i) for i, j in enumerate(("a", "b"))}
    entry = 40 * 25 + 4 * 40
    monkeypatch.setenv(torch_model.STAGE_CACHE_ENV, str(3 * entry))
    ops = []
    cache = torch_model._STAGE_CACHE
    real_get, real_put = cache.get, cache.put

    def get(key):
        ops.append(("get", key, pds.current_stage_owner()))
        return real_get(key)

    def put(key, value, nbytes, budget):
        ops.append(("put", key, pds.current_stage_owner(), nbytes, budget))
        real_put(key, value, nbytes, budget)

    monkeypatch.setattr(cache, "get", get)
    monkeypatch.setattr(cache, "put", put)
    advisor = make_advisor(TorchFeedForward.get_knob_config(), seed=0,
                           advisor_type="random")
    ms = MetaStore(":memory:")
    for job in ("a", "b", "a"):
        TrialRunner(TorchFeedForward, advisor, *sets[job], ms,
                    ParamStore(str(tmp_path / "p")), f"job-{job}",
                    device="cpu").run_one()
    names = {torch_model._stage_key(p, load_image_dataset(p),
                                    torch.device("cpu"), 0, 1): f"{j}-{s}"
             for j, pair in sets.items() for s, p in zip(("t", "v"), pair)}
    assert [names[k] for k in cache._entries] == ["b-v", "a-t", "a-v"]
    ref = rds.ByteBudgetLRU("stage")
    for op in ops:
        with rds.stage_owner(op[2]):
            if op[0] == "get":
                ref.get(op[1])
            else:
                ref.put(op[1], None, op[3], op[4])
    assert list(ref._entries) == list(cache._entries)
    assert [e[2] for e in ref._entries.values()] == \
        [e[2] for e in cache._entries.values()] == ["job-b", "job-a",
                                                     "job-a"]


TINY = {"d_model": 256, "n_layers": 2, "seq_len": 256, "batch_size": 4,
        "learning_rate": 1e-2, "train_steps": 200, "vocab_size": 512,
        "quick_train": False}


def _lm_params(seed=0, d=256, L=2, V=512):
    rng = np.random.default_rng(seed)
    p = {"embed": 0.02 * rng.standard_normal((V, d)),
         "lnf": 1 + 0.1 * rng.standard_normal(d)}
    for name, shape in {"qkv": (L, d, 3 * d), "proj": (L, d, d),
                        "w1": (L, d, 4 * d), "w2": (L, 4 * d, d)}.items():
        p[f"layers/{name}"] = rng.standard_normal(shape) / np.sqrt(shape[-2])
    for name in ("ln1", "ln2"):
        p[f"layers/{name}"] = 1 + 0.1 * rng.standard_normal((L, d))
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_the_lm_s_staged_evaluation_is_the_host_path_s(tmp_path,
                                                       monkeypatch):
    """16 windows of 256 from a stream of 5,000 ids: twice on the staged
    stream (a stage miss, then a hit) and once with the cache off (the
    host path). Each evaluation's windows are the stream's cut here,
    ids and targets bit for bit, its logits bit for bit the others' and
    within ``tests/test_torch_lm.py``'s atol of the reference's on the
    same windows, and the accuracies equal, and the reference's within
    4/4096. (Random weights on random ids score near 1/512, so the
    accuracy alone would not see a wrong gather: the windows do.)"""
    import jax.numpy as jnp

    from rafiki_tpu.models import JaxTransformerLM

    p = _lm_params()
    tm = TorchTransformerLM(device="cpu",
                            **TorchTransformerLM.validate_knobs(TINY))
    tm.load_parameters(p)
    ids = np.random.default_rng(3).integers(0, 512, 5000)
    want = np.stack([ids[i * 256:i * 256 + 257] for i in range(16)])
    path = write_token_dataset(ids, 512, str(tmp_path / "val"))
    seen = []
    windows, forward = tm._eval_windows, tm._forward

    def record_windows(dataset_path):
        seen.append([windows(dataset_path)])
        return seen[-1][0]

    def record_forward(x):
        seen[-1].append(forward(x))
        return seen[-1][1]

    monkeypatch.setattr(tm, "_eval_windows", record_windows)
    monkeypatch.setattr(tm, "_forward", record_forward)
    s0 = _counts("stage")
    first = tm.evaluate(path)
    assert _delta(_counts("stage"), s0) == {"hit": 0, "miss": 1,
                                            "evict": 0}
    second = tm.evaluate(path)
    assert _delta(_counts("stage"), s0) == {"hit": 1, "miss": 1,
                                            "evict": 0}
    assert torch_model.stage_cache_info() == {"entries": 1,
                                              "bytes": 4 * 5000}
    monkeypatch.setenv(torch_model.STAGE_CACHE_ENV, "0")
    host = tm.evaluate(path)
    assert _delta(_counts("stage"), s0)["miss"] == 1
    assert first == second == host
    for wins, logits in seen:
        assert wins.dtype == torch.int64
        assert np.array_equal(wins.numpy(), want)
        assert torch.equal(logits, seen[0][1])
    jm = JaxTransformerLM(**JaxTransformerLM.validate_knobs(TINY))
    jm.load_parameters(p)
    ref = np.asarray(jm._forward(jm._params,
                                 jnp.asarray(want[:, :-1], jnp.int32)))
    np.testing.assert_allclose(seen[0][1].numpy(), ref, atol=3e-2, rtol=0)
    assert abs(first - jm.evaluate(path)) <= 4 / 4096
    jm.destroy()


def test_a_stream_too_short_for_its_windows_takes_the_host_path(tmp_path):
    """Fewer ids than 16 windows need: fewer windows, cut on the host,
    and nothing staged."""
    p = _lm_params()
    tm = TorchTransformerLM(device="cpu",
                            **TorchTransformerLM.validate_knobs(TINY))
    tm.load_parameters(p)
    ids = np.random.default_rng(4).integers(0, 512, 700)
    path = write_token_dataset(ids, 512, str(tmp_path / "short"))
    acc = tm.evaluate(path)
    assert 0.0 <= acc <= 1.0
    assert torch_model.stage_cache_info()["entries"] == 1  # 2 windows fit
    torch_model.clear_stage_cache()
    ids = np.random.default_rng(4).integers(0, 512, 200)  # under one window
    path = write_token_dataset(ids, 512, str(tmp_path / "shorter"))
    tm.evaluate(path)
    assert torch_model.stage_cache_info()["entries"] == 0
